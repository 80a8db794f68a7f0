// Fused exact-scan "survivors" kernel for Hopper (sm_90a): bf16 and int8
// modes, plus the ordered merge of its split walks.
//
// Replaces the Pallas TPU kernel qdrant_tpu/ops/pallas_scan.py::_scan_kernel
// (launched by pallas_scan_survivors, pl.pallas_call at pallas_scan.py:143)
// in both of its modes. It computes the same thing:
//
//   * scores s[r, x] = Q[r] . V[x] plus bias[x]:
//       bf16 mode: bf16 operands, products accumulated in f32
//       (bias = -||v||^2 with V pre-scaled by 2 for euclid, 0 for
//       dot/cosine);
//       int8 mode (scalar-quantized codes): int8 operands, products
//       accumulated exactly in int32, then f32(acc) * scale_sq + bias, each
//       step rounded on its own (scale_sq = scale^2, x2 for euclid) - the
//       JAX kernel's `.astype(f32) * scale` then `+ bias`;
//     NEG_INF = finfo(f32).min in the bias marks deleted or filtered rows;
//   * for each query row r, survivor slot s and lane l, the maximum over all
//     rows x = nb*blk + j*128 + l with nb = s (mod slots), ties to the
//     earliest row (strict '>' in ascending (nb, j) order) - exactly the
//     TPU kernel's per-block lane-group argmax followed by its slot-ring merge;
//   * outputs [B, slots*128] f32 scores and int32 row ids (-1 = none).
//
// Bound on this card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16, 1,979 TOP/s
// int8). At the REST path's launches the kernel must read V once: 8 x
// 1,003,520 x 128 bf16 is 261 MB = 78 us, 8 x 1,003,520 x 1536 int8 is 1.55
// GB = 461 us, and the products are 2-25 G operations, a few microseconds.
// At B = 256 the same bytes bound it (79 us, 463 us), with the int8 products
// (0.40 ms) close behind. So the design is about keeping HBM busy. Measured
// on an H100 (PERF.md): at B = 8 the kernel streams V at 2.7-3.0 TB/s, 1.1-
// 1.3x the bound. At B = 256 each of the 4 query tiles streams V through its
// own SMs again, and one SM takes in boxes at ~30 GB/s whatever the ring
// depth, so it runs at 3-4.5x the bound: sharing a box between the query
// tiles' CTAs (TMA multicast in a cluster) is the next step there.
//
// Design, against the four things that held the first version (16 CTAs on
// 132 SMs at 6% of the bound) back:
//
//  1. Too few CTAs at small batches. Each slot's walk over its (block,
//     128-row group) tiles is cut into `chunks` contiguous ranges, chosen in
//     Python (fused_scan.scan_split) so that slots x chunks x query tiles
//     fill every SM at the REST shapes. The grid is (query tile, slot x
//     chunk), query tile fastest, so the CTAs that read the same V tiles run
//     side by side. Each chunk writes its partial
//     winners to a scratch [chunks, B, slots*128]; merge_survivors_kernel
//     then keeps, per element, the first chunk's winner that no later chunk
//     beats (strict '>' in chunk order, which is ascending row order within
//     a slot and lane): the unsplit walk's answer, ties included. A second
//     small kernel rather than a cluster reduction, so the chunk count is
//     free of cluster-size limits; it reads ~1-4 MB mostly from L2. With one
//     chunk the scan writes the output directly and no merge runs.
//  2. Too few bytes in flight. One producer warp keeps a ring of STAGES
//     16 KB TMA boxes (128 rows x 128 bytes of V, 128-byte swizzle) in
//     flight, each guarded by a full/empty mbarrier pair: 64 KB per CTA,
//     two or three CTAs per SM at small batches. A tile's last box
//     brings its 128 bias values along (a bulk copy on the same barrier):
//     a global load in the consumers stalled every tile, because the
//     wgmma.fence before the next products waits for it. No thread spends
//     registers or instructions on the copies, and no __syncthreads runs in
//     the walk.
//  3. Q reloaded at every stage. The CTA's query tile (N rows x the whole
//     row width, zero rows past B) is loaded once into shared memory, in the
//     same swizzled K-major layout the TMA gives V, and stays there. Rows
//     too wide for that (fused_scan.queries_resident: 8 rows past 96 KB,
//     D > 6,144 bf16 or 12,288 int8) stream instead: each stage's TMA brings
//     the query tile's matching 128-byte column block beside V's box, so
//     any D up to Qdrant's 65,536 fits in shared memory.
//  4. mma.sync from shuffled fragments. The product is wgmma "swap AB": V's
//     128-row group is M (two m64 halves, one per consumer warpgroup, read
//     from the TMA boxes), the query tile is N (8, 32 or 64), K steps 32
//     bytes (k16 bf16 / k32 int8). A batch of 8 wastes no tensor-core rows.
//     The running best score and id live in registers in the accumulator's
//     layout; best + id triple the accumulator's registers, which is what
//     caps N at 64.
//
// The epilogue keeps the roundings of the plain version: bf16 acc + bias;
// int8 __fadd_rn(__fmul_rn(__int2float_rn(acc), scale_sq), bias), which nvcc
// cannot contract into an FMA, so the int8 mode is bit-exact.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is
                   // looked up at run time, so the library needs no -lcuda
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;                   // row groups are 128 rows wide
constexpr int KBYTES = 128;                  // bytes of each row per stage
constexpr int STAGE_BYTES = LANES * KBYTES;  // one 16 KB TMA box
constexpr int STAGES = 4;                    // boxes in flight per CTA
constexpr int CONSUMERS = 256;               // two warpgroups, 64 lanes each
constexpr int THREADS = CONSUMERS + 32;      // + one producer warp
constexpr float NEG_INF = -3.402823466e+38f;  // finfo(float32).min

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait that lasts
// ~10 s of clock traps: a fault in the ring fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, 16-byte aligned) into shared
// memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// one 2-D TMA box (x = byte column, y = row) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// wgmma operand descriptor: K-major, 128-byte swizzle, 8-row atoms of 1024
// bytes (stride byte offset 1024; the leading offset is unused for swizzled
// K-major operands). Advancing K by 32 bytes inside the 128-byte span adds
// 32 to the start address, as the swizzle is applied to address bits.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// keep the compiler from moving accumulator reads across wgmma's async writes
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// D[64 x N] (+)= A[64 x 32 bytes] . B[N x 32 bytes]^T, both K-major in
// shared memory; acc = 0 overwrites D. Acc = float: bf16 operands; Acc =
// int: int8 operands.
template <typename Acc, int N>
__device__ __forceinline__ void wgmma(Acc* d, uint64_t da, uint64_t db,
                                      int acc);

template <>
__device__ __forceinline__ void wgmma<float, 8>(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<int, 8>(int* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<float, 32>(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<int, 32>(int* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<float, 64>(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<int, 64>(int* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// score of one accumulator element
__device__ __forceinline__ float epilogue(float acc, float, float bias) {
  return acc + bias;
}
__device__ __forceinline__ float epilogue(int acc, float scale_sq,
                                          float bias) {
  // separate roundings: no contraction into an FMA
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale_sq), bias);
}

// Shared memory: 1 KB of alignment slack, STAGES V boxes, the query tile
// (resident: kblocks x N rows x 128 bytes; streamed: one N x 128-byte block
// per stage), STAGES bias rows of 128 f32 and 2 x STAGES mbarriers.
inline int smem_bytes(int n_q, int row_bytes, bool stream_q) {
  const int q_blocks = stream_q ? STAGES : row_bytes / KBYTES;
  return 1024 + STAGES * (STAGE_BYTES + LANES * 4 + 16) + q_blocks * n_q * KBYTES;
}

// Grid (query tile, slot * chunks + chunk). q [b, row_bytes] and V (through
// `vmap`, [n, row_bytes] bytes) as bytes; with stream_q the queries come
// through `qmap` ([b, row_bytes] bytes, N x 128-byte boxes) instead of `q`.
// out_s / out_i [chunks, b, slots*128] (the output itself when chunks == 1).
template <typename Acc, int N>
__global__ void __launch_bounds__(THREADS, N <= 32 ? 2 : 1)
fused_scan_kernel(__grid_constant__ const CUtensorMap vmap,
                  __grid_constant__ const CUtensorMap qmap,
                  const uint8_t* __restrict__ q,
                  const float* __restrict__ bias, float scale_sq,
                  float* __restrict__ out_s, int* __restrict__ out_i, int b,
                  int n, int row_bytes, int blk, int slots, int chunks,
                  int stream_q) {
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle and the descriptors work on 1024-byte atoms
  uint8_t* vs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int kblocks = row_bytes / KBYTES;
  uint8_t* qs = vs + STAGES * STAGE_BYTES;
  float* bs = reinterpret_cast<float*>(qs + (stream_q ? STAGES : kblocks) * N * KBYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + STAGES * LANES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * N;
  const int slot = blockIdx.y / chunks;
  const int chunk = blockIdx.y % chunks;

  // this CTA's tiles: [lo, hi) of the slot's walk, tile t = block nb = slot
  // + (t / groups) * slots, 128-row group t % groups (fused_scan.chunk_bounds)
  const int groups = blk / LANES;
  const int nblocks = n / blk;
  const int my_blocks =
      nblocks > slot ? (nblocks - slot + slots - 1) / slots : 0;
  const long long tiles = static_cast<long long>(my_blocks) * groups;
  const int lo = static_cast<int>(tiles * chunk / chunks);
  const int hi = static_cast<int>(tiles * (chunk + 1) / chunks);
  const int steps = (hi - lo) * kblocks;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the resident query tile, once: 16-byte chunk c of row r's 128-byte block
  // kb goes to kb * N * 128 + r * 128 + (c ^ (r % 8)) * 16, TMA's swizzle;
  // rows past b are zero (as TMA fills them when the queries stream)
  const int row16 = stream_q ? 0 : row_bytes / 16;
  for (int idx = tid; idx < N * row16; idx += THREADS) {
    const int r = idx / row16, c16 = idx % row16;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < b)
      val = *reinterpret_cast<const uint4*>(
          q + static_cast<long long>(q0 + r) * row_bytes + c16 * 16);
    *reinterpret_cast<uint4*>(qs + (c16 >> 3) * N * KBYTES + r * KBYTES +
                              (((c16 & 7) ^ (r & 7)) << 4)) = val;
  }
  // generic-proxy stores become visible to wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // producer warp: one lane issues the ring
    if ((tid & 31) == 0) {
      for (int it = 0; it < steps; ++it) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        const int t = lo + it / kblocks;
        const int kb = it % kblocks;
        const int row0 = (slot + (t / groups) * slots) * blk + (t % groups) * LANES;
        // the tile's last box carries its 128 bias values, so the consumers
        // read them from shared memory and never wait on a global load
        const bool last = kb == kblocks - 1;
        mbar_expect_tx(&full[s], STAGE_BYTES + (last ? LANES * 4 : 0) +
                                     (stream_q ? N * KBYTES : 0));
        tma_load(vs + s * STAGE_BYTES, &vmap, &full[s], kb * KBYTES, row0);
        if (stream_q)  // rows past b arrive as zeros
          tma_load(qs + s * N * KBYTES, &qmap, &full[s], kb * KBYTES, q0);
        if (last) bulk_load(bs + s * LANES, bias + row0, LANES * 4, &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg scores lanes [64 wg, 64 wg + 64) of each group
  constexpr int R = N / 2;  // accumulator registers per thread
  const int wg = warp >> 2;
  const int lane = tid & 31;
  const int l0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // and l0 + 8
  const uint32_t va = smem_u32(vs) + wg * 64 * KBYTES;
  const uint32_t qa = smem_u32(qs);
  Acc acc[R];
  float best[R];
  int bid[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    acc[i] = Acc(0);
    best[i] = NEG_INF;
    bid[i] = -1;
  }
  for (int it = 0; it < steps; ++it) {
    const int s = it % STAGES;
    const int kb = it % kblocks;
    const int t = lo + it / kblocks;
    const long long row0 =
        static_cast<long long>(slot + (t / groups) * slots) * blk +
        (t % groups) * LANES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    __syncwarp();
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < R; ++i) reg_fence(acc[i]);
#pragma unroll
    for (int kk = 0; kk < KBYTES / 32; ++kk)
      wgmma<Acc, N>(acc, sw128_desc(va + s * STAGE_BYTES + kk * 32),
                    sw128_desc(qa + (stream_q ? s : kb) * N * KBYTES + kk * 32),
                    (kb | kk) != 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < R; ++i) reg_fence(acc[i]);
    float b0 = 0.f, b1 = 0.f;
    if (kb == kblocks - 1) {  // the tile's bias came with its last box
      b0 = bs[s * LANES + l0];
      b1 = bs[s * LANES + l0 + 8];
    }
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with box s
    __syncwarp();
    if (kb == kblocks - 1) {
      // tile done: fold its scores into the running winners. Element i is
      // lane l0 + 8 * ((i >> 1) & 1), query q0 + (i >> 2) * 8 + 2 * (lane &
      // 3) + (i & 1)
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int hi8 = i & 2;
        const float sc = epilogue(acc[i], scale_sq, hi8 ? b1 : b0);
        if (sc > best[i]) {
          best[i] = sc;
          bid[i] = static_cast<int>(row0 + l0 + hi8 * 4);
        }
      }
    }
  }

  const long long width = static_cast<long long>(slots) * LANES;
  float* os = out_s + static_cast<long long>(chunk) * b * width;
  int* oi = out_i + static_cast<long long>(chunk) * b * width;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
    if (row < b) {
      const long long o = row * width + slot * LANES + l0 + (i & 2) * 4;
      os[o] = best[i];
      oi[o] = bid[i];
    }
  }
}

// out[e] = the first chunk's part[c, e] that no later chunk beats (strict
// '>' in chunk order); e runs over count = b * slots * 128 elements
__global__ void __launch_bounds__(256)
merge_survivors_kernel(const float* __restrict__ part_s,
                       const int* __restrict__ part_i, float* __restrict__ out_s,
                       int* __restrict__ out_i, int chunks, long long count) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float best = part_s[e];
  int id = part_i[e];
#pragma unroll 4
  for (int c = 1; c < chunks; ++c) {
    const float s = part_s[c * count + e];
    if (s > best) {
      best = s;
      id = part_i[c * count + e];
    }
  }
  out_s[e] = best;
  out_i[e] = id;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

constexpr int ERR_TENSOR_MAP = -1;  // cuTensorMapEncodeTiled missing or failed

// A [rows, row_bytes] as a 2-D byte tensor read in box_rows x 128-byte boxes
int encode_rows(CUtensorMap* map, const void* a, int rows, int row_bytes,
                int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess || !fn)
      return ERR_TENSOR_MAP;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(row_bytes),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {KBYTES, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                      const_cast<void*>(a), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

template <typename Acc, int N>
int launch_n(const void* q, const void* v, const float* bias, float scale_sq,
             float* out_s, int* out_i, int b, int n, int row_bytes, int blk,
             int slots, int chunks, int stream_q, cudaStream_t stream) {
  CUtensorMap vmap, qmap = {};
  int err = encode_rows(&vmap, v, n, row_bytes, LANES);
  if (err == 0 && stream_q) err = encode_rows(&qmap, q, b, row_bytes, N);
  if (err != 0) return err;
  const int smem = smem_bytes(N, row_bytes, stream_q);
  cudaError_t e = cudaFuncSetAttribute(
      fused_scan_kernel<Acc, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((b + N - 1) / N, slots * chunks);
  fused_scan_kernel<Acc, N><<<grid, THREADS, smem, stream>>>(
      vmap, qmap, static_cast<const uint8_t*>(q), bias, scale_sq, out_s, out_i,
      b, n, row_bytes, blk, slots, chunks, stream_q);
  return static_cast<int>(cudaGetLastError());
}

template <typename Acc>
int launch(const void* q, const void* v, const float* bias, float scale_sq,
           float* out_s, int* out_i, int b, int n, int row_bytes, int blk,
           int slots, int n_q, int chunks, int stream_q, void* stream) {
  if (b <= 0 || slots <= 0) return static_cast<int>(cudaSuccess);
  if (row_bytes % KBYTES || blk % LANES || chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_q) {
    case 8:
      return launch_n<Acc, 8>(q, v, bias, scale_sq, out_s, out_i, b, n,
                              row_bytes, blk, slots, chunks, stream_q, st);
    case 32:
      return launch_n<Acc, 32>(q, v, bias, scale_sq, out_s, out_i, b, n,
                               row_bytes, blk, slots, chunks, stream_q, st);
    case 64:
      return launch_n<Acc, 64>(q, v, bias, scale_sq, out_s, out_i, b, n,
                               row_bytes, blk, slots, chunks, stream_q, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename Acc, int N>
int occupancy_n(int row_bytes, int stream_q) {
  const int smem = smem_bytes(N, row_bytes, stream_q);
  cudaError_t e = cudaFuncSetAttribute(
      fused_scan_kernel<Acc, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  int ctas = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, fused_scan_kernel<Acc, N>, THREADS, smem);
  return e == cudaSuccess ? ctas : -static_cast<int>(e);
}

template <typename Acc>
int occupancy(int n_q, int row_bytes, int stream_q) {
  switch (n_q) {
    case 8: return occupancy_n<Acc, 8>(row_bytes, stream_q);
    case 32: return occupancy_n<Acc, 32>(row_bytes, stream_q);
    case 64: return occupancy_n<Acc, 64>(row_bytes, stream_q);
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Shapes: q [b, d], v [n, d],
// bias [n] f32, out_s / out_i [chunks, b, slots*128] (just [b, slots*128]
// when chunks == 1). d bytes per row must be a multiple of 128, blk of 128,
// n of blk; q / v / bias 16-byte aligned; n_q (query rows per CTA) is 8, 32
// or 64; stream_q != 0 streams the queries through the load ring instead of
// keeping the tile resident (wide rows).
// Each launches on `stream` and returns cudaGetLastError() (0 = launched;
// -1 = the TMA descriptor could not be made).
extern "C" int fused_scan_survivors_bf16(const void* q, const void* v,
                                         const float* bias, float* out_s,
                                         int* out_i, int b, int n, int d,
                                         int blk, int slots, int n_q,
                                         int chunks, int stream_q,
                                         void* stream) {
  return launch<float>(q, v, bias, 1.0f, out_s, out_i, b, n, d * 2, blk,
                       slots, n_q, chunks, stream_q, stream);
}

extern "C" int fused_scan_survivors_int8(const void* q, const void* v,
                                         const float* bias, float scale_sq,
                                         float* out_s, int* out_i, int b,
                                         int n, int d, int blk, int slots,
                                         int n_q, int chunks, int stream_q,
                                         void* stream) {
  return launch<int>(q, v, bias, scale_sq, out_s, out_i, b, n, d, blk, slots,
                     n_q, chunks, stream_q, stream);
}

// CTAs of the scan kernel one SM holds at this shape (negative: -error)
extern "C" int fused_scan_ctas_per_sm(int int8, int n_q, int row_bytes,
                                      int stream_q) {
  return int8 ? occupancy<int>(n_q, row_bytes, stream_q)
              : occupancy<float>(n_q, row_bytes, stream_q);
}

// part_s / part_i [chunks, count] -> out_s / out_i [count]
extern "C" int merge_survivors(const float* part_s, const int* part_i,
                               float* out_s, int* out_i, int chunks,
                               long long count, void* stream) {
  if (count <= 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((count + 255) / 256);
  merge_survivors_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      part_s, part_i, out_s, out_i, chunks, count);
  return static_cast<int>(cudaGetLastError());
}
