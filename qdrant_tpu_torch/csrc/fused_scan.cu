// Fused exact-scan "survivors" kernel for Hopper (sm_90a): bf16 and int8
// modes.
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
// Design. The TPU grid walks vector blocks in order on one core and carries
// the slot ring in VMEM from step to step. Here nothing carries over between
// CTAs, so the grid is (slot, query tile): each CTA owns one slot's
// [QT, 128] winners in registers, walks its blocks nb = slot, slot+slots, ...
// in ascending order and writes the slot once. No atomics, no second pass.
// Each 128-row group of a block is one [QT, 128] x D tile product on the
// tensor cores (mma.sync m16n8k16 bf16 -> f32, or m16n8k32 s8 -> s32); the
// running max lives in the same register layout as the accumulator fragment,
// so scores never leave registers.
//
// One kernel serves both modes. A pipeline stage is 64 bytes of every row
// (32 bf16 or 64 int8 values), streamed with 16-byte cp.async chunks into
// double-buffered shared memory rows padded to 80 bytes. The two mma shapes
// read their A and B fragments at the same byte offsets (thread t of a
// quad holds bytes 4t..4t+3 and 16+4t..16+4t+3 of a 32-byte k step), and
// their accumulators share one layout, so only the mma instruction and the
// epilogue's arithmetic depend on the mode.
//
// Bound on this card. The kernel makes one pass over V per query tile. At
// small B it is bound by that pass (B=8 x 1M x 1536 int8: 1.54 GB of codes
// at 3.35 TB/s = 0.46 ms); at large B by the tensor cores (bf16 at B >= 256
// and D = 128 sits near the ~295 FLOP/byte ridge). The f32 scores never
// reach memory (the XLA formulation's cost on the TPU). It uses mma.sync,
// not wgmma/TMA, and has only slots x ceil(B/32) CTAs, so small batches use
// 16 of the 132 SMs; both are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;     // row groups are 128 rows wide (TPU lane width)
constexpr int QT = 32;         // query rows per CTA
constexpr int KB = 64;         // bytes of each row per pipeline stage
constexpr int LDB = KB + 16;   // padded smem row: 80 bytes, conflict-free frags
constexpr int THREADS = 128;   // 4 warps, each 32 rows x 32 lanes
constexpr float NEG_INF = -3.402823466e+38f;  // finfo(float32).min

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// bf16 x bf16 -> f32, 16 x 8 x 16
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// s8 x s8 -> s32, 16 x 8 x 32 (exact)
__device__ __forceinline__ void mma(int* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// Acc = float: bf16 operands; Acc = int: int8 operands. q [b, row_bytes],
// v [n, row_bytes] as bytes.
template <typename Acc>
__global__ void __launch_bounds__(THREADS)
fused_scan_kernel(const uint8_t* __restrict__ q,
                  const uint8_t* __restrict__ v,
                  const float* __restrict__ bias, float scale_sq,
                  float* __restrict__ out_s, int* __restrict__ out_i, int b,
                  int n, int row_bytes, int blk, int slots) {
  __shared__ __align__(16) uint8_t qs[2][QT][LDB];
  __shared__ __align__(16) uint8_t vs[2][LANES][LDB];

  const int slot = blockIdx.x;
  const int q0 = blockIdx.y * QT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;  // mma group id: fragment row / column
  const int t = tid & 3;          // thread in group: fragment k bytes

  const int groups = blk / LANES;
  const int nblocks = n / blk;
  const int my_blocks =
      nblocks > slot ? (nblocks - slot + slots - 1) / slots : 0;
  const int kchunks = row_bytes / KB;
  const int steps = my_blocks * groups * kchunks;

  Acc acc[2][4][4];
  float best[2][4][4];
  int bid[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[mi][ni][c] = Acc(0);
        best[mi][ni][c] = NEG_INF;
        bid[mi][ni][c] = -1;
      }

  // first row of the 128-row group that tile `tile` of this CTA scores
  auto tile_row0 = [&](int tile) -> long long {
    const int nb = slot + (tile / groups) * slots;
    return static_cast<long long>(nb) * blk +
           static_cast<long long>(tile % groups) * LANES;
  };

  auto load = [&](int step, int buf) {
    const int tile = step / kchunks;
    const int k0 = (step % kchunks) * KB;
    const long long row0 = tile_row0(tile);
    {  // Q: QT rows x 64 bytes = 128 16-byte chunks, one per thread
      const int r = tid >> 2, c = tid & 3;
      const int row = q0 + r;
      const uint8_t* src =
          q + static_cast<long long>(row < b ? row : b - 1) * row_bytes + k0 +
          c * 16;
      cp_async16(&qs[buf][r][c * 16], src, row < b ? 16 : 0);  // zero-fill pad
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // V: 128 rows x 64 bytes = 512 chunks
      const int idx = tid + i * THREADS;
      const int r = idx >> 2, c = idx & 3;
      cp_async16(&vs[buf][r][c * 16], v + (row0 + r) * row_bytes + k0 + c * 16,
                 16);
    }
    cp_async_commit();
  };

  if (steps > 0) load(0, 0);
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) {
      load(step + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < KB; kk += 32) {  // one mma k step = 32 bytes
      uint32_t a[2][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = mi * 16 + g;
        a[mi][0] = ld32(&qs[buf][r][kk + t * 4]);
        a[mi][1] = ld32(&qs[buf][r + 8][kk + t * 4]);
        a[mi][2] = ld32(&qs[buf][r][kk + t * 4 + 16]);
        a[mi][3] = ld32(&qs[buf][r + 8][kk + t * 4 + 16]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = warp * 32 + ni * 8 + g;
        bf[ni][0] = ld32(&vs[buf][c][kk + t * 4]);
        bf[ni][1] = ld32(&vs[buf][c][kk + t * 4 + 16]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], a[mi], bf[ni]);
    }

    if (step % kchunks == kchunks - 1) {
      // tile done: fold its [QT, 128] scores into the running slot winners
      const long long row0 = tile_row0(step / kchunks);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int lane = warp * 32 + ni * 8 + t * 2;
        const float2 bb =
            *reinterpret_cast<const float2*>(bias + row0 + lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float s =
                epilogue(acc[mi][ni][c], scale_sq, (c & 1) ? bb.y : bb.x);
            if (s > best[mi][ni][c]) {
              best[mi][ni][c] = s;
              bid[mi][ni][c] = static_cast<int>(row0 + lane + (c & 1));
            }
            acc[mi][ni][c] = Acc(0);
          }
      }
    }
    __syncthreads();  // buffer `buf` is refilled by the next iteration's load
  }

  const long long width = static_cast<long long>(slots) * LANES;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = q0 + mi * 16 + g + (c >> 1) * 8;
        if (row < b) {
          const long long o = row * width + slot * LANES + warp * 32 +
                              ni * 8 + t * 2 + (c & 1);
          out_s[o] = best[mi][ni][c];
          out_i[o] = bid[mi][ni][c];
        }
      }
}

template <typename Acc>
int launch(const void* q, const void* v, const float* bias, float scale_sq,
           float* out_s, int* out_i, int b, int n, int row_bytes, int blk,
           int slots, void* stream) {
  if (b <= 0 || slots <= 0) return static_cast<int>(cudaSuccess);
  dim3 grid(slots, (b + QT - 1) / QT);
  fused_scan_kernel<Acc>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(v),
          bias, scale_sq, out_s, out_i, b, n, row_bytes, blk, slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Shapes: q [b, d], v [n, d],
// bias [n] f32, out_s / out_i [b, slots*128]. Both need d bytes per row to
// be a multiple of 64 (bf16: d % 32 == 0; int8: d % 64 == 0), blk % 128 ==
// 0, n % blk == 0 and 16-byte aligned q / v. Each launches on `stream` and
// returns cudaGetLastError() (0 = launched).
extern "C" int fused_scan_survivors_bf16(const void* q, const void* v,
                                         const float* bias, float* out_s,
                                         int* out_i, int b, int n, int d,
                                         int blk, int slots, void* stream) {
  return launch<float>(q, v, bias, 1.0f, out_s, out_i, b, n, d * 2, blk,
                       slots, stream);
}

extern "C" int fused_scan_survivors_int8(const void* q, const void* v,
                                         const float* bias, float scale_sq,
                                         float* out_s, int* out_i, int b,
                                         int n, int d, int blk, int slots,
                                         void* stream) {
  return launch<int>(q, v, bias, scale_sq, out_s, out_i, b, n, d, blk, slots,
                     stream);
}
