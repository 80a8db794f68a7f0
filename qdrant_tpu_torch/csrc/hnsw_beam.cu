// The HNSW graph builder's construction beam for Hopper (sm_90a): every turn
// of one insert round's beam (ops/hnsw_build.py::_beam_construct) in one
// launch, one CTA a query, the beam kept in shared memory from turn to turn.
//
// Replaces no Pallas kernel: the JAX package's _beam_construct
// (qdrant_tpu/ops/hnsw_build.py) is an XLA program of gathers, a batched
// product and sorts, and so is the port's torch body, kept as
// _beam_construct_plain (the CPU path and the version the tests hold this
// kernel to). It computes what that body computes, turn by turn:
//
//   1. pick the `expand` best unexpanded beam entries, ties to the earlier
//      position (the beam is kept sorted, so these are the first ones);
//   2. read their link rows through `rank`, pick-major: K = expand x width
//      candidate ids, -1 where a pick or its row is missing;
//   3. a candidate that is -1, already in the beam, or stands earlier in this
//      turn's list is a duplicate: score -inf, id -1, and its row is not read;
//   4. score the others from their code rows, read where they lie in `codes`:
//      the dot with the query's code row (bf16: products summed in f32; int8:
//      the exact int32 sum, converted once), times scale_sq, minus norms[id]
//      for euclid, each step rounded on its own (no FMA contraction), so int8
//      scores equal the plain version's bit for bit;
//   5. the next beam is the stable top-ef of (beam || candidates) by score,
//      ties in concatenated index order: a bitonic sort in shared memory on
//      the key (score descending, index ascending), -0 counted as +0.
//
// A query with nothing left to expand stops; the plain turn would leave its
// state unchanged. A turn whose candidates are all duplicates skips the sort:
// the merge would keep the sorted beam as it is.
//
// Bound on this card (H100 SXM, 3.35 TB/s): the bytes of the code rows it
// scores. A B = 4,096 round at D = 1536 bf16, ef 128, expand 8, width 40
// scores at most 4,096 x 21 turns x 320 rows of 3 KB (84 GB, 25 ms) and
// fewer in fact, since duplicates are not read; link rows, norms and rank
// entries add a few percent. The torch body wrote each turn's [B, 320, D]
// gather and an f32 copy of it and read both back, ~28 GB a turn.
//
// Design for that bound, random rows of 256 B to 3 KB: many rows in flight
// on every SM. The CTA's 8 warps split into groups of G lanes (G = the row's
// vectors, at most 32); a group reads two rows at once and reduces each by
// shuffles. A vector is 16 bytes where the rows and both arrays are 16-byte
// aligned (every D that is a multiple of 8 for bf16, of 16 for int8), else a
// 4-byte word, else one element: every D runs, the common ones at full width. Shared memory is small (the query's
// code row, the beam twice, the candidates and the sort keys: 13 KB at
// D = 1536, ef 128, K = 320), so eight CTAs share an SM and the rows of some
// are in flight while others pick, deduplicate or sort. Only the code rows,
// link rows, norms and rank entries are read from device memory, and only
// the final beam is written.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

enum { N_PICK = 0, N_WORK = 1, N_SCORED = 2, N_COUNTERS = 4 };

struct Params {
  const unsigned char* q;      // [B, D] code rows of the new points
  const unsigned char* codes;  // [Ncap, D] code rows of every point
  const float* norms;          // [Ncap] (euclid)
  const int* links;            // [rows, width]
  const int* rank;             // [Ncap] global id -> row
  const int* entries;          // [B]
  float scale_sq;
  int euclid, b, row_bytes, width, rows, ef, iters, expand;
  float* out_s;                       // [B, ef]
  int* out_i;                         // [B, ef]
  unsigned long long* rows_scored;    // nullable: code rows read, summed
};

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ inline int align16(int n) { return (n + 15) & ~15; }

// Dynamic shared memory of one CTA. A shape past the card's limit is
// refused at launch (cudaFuncSetAttribute: cudaErrorInvalidValue).
inline size_t smem_bytes(int row_bytes, int ef, int k, int expand) {
  return align16(row_bytes) + 8 * static_cast<size_t>(pow2_at_least(ef + k)) + 16 * ef +
         12 * k + 4 * expand + 4 * N_COUNTERS + 2 * ef;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// torch.isfinite: neither an infinity nor a NaN
__device__ __forceinline__ bool finite(float s) {
  return (__float_as_uint(s) & 0x7f800000u) != 0x7f800000u;
}

// Ascending order of keys = descending score, then ascending index.
__device__ __forceinline__ unsigned long long sort_key(float s, int idx) {
  if (s == 0.0f) s = 0.0f;  // -0 and +0 are equal to the plain sort
  unsigned u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending with s
  return (static_cast<unsigned long long>(~u) << 32) | static_cast<unsigned>(idx);
}

// One 4-byte word of each row: four int8 or two bf16 products.
__device__ __forceinline__ void dot_word(unsigned a, unsigned b, int& acc) {
  acc = __dp4a(static_cast<int>(a), static_cast<int>(b), acc);
}

__device__ __forceinline__ void dot_word(unsigned a, unsigned b, float& acc) {
  // a bf16 is the upper half of an f32; products of two are exact in f32
  acc = fmaf(__uint_as_float(a << 16), __uint_as_float(b << 16), acc);
  acc = fmaf(__uint_as_float(a & 0xffff0000u), __uint_as_float(b & 0xffff0000u), acc);
}

template <int VB> struct Vec;
template <> struct Vec<16> {
  using T = uint4;
  static __device__ __forceinline__ T global(const unsigned char* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  template <typename A>
  static __device__ __forceinline__ void dot(const T& a, const T& b, A& acc) {
    dot_word(a.x, b.x, acc);
    dot_word(a.y, b.y, acc);
    dot_word(a.z, b.z, acc);
    dot_word(a.w, b.w, acc);
  }
};
template <> struct Vec<4> {
  using T = unsigned;
  static __device__ __forceinline__ T global(const unsigned char* p) {
    return __ldg(reinterpret_cast<const unsigned*>(p));
  }
  template <typename A>
  static __device__ __forceinline__ void dot(const T& a, const T& b, A& acc) {
    dot_word(a, b, acc);
  }
};
// one bf16 element (rows of odd D, or not 4-byte aligned)
template <> struct Vec<2> {
  using T = unsigned short;
  static __device__ __forceinline__ T global(const unsigned char* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ void dot(T a, T b, float& acc) {
    acc = fmaf(__uint_as_float(static_cast<unsigned>(a) << 16),
               __uint_as_float(static_cast<unsigned>(b) << 16), acc);
  }
};
// one int8 element (rows of D not a multiple of 4, or not 4-byte aligned)
template <> struct Vec<1> {
  using T = unsigned char;
  static __device__ __forceinline__ T global(const unsigned char* p) { return __ldg(p); }
  static __device__ __forceinline__ void dot(T a, T b, int& acc) {
    acc += static_cast<int>(static_cast<signed char>(a)) * static_cast<signed char>(b);
  }
};

// The score of id's row from its finished dot, each step rounded alone.
__device__ __forceinline__ float finish(int acc, int id, const Params& p) {
  float s = __fmul_rn(__int2float_rn(acc), p.scale_sq);
  return p.euclid ? __fsub_rn(s, __ldg(p.norms + id)) : s;
}

__device__ __forceinline__ float finish(float acc, int id, const Params& p) {
  float s = __fmul_rn(acc, p.scale_sq);
  return p.euclid ? __fsub_rn(s, __ldg(p.norms + id)) : s;
}

// Scores cand_s[work[w]] for w < n_work from the rows of cand_ids[work[w]].
// Every thread of the CTA calls it; groups of G lanes take two rows a pass.
template <typename A, int VB>
__device__ void score_rows(const Params& p, const unsigned char* q_s, const int* work,
                           int n_work, const int* cand_ids, float* cand_s,
                           int* counters) {
  using V = Vec<VB>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = p.row_bytes / VB;
  int g_lanes = 1;
  while (g_lanes < chunks && g_lanes < 32) g_lanes <<= 1;
  const int per_warp = 32 / g_lanes;
  const int grp = lane / g_lanes, lg = lane % g_lanes;
  int scored = 0;
  for (int base = warp * 2 * per_warp; base < n_work; base += WARPS * 2 * per_warp) {
    const int w0 = base + grp, w1 = base + per_warp + grp;
    const int j0 = w0 < n_work ? work[w0] : -1;
    const int j1 = w1 < n_work ? work[w1] : -1;
    const int id0 = j0 >= 0 ? cand_ids[j0] : -1;
    const int id1 = j1 >= 0 ? cand_ids[j1] : -1;
    const unsigned char* r0 = p.codes + static_cast<size_t>(id0 < 0 ? 0 : id0) * p.row_bytes;
    const unsigned char* r1 = p.codes + static_cast<size_t>(id1 < 0 ? 0 : id1) * p.row_bytes;
    A a0 = 0, a1 = 0;
#pragma unroll 2
    for (int c = lg; c < chunks; c += g_lanes) {
      const typename V::T qv = *reinterpret_cast<const typename V::T*>(q_s + c * VB);
      if (id0 >= 0) V::dot(V::global(r0 + c * VB), qv, a0);
      if (id1 >= 0) V::dot(V::global(r1 + c * VB), qv, a1);
    }
    for (int o = g_lanes >> 1; o > 0; o >>= 1) {
      a0 += __shfl_xor_sync(FULL, a0, o);
      a1 += __shfl_xor_sync(FULL, a1, o);
    }
    if (lg == 0) {
      if (id0 >= 0) {
        cand_s[j0] = finish(a0, id0, p);
        ++scored;
      }
      if (id1 >= 0) {
        cand_s[j1] = finish(a1, id1, p);
        ++scored;
      }
    }
  }
  if (scored) atomicAdd(&counters[N_SCORED], scored);
}

// Ascending bitonic sort of n (a power of two) keys; ends synchronised.
__device__ void bitonic_sort(unsigned long long* keys, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += THREADS) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const unsigned long long a = keys[i], c = keys[j];
        if ((a > c) == ((i & size) == 0)) {
          keys[i] = c;
          keys[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

template <typename A, int VB>
__global__ void __launch_bounds__(THREADS) beam_construct_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ef = p.ef, k = p.expand * p.width;
  const int n_all = ef + k, n2 = pow2_at_least(n_all);

  unsigned char* q_s = smem;
  int off = align16(p.row_bytes);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem + off);
  off += 8 * n2;
  int* ids = reinterpret_cast<int*>(smem + off);  // two beams of ef, turn by turn
  off += 8 * ef;
  float* sc = reinterpret_cast<float*>(smem + off);
  off += 8 * ef;
  int* cand_ids = reinterpret_cast<int*>(smem + off);
  off += 4 * k;
  float* cand_s = reinterpret_cast<float*>(smem + off);
  off += 4 * k;
  int* work = reinterpret_cast<int*>(smem + off);
  off += 4 * k;
  int* pick_row = reinterpret_cast<int*>(smem + off);
  off += 4 * p.expand;
  int* counters = reinterpret_cast<int*>(smem + off);
  off += 4 * N_COUNTERS;
  unsigned char* expd = smem + off;

  // the query's code row, the seed beam and the entry as the one work item
  const unsigned char* q_g = p.q + static_cast<size_t>(b) * p.row_bytes;
  for (int i = tid; i < p.row_bytes; i += THREADS) q_s[i] = q_g[i];
  for (int i = tid; i < ef; i += THREADS) {
    ids[i] = -1;
    sc[i] = neg_inf();
    expd[i] = 1;
  }
  const int entry = p.entries[b];
  if (tid == 0) {
    cand_ids[0] = entry;
    work[0] = 0;
    counters[N_SCORED] = 0;
  }
  __syncthreads();
  if (entry >= 0) {
    score_rows<A, VB>(p, q_s, work, 1, cand_ids, cand_s, counters);
    __syncthreads();
    if (tid == 0) {
      ids[0] = entry;
      sc[0] = cand_s[0];
      expd[0] = 0;
    }
  }

  int cur = 0;
  for (int it = 0; it < p.iters; ++it) {
    int* bid = ids + cur * ef;
    float* bs = sc + cur * ef;
    unsigned char* bx = expd + cur * ef;
    __syncthreads();
    // 1. picks: the first `expand` unexpanded live entries of the sorted beam
    if (warp == 0) {
      int n_pick = 0;
      for (int base = 0; base < ef && n_pick < p.expand; base += 32) {
        const int i = base + lane;
        const bool ok = i < ef && !bx[i] && bid[i] >= 0 && finite(bs[i]);
        const unsigned m = __ballot_sync(FULL, ok);
        const int slot = n_pick + __popc(m & ((1u << lane) - 1u));
        if (ok && slot < p.expand) {
          bx[i] = 1;
          const int r = __ldg(p.rank + bid[i]);
          pick_row[slot] = (r >= 0 && r < p.rows) ? r : -1;
        }
        n_pick += __popc(m);
      }
      if (lane == 0) {
        counters[N_PICK] = n_pick < p.expand ? n_pick : p.expand;
        counters[N_WORK] = 0;
      }
    }
    __syncthreads();
    const int n_pick = counters[N_PICK];
    if (n_pick == 0) break;  // nothing left to expand: the state stays

    // 2. candidates: the picks' link rows, pick-major
    const int n_live = n_pick * p.width;
    for (int j = tid; j < k; j += THREADS) {
      int id = -1;
      if (j < n_live) {
        const int r = pick_row[j / p.width];
        if (r >= 0) id = __ldg(p.links + static_cast<size_t>(r) * p.width + j % p.width);
      }
      cand_ids[j] = id;
    }
    __syncthreads();

    // 3. duplicates of the beam or of an earlier candidate; the rest to score
    for (int j = tid; j < k; j += THREADS) {
      const int id = cand_ids[j];
      bool dup = id < 0;
      for (int i = 0; i < ef && !dup; ++i) dup = bid[i] == id;
      for (int i = 0; i < j && !dup; ++i) dup = cand_ids[i] == id;
      cand_s[j] = neg_inf();
      if (!dup) work[atomicAdd(&counters[N_WORK], 1)] = j;
    }
    __syncthreads();
    const int n_work = counters[N_WORK];
    if (n_work == 0) continue;  // the merge would keep the beam as it is

    // 4. scores, straight from the code rows
    score_rows<A, VB>(p, q_s, work, n_work, cand_ids, cand_s, counters);
    __syncthreads();

    // 5. the stable top-ef of (beam || candidates)
    for (int i = tid; i < n2; i += THREADS) {
      unsigned long long key = ~0ull;
      if (i < ef)
        key = sort_key(bs[i], i);
      else if (i < n_all)
        key = sort_key(cand_s[i - ef], i);
      keys[i] = key;
    }
    __syncthreads();
    bitonic_sort(keys, n2);
    const int nxt = (cur ^ 1) * ef;
    for (int i = tid; i < ef; i += THREADS) {
      const int src = static_cast<int>(keys[i] & 0xffffffffu);
      int id;
      float s;
      unsigned char x;
      if (src < ef) {
        id = bid[src];
        s = bs[src];
        x = bx[src];
      } else {
        s = cand_s[src - ef];
        id = finite(s) ? cand_ids[src - ef] : -1;
        x = 0;
      }
      ids[nxt + i] = id;
      sc[nxt + i] = s;
      expd[nxt + i] = x | (id < 0);
    }
    cur ^= 1;
  }
  __syncthreads();
  float* out_s = p.out_s + static_cast<size_t>(b) * ef;
  int* out_i = p.out_i + static_cast<size_t>(b) * ef;
  for (int i = tid; i < ef; i += THREADS) {
    out_s[i] = sc[cur * ef + i];
    out_i[i] = ids[cur * ef + i];
  }
  if (tid == 0 && p.rows_scored)
    atomicAdd(p.rows_scored, static_cast<unsigned long long>(counters[N_SCORED]));
}

template <typename A, int VB>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.row_bytes, p.ef, p.expand * p.width, p.expand);
  if (smem > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = beam_construct_kernel<A, VB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // the refusal is returned here, not left for the next launch
    return static_cast<int>(err);
  }
  kernel<<<p.b, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [b, d] and codes [n, d] int8 (int8 != 0) or bf16, row-major, any d;
// links [rows, width], rank and entries int32; out_s [b, ef] f32, out_i
// [b, ef] int32; rows_scored nullable. Any width, ef and expand whose CTA
// fits the card's shared memory. Returns a cudaError_t.
extern "C" int hnsw_beam_construct(const void* q, const void* codes, const float* norms,
                                   const int* links, const int* rank, const int* entries,
                                   float scale_sq, int euclid, int int8, int b, int d,
                                   int width, int rows, int ef, int iters, int expand,
                                   float* out_s, int* out_i,
                                   unsigned long long* rows_scored, void* stream) {
  if (b <= 0) return static_cast<int>(cudaSuccess);
  if (d < 1 || expand < 1 || ef < 1 || width < 1 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const unsigned char*>(q), static_cast<const unsigned char*>(codes),
           norms, links, rank, entries, scale_sq, euclid, b, d * (int8 ? 1 : 2), width,
           rows, ef, iters, expand, out_s, out_i, rows_scored};
  // the widest vector that divides every row and keeps it aligned
  const uintptr_t at = reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(q) |
                       static_cast<uintptr_t>(p.row_bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (at % 16 == 0) return int8 ? launch<int, 16>(p, s) : launch<float, 16>(p, s);
  if (at % 4 == 0) return int8 ? launch<int, 4>(p, s) : launch<float, 4>(p, s);
  return int8 ? launch<int, 1>(p, s) : launch<float, 2>(p, s);
}
