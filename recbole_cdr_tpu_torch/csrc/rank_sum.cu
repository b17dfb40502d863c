// B7: the GAUC rank sums of the dense full-sort evaluator.
//
// Replaces recbole_cdr_tpu/evaluator/evaluator.py:63-78 _pos_rank_sum (an
// XLA row sort plus two vmapped searchsorted per positive) on the row that
// _apply_masks_pairs (:40-52) masks:
//
//   masked row: history items take min(s, -FLT_MAX) (an existing -inf stays
//               -inf), column 0 (PAD) is set to -FLT_MAX;
//   out[row]  = sum over valid positives p of #{s > s_p} + (#{s == s_p} + 1) / 2
//
// with s_p the positive's masked score.
//
// Bound on an H100: bytes. The [B, I] tile is read once (4 bytes an
// element; the candidate form adds its 1-byte mask): 0.0123 ms for a [2,048
// x 4,980] dense tile at 3.35 TB/s, 0.0002 ms for a [32 x 4,980] fallback
// tile. Counting by search costs each element O(log n) compares against the
// row's n valid positives, far below the bytes at the card's rates.
//
// Design. Only the row's sum is needed, so the count runs per element, not
// per positive: with the row's valid positives' masked scores sorted (v_1
// <= ... <= v_n, NaN ones left out),
//
//   2 out[row] = n_valid + sum over elements s of (#{v < s} + #{v <= s}),
//
// the two counts from two binary searches of s in the sorted list (the
// second only where s equals an entry). NaN elements and NaN positives count
// nothing, as their comparisons are false. Every term is an integer, so the
// sum is exact in any order and bit-reproducible; out is its half, exact
// while it stays below 2^24 (a row of 5,001 items with 1,600 positives
// stays below 2^23).
//
// Launch plan (ops/rank_sum.py::rank_sum_plan): grid (cluster, B).
//   - Dense tiles (B at least the SM count): one 256-thread block a row.
//   - Short tiles: each row's columns split over a thread-block cluster of
//     up to 8 blocks (the portable size), so that B x cluster fills the SMs;
//     each block counts its span of `span` columns.
// Every block of a row: loads its first scores and its first positives at
// once (so their latency overlaps what follows); marks the row's history in
// a bitmap in shared memory (I / 8 bytes, from the row's CSR slice);
// compacts the valid positives' order keys (all warps, one shared-memory
// atomic a warp); sorts them (one warp in registers for up to 32, else a
// block bitonic sort); counts its span; reduces the block's sum with
// shuffles. In a cluster each block writes its sum into rank 0's shared
// memory (distributed shared memory, after a cluster barrier that every
// block arrived at when it started), and rank 0 adds them after one more
// cluster barrier. No second kernel, no atomics in device memory.
//
// Candidate form (rank_sum_candidates), for evaluation over sampled
// candidate lists (recbole_cdr_tpu/evaluator/evaluator.py:661-675): the row
// is np.where(cand_mask, scores, -inf), the positives are the columns that
// pos_mask marks (pos[r, j] = j, taken from the column index) and there is
// no history and no PAD column, since column 0 is a row's first positive.
// The same kernel runs with the row's mask in place of the bitmap.

#include <cfloat>
#include <climits>
#include <cmath>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;  // scores per thread in flight
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float history_min(float v) {
  // jnp.minimum(v, finfo.min): NaN and -inf stay as they are
  return (v != v || v < -FLT_MAX) ? v : -FLT_MAX;
}

// an unsigned key in the order of the floats (-0 and +0 equal; never NaN)
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the float of a key; UINT_MAX, the padding, gives NaN
__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

// the masked score of column c of a row: the candidate form's mask (crow),
// else PAD and the history bitmap
template <bool kCand>
__device__ __forceinline__ float masked(float v, int c, const uint32_t* bits, bool cand_in) {
  if (kCand) return cand_in ? v : -INFINITY;
  if (c == 0) return -FLT_MAX;
  return (bits[c >> 5] >> (c & 31)) & 1u ? history_min(v) : v;
}

// #{a < x} + #{a <= x} over the sorted a[0, N) (N a power of 2, NaN padding
// at the end, never counted)
__device__ __forceinline__ unsigned lt_le(const float* a, int N, float x) {
  int lt = 0;
  for (int step = N >> 1; step > 0; step >>= 1)
    if (a[lt + step - 1] < x) lt += step;
  lt += a[lt] < x;
  if (lt == N || !(a[lt] == x)) return 2u * lt;  // no entry equals x
  int le = 0;
  for (int step = N >> 1; step > 0; step >>= 1)
    if (a[le + step - 1] <= x) le += step;
  le += a[le] <= x;
  return (unsigned)(lt + le);
}

// grid (cluster, B): block x of row blockIdx.y counts columns [x span, (x +
// 1) span). P: the positives' slots a row (the candidate form: C); cap: the
// sorted list's room, a power of 2 >= P
template <bool kCand>
__global__ void __launch_bounds__(kThreads)
rank_sum_kernel(const float* __restrict__ scores, int I, int span,
                const int* __restrict__ row_ptr, const int* __restrict__ items,
                const uint8_t* __restrict__ cmask, const int* __restrict__ pos,
                const uint8_t* __restrict__ pmask, int P, int cap, float* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t dyn[];
  __shared__ unsigned long long wsum[kWarps];
  __shared__ unsigned long long csum[kMaxCluster];
  __shared__ int s_valid, s_keys;
  uint32_t* keys = dyn;        // [cap] order keys, then their floats
  uint32_t* bits = dyn + cap;  // [ceil(I / 32)] the history bitmap (full-sort form)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.y, rank = blockIdx.x, ncl = gridDim.x;
  if (ncl > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const float* srow = scores + (long long)row * I;
  const uint8_t* crow = kCand ? cmask + (long long)row * I : nullptr;
  const int c0 = rank * span, c1 = min(I, c0 + span);

  // ---- first loads, in flight together: this thread's first positive slot
  // and its score, and its first kLoads scores of the span
  int p0 = -1;
  float pv0 = 0.f;
  bool pin0 = true;
  if (tid < P && pmask[(long long)row * P + tid]) {
    p0 = kCand ? tid : __ldg(pos + (long long)row * P + tid);
    if (p0 >= 0 && p0 < I) {
      pv0 = __ldg(srow + p0);
      if (kCand) pin0 = crow[p0] != 0;
    } else {
      p0 = -1;
    }
  }
  float v[kLoads];
  bool in[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int c = c0 + tid + u * kThreads;
    v[u] = c < c1 ? __ldg(srow + c) : 0.f;
    in[u] = kCand && c < c1 ? crow[c] != 0 : true;
  }

  // ---- the history bitmap (full-sort form) --------------------------------
  if (tid == 0) s_valid = s_keys = 0;
  if (!kCand)
    for (int w = tid; w < (I + 31) >> 5; w += kThreads) bits[w] = 0u;
  __syncthreads();
  if (!kCand) {
    const int h_end = row_ptr[row + 1];
    for (int h = row_ptr[row] + tid; h < h_end; h += kThreads) {
      const int it = __ldg(items + h);
      if (it >= 0 && it < I) atomicOr(bits + (it >> 5), 1u << (it & 31));
    }
    __syncthreads();
  }

  // ---- the valid positives' keys, in any order (they are sorted next) -----
  for (int j0 = 0; j0 < P; j0 += kThreads) {
    const int j = j0 + tid;
    int p = p0;
    float pv = pv0;
    bool pin = pin0;
    if (j0 > 0) {
      p = -1;
      if (j < P && pmask[(long long)row * P + j]) {
        p = kCand ? j : __ldg(pos + (long long)row * P + j);
        if (p >= 0 && p < I) {
          pv = __ldg(srow + p);
          if (kCand) pin = crow[p] != 0;
        } else {
          p = -1;
        }
      }
    }
    const bool valid = p >= 0;
    const float m = valid ? masked<kCand>(pv, p, bits, pin) : 0.f;
    const bool key = valid && !(m != m);
    const unsigned bv = __ballot_sync(kFull, valid), bk = __ballot_sync(kFull, key);
    int base = 0;
    if (lane == 0) {
      if (bv) atomicAdd(&s_valid, __popc(bv));
      if (bk) base = atomicAdd(&s_keys, __popc(bk));
    }
    base = __shfl_sync(kFull, base, 0);
    if (key) keys[base + __popc(bk & ((1u << lane) - 1u))] = order_key(m);
  }
  __syncthreads();
  const int nk = s_keys;
  int N = 1;
  while (N < nk) N <<= 1;

  // ---- sort the keys ascending, NaN-keyed padding at the end ---------------
  if (N <= 32) {
    if (warp == 0) {
      unsigned k = lane < nk ? keys[lane] : UINT_MAX;
#pragma unroll
      for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
        for (int j = size >> 1; j > 0; j >>= 1) {
          const unsigned o = __shfl_xor_sync(kFull, k, j);
          k = (((lane & j) == 0) == ((lane & size) == 0)) ? min(k, o) : max(k, o);
        }
      if (lane < N) keys[lane] = __float_as_uint(key_float(k));
    }
  } else {
    for (int i = nk + tid; i < N; i += kThreads) keys[i] = UINT_MAX;
    __syncthreads();
    for (int size = 2; size <= N; size <<= 1)
      for (int j = size >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < N; i += kThreads) {
          const int o = i ^ j;
          if (o > i) {
            const unsigned a = keys[i], b = keys[o];
            if ((a > b) == ((i & size) == 0)) {
              keys[i] = b;
              keys[o] = a;
            }
          }
        }
        __syncthreads();
      }
    for (int i = tid; i < N; i += kThreads) keys[i] = __float_as_uint(key_float(keys[i]));
  }
  __syncthreads();
  const float* sorted = reinterpret_cast<const float*>(keys);

  // ---- count the span ------------------------------------------------------
  unsigned long long acc = 0;
  if (nk > 0) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int c = c0 + tid + u * kThreads;
      if (c < c1) acc += lt_le(sorted, N, masked<kCand>(v[u], c, bits, in[u]));
    }
    for (int i0 = c0 + tid + kLoads * kThreads; i0 < c1; i0 += kLoads * kThreads) {
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int c = i0 + u * kThreads;
        v[u] = c < c1 ? __ldg(srow + c) : 0.f;
        in[u] = kCand && c < c1 ? crow[c] != 0 : true;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int c = i0 + u * kThreads;
        if (c < c1) acc += lt_le(sorted, N, masked<kCand>(v[u], c, bits, in[u]));
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) wsum[warp] = acc;
  __syncthreads();
  unsigned long long total = 0;
  if (tid == 0)
    for (int w = 0; w < kWarps; ++w) total += wsum[w];
  if (ncl == 1) {
    if (tid == 0) out[row] = __ull2float_rn(total + (unsigned long long)s_valid) * 0.5f;
    return;
  }
  // ---- the cluster's sum in rank 0 ------------------------------------------
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every block has started
  if (tid == 0) cluster.map_shared_rank(csum, 0)[rank] = total;
  cluster.sync();
  if (rank == 0 && tid == 0) {
    unsigned long long s = (unsigned long long)s_valid;
    for (int r = 0; r < ncl; ++r) s += csum[r];
    out[row] = __ull2float_rn(s) * 0.5f;
  }
}

template <bool kCand>
int launch(const float* scores, int B, int I, const int* row_ptr, const int* items,
           const uint8_t* cmask, const int* pos, const uint8_t* pmask, int P, int cluster,
           int span, int cap, int smem, float* out, cudaStream_t stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const size_t need = 4 * ((size_t)cap + (kCand ? 0 : ((size_t)I + 31) / 32));
  if (I <= 0 || P < 0 || cluster < 1 || cluster > kMaxCluster || span <= 0 ||
      (long long)span * cluster < I || (long long)span * (cluster - 1) >= I || cap < 1 ||
      (cap & (cap - 1)) || cap < P || smem < 0 || smem > kMaxSmem || (size_t)smem < need)
    return (int)cudaErrorInvalidValue;
  auto kernel = rank_sum_kernel<kCand>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, scores, I, span, row_ptr, items, cmask, pos, pmask, P, cap,
                         out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// scores: [B, I] float32; row_ptr: [B + 1] CSR offsets into items; pos,
// pmask: [B, P]; cluster, span, cap, smem: the launch plan
// (ops/rank_sum.py::rank_sum_plan); out: [B]
extern "C" int rank_sum(const void* scores, int B, int I, const void* row_ptr,
                        const void* items, const void* pos, const void* pmask, int P,
                        int cluster, int span, int cap, int smem, void* out, void* stream) {
  return launch<false>((const float*)scores, B, I, (const int*)row_ptr, (const int*)items,
                       nullptr, (const int*)pos, (const uint8_t*)pmask, P, cluster, span, cap,
                       smem, (float*)out, (cudaStream_t)stream);
}

// the candidate form. scores, cand_mask, pos_mask: [B, C]; out: [B]
extern "C" int rank_sum_candidates(const void* scores, int B, int C, const void* cand_mask,
                                   const void* pmask, int cluster, int span, int cap, int smem,
                                   void* out, void* stream) {
  return launch<true>((const float*)scores, B, C, nullptr, nullptr, (const uint8_t*)cand_mask,
                      nullptr, (const uint8_t*)pmask, C, cluster, span, cap, smem, (float*)out,
                      (cudaStream_t)stream);
}
