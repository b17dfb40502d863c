// B12: DCDCSR's benchmark top-k and blend.
//
// Replaces recbole_cdr_tpu/models/dcdcsr.py:179-189, the non-overlapped part
// of DCDCSR._build_benchmark: for each row m of rest [M, D] (the target
// table's rows past the overlap) the similarities rest[m] . src[j] to the
// n_ov overlapped source rows (PAD row 0 among them), their top k (value
// descending, the lower index first on a tie, as lax.top_k), and the blend
//   sn     = mean(s_pop[idx])
//   beta   = sn / (sn + t_pop[m])            (NaN where both are 0, as JAX)
//   sim_e  = sum_q sim_q src[idx_q] / (sum_q sim_q if > 0 else 1)
//   out[m] = (1 - beta) rest[m] + beta sim_e
// written with idx [M, k] and sim [M, k].
//
// Bound on an H100: operations, the 2 M n_ov D flops of the similarity
// product on the CUDA cores (float32, as the JAX reference computes it); the
// bytes (the two tables once, the output) are ~30x below. Design, two
// launches:
//   1. sim_topk_kernel: a block of 64 threads owns 64 rows, one row a thread,
//      and one of `splits` column ranges (blockIdx.y), so that a few hundred
//      blocks fill the card. The block stages 32 source rows x 64 columns of
//      D at a time in shared memory; each thread holds its row's 64 columns
//      in registers (loaded once for D <= 64, not once per tile: a warp's
//      row loads touch 32 cache lines each) and adds the 32 products of each
//      column in d order with fmaf (every thread reads the same staged word:
//      a broadcast, one shared-memory wavefront per 4 FMAs of a warp). Each
//      thread keeps its row's top K of the range in registers, sorted by
//      (value desc, index asc); the columns arrive in increasing index
//      order, so an equal value never displaces an earlier one: the tie rule
//      holds without sorting.
//   2. merge_blend_kernel: one warp per row merges the splits' lists (k
//      rounds of a warp argmax by (value desc, index asc)), then computes
//      the blend, the D columns spread over the lanes.
// The similarities do not depend on the split count (each is one fmaf
// chain in d order), so neither do the results.

#include <cfloat>
#include <climits>
#include <cmath>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // threads of a sim_topk block, one row each
constexpr int kTile = 32;     // source rows staged per tile
constexpr int kChunk = 64;    // columns of D held in registers at a time
constexpr int kMergeWarps = 8;

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

template <int K>
__device__ __forceinline__ void insert(float (&vals)[K], int (&idxs)[K], float v, int i) {
  if (!better(v, i, vals[K - 1], idxs[K - 1])) return;
  vals[K - 1] = v;
  idxs[K - 1] = i;
#pragma unroll
  for (int q = K - 1; q > 0; --q) {
    if (better(vals[q], idxs[q], vals[q - 1], idxs[q - 1])) {
      const float tv = vals[q];
      vals[q] = vals[q - 1];
      vals[q - 1] = tv;
      const int ti = idxs[q];
      idxs[q] = idxs[q - 1];
      idxs[q - 1] = ti;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kRows)
sim_topk_kernel(const float* __restrict__ rest, const float* __restrict__ src, int M,
                int n_ov, int D, int cols_per_split, float* __restrict__ part_val,
                int* __restrict__ part_idx) {
  __shared__ float4 tile[kTile][kChunk / 4];
  const int row = blockIdx.x * kRows + threadIdx.x;
  const int lo = blockIdx.y * cols_per_split;
  const int hi = min(n_ov, lo + cols_per_split);
  const float* rrow = rest + (long long)min(row, M - 1) * D;

  float vals[K];
  int idxs[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    vals[q] = -INFINITY;
    idxs[q] = INT_MAX;
  }
  float4 a[kChunk / 4];
  int a_c0 = -1;  // the chunk of the row that a holds: loaded once when D <= 64
  for (int j0 = lo; j0 < hi; j0 += kTile) {
    float acc[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[j] = 0.f;
    for (int c0 = 0; c0 < D; c0 += kChunk) {
      const int dc = min(kChunk, D - c0);
      __syncthreads();  // the previous tile's reads are done
      float* t = reinterpret_cast<float*>(tile);
      for (int e = threadIdx.x; e < kTile * kChunk; e += kRows) {
        const int j = e / kChunk, d = e % kChunk;
        t[e] = (j0 + j < hi && d < dc) ? src[(long long)(j0 + j) * D + c0 + d] : 0.f;
      }
      if (a_c0 != c0) {  // one thread a row: these loads do not coalesce
#pragma unroll
        for (int v = 0; v < kChunk / 4; ++v) {
          const int d = c0 + 4 * v;
          a[v].x = 4 * v + 0 < dc ? rrow[d + 0] : 0.f;
          a[v].y = 4 * v + 1 < dc ? rrow[d + 1] : 0.f;
          a[v].z = 4 * v + 2 < dc ? rrow[d + 2] : 0.f;
          a[v].w = 4 * v + 3 < dc ? rrow[d + 3] : 0.f;
        }
        a_c0 = c0;
      }
      __syncthreads();
#pragma unroll
      for (int v = 0; v < kChunk / 4; ++v) {
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          const float4 b = tile[j][v];
          acc[j] = fmaf(a[v].x, b.x, acc[j]);
          acc[j] = fmaf(a[v].y, b.y, acc[j]);
          acc[j] = fmaf(a[v].z, b.z, acc[j]);
          acc[j] = fmaf(a[v].w, b.w, acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j0 + j < hi) insert<K>(vals, idxs, acc[j], j0 + j);
    }
  }
  if (row < M) {
    const long long base = ((long long)blockIdx.y * M + row) * K;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      part_val[base + q] = vals[q];
      part_idx[base + q] = idxs[q];
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kMergeWarps * 32)
merge_blend_kernel(const float* __restrict__ part_val, const int* __restrict__ part_idx,
                   int splits, const float* __restrict__ rest, const float* __restrict__ src,
                   const float* __restrict__ s_pop, const float* __restrict__ t_pop, int M,
                   int D, int k, float* __restrict__ out, int* __restrict__ idx_out,
                   float* __restrict__ sim_out) {
  extern __shared__ float merge_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMergeWarps + warp;
  if (row >= M) return;  // only warp-level synchronisation below
  const int nc = splits * K;
  float* cv = merge_smem + (long long)warp * 2 * (nc + K);
  int* ci = reinterpret_cast<int*>(cv + nc);
  float* sv = cv + 2 * nc;
  int* si = reinterpret_cast<int*>(sv + K);

  for (int e = lane; e < nc; e += 32) {
    const long long p = ((long long)(e / K) * M + row) * K + e % K;
    cv[e] = part_val[p];
    ci[e] = part_idx[p];
  }
  __syncwarp();
  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bi = INT_MAX, bp = -1;
    for (int e = lane; e < nc; e += 32) {
      if (better(cv[e], ci[e], bv, bi)) {
        bv = cv[e];
        bi = ci[e];
        bp = e;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      const int op = __shfl_xor_sync(0xffffffffu, bp, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
        bp = op;
      }
    }
    if (lane == 0 && bp >= 0) {  // k <= n_ov: a real candidate is always left
      sv[r] = bv;
      si[r] = bi;
      cv[bp] = -INFINITY;  // taken
      ci[bp] = INT_MAX;
    }
    __syncwarp();
  }

  float sn = 0.f, sum_sim = 0.f;
  for (int q = 0; q < k; ++q) {
    sn += s_pop[si[q]];
    sum_sim += sv[q];
  }
  sn = sn / (float)k;
  const float beta = sn / (sn + t_pop[row]);
  const float denom = sum_sim > 0.f ? sum_sim : 1.f;
  const float* rrow = rest + (long long)row * D;
  float* orow = out + (long long)row * D;
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int q = 0; q < k; ++q) acc = fmaf(sv[q], src[(long long)si[q] * D + d], acc);
    orow[d] = (1.f - beta) * rrow[d] + beta * (acc / denom);
  }
  if (lane < k) {
    idx_out[(long long)row * k + lane] = si[lane];
    sim_out[(long long)row * k + lane] = sv[lane];
  }
}

template <int K>
int launch(const float* rest, const float* src, const float* s_pop, const float* t_pop,
           int M, int n_ov, int D, int k, int splits, float* part_val, int* part_idx,
           float* out, int* idx, float* sim, cudaStream_t stream) {
  const int cols = (n_ov + splits - 1) / splits;
  const dim3 grid((M + kRows - 1) / kRows, splits);
  sim_topk_kernel<K><<<grid, kRows, 0, stream>>>(rest, src, M, n_ov, D, cols, part_val,
                                                 part_idx);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)kMergeWarps * 2 * (splits * K + K) * sizeof(float);
  merge_blend_kernel<K><<<(M + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, smem,
                          stream>>>(part_val, part_idx, splits, rest, src, s_pop, t_pop, M,
                                    D, k, out, idx, sim);
  return (int)cudaGetLastError();
}

}  // namespace

// rest [M, D], src [n_ov, D], s_pop [n_ov], t_pop [M] float32; 1 <= k <= 32,
// k <= n_ov; 1 <= splits <= 8; scratch part_val / part_idx [splits, M, 16 or
// 32 (k <= 16 or not)]; out [M, D], idx [M, k] int32, sim [M, k].
extern "C" int benchmark_topk(const void* rest, const void* src, const void* s_pop,
                              const void* t_pop, int M, int n_ov, int D, int k, int splits,
                              void* part_val, void* part_idx, void* out, void* idx,
                              void* sim, void* stream) {
  if (M <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > 32 || k > n_ov || D < 1 || splits < 1 || splits > 8)
    return (int)cudaErrorInvalidValue;
  const float* r = (const float*)rest;
  const float* s = (const float*)src;
  const float* sp = (const float*)s_pop;
  const float* tp = (const float*)t_pop;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 16)
    return launch<16>(r, s, sp, tp, M, n_ov, D, k, splits, (float*)part_val,
                      (int*)part_idx, (float*)out, (int*)idx, (float*)sim, st);
  return launch<32>(r, s, sp, tp, M, n_ov, D, k, splits, (float*)part_val, (int*)part_idx,
                    (float*)out, (int*)idx, (float*)sim, st);
}
