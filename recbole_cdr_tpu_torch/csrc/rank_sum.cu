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
// with s_p the positive's masked score. Each rank is a half-integer below
// 2^22, so the float32 sum is exact in any order while it stays below 2^23.
//
// Bound on an H100: bytes while a row has few positives. The [B, I] tile is
// read once (4 bytes per element) and each element is compared with every
// valid positive of its row (2 compares each): a few operations per byte at
// the handful of positives an evaluation row holds, below the card's float32
// balance point.
// Design: no sort. One block per row marks the row's history and column 0 in
// a shared-memory bitmap (I / 8 bytes); one warp compacts the row's valid
// positives (a row holds a few of the padded width) with their masked
// scores; the block then stages the masked row in chunks of `chunk` floats
// in shared memory (one coalesced read of the row in all, each thread
// keeping 8 loads in flight: one load at a time leaves the card far below
// its memory rate) and counts, for
// groups of 8 valid positives at a time, the greater and tied elements of
// the chunk in registers; warps reduce their counts and add them to
// per-positive shared counters, and one warp sums the ranks. Integer counts
// and exact sums make the result exact and bit-reproducible.

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;  // positives counted per pass over a chunk
constexpr int kLoads = 8;  // loads per thread in flight while staging a chunk

__device__ __forceinline__ float history_min(float v) {
  // jnp.minimum(v, finfo.min): NaN and -inf stay as they are
  return (v != v || v < -FLT_MAX) ? v : -FLT_MAX;
}

__global__ void __launch_bounds__(kThreads)
rank_sum_kernel(const float* __restrict__ scores, int I,
                const int* __restrict__ row_ptr, const int* __restrict__ items,
                const int* __restrict__ pos, const uint8_t* __restrict__ pmask,
                int P, int chunk, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_valid;
  const int words = (I + 31) >> 5;
  uint32_t* bitmap = reinterpret_cast<uint32_t*>(smem);
  float* buf = reinterpret_cast<float*>(bitmap + words);
  float* pval = buf + chunk;
  int* gt = reinterpret_cast<int*>(pval + P);
  int* eq = gt + P;

  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* srow = scores + (long long)row * I;

  for (int w = threadIdx.x; w < words; w += kThreads) bitmap[w] = 0u;
  for (int j = threadIdx.x; j < P; j += kThreads) gt[j] = eq[j] = 0;
  __syncthreads();
  if (threadIdx.x == 0) atomicOr(&bitmap[0], 1u);  // PAD column
  const int h_end = row_ptr[row + 1];
  for (int h = row_ptr[row] + threadIdx.x; h < h_end; h += kThreads) {
    const int it = items[h];
    if (it >= 0 && it < I) atomicOr(&bitmap[it >> 5], 1u << (it & 31));
  }
  __syncthreads();

  // the row's valid positives, compacted in order, with their masked scores
  if (warp == 0) {
    int base = 0;
    for (int j0 = 0; j0 < P; j0 += 32) {
      const int j = j0 + lane;
      const long long o = (long long)row * P + j;
      const int p = j < P && pmask[o] ? pos[o] : -1;
      const bool valid = p >= 0 && p < I;
      const unsigned ballot = __ballot_sync(0xffffffffu, valid);
      if (valid) {
        float v = srow[p];
        if (p == 0) v = -FLT_MAX;
        else if ((bitmap[p >> 5] >> (p & 31)) & 1u) v = history_min(v);
        pval[base + __popc(ballot & ((1u << lane) - 1u))] = v;
      }
      base += __popc(ballot);
    }
    if (lane == 0) n_valid = base;
  }
  __syncthreads();
  const int nv = n_valid;

  for (int lo = 0; lo < I; lo += chunk) {
    const int n = min(chunk, I - lo);
    // kLoads loads in flight per thread before any is used
    for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kLoads) {
      float v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * kThreads;
        v[u] = i < n ? __ldg(srow + lo + i) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int i = i0 + u * kThreads, c = lo + i;
        if (i < n) {
          if (c == 0) v[u] = -FLT_MAX;
          else if ((bitmap[c >> 5] >> (c & 31)) & 1u) v[u] = history_min(v[u]);
          buf[i] = v[u];
        }
      }
    }
    __syncthreads();
    for (int g0 = 0; g0 < nv; g0 += kGroup) {
      float pv[kGroup];
      unsigned cg[kGroup], ce[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        pv[u] = g0 + u < nv ? pval[g0 + u] : __int_as_float(0x7fc00000);
        cg[u] = ce[u] = 0u;
      }
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const float v = buf[i];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          cg[u] += v > pv[u];
          ce[u] += v == pv[u];
        }
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const unsigned sg = __reduce_add_sync(0xffffffffu, cg[u]);
        const unsigned se = __reduce_add_sync(0xffffffffu, ce[u]);
        if (lane == 0 && g0 + u < nv && (sg | se)) {
          atomicAdd(&gt[g0 + u], (int)sg);
          atomicAdd(&eq[g0 + u], (int)se);
        }
      }
    }
    __syncthreads();  // the chunk buffer is rewritten next
  }

  if (warp == 0) {  // half-integer ranks: the float sum is exact in any order
    float sum = 0.f;
    for (int j = lane; j < nv; j += 32)
      sum = __fadd_rn(sum, __fadd_rn((float)gt[j], __fdiv_rn(__fadd_rn((float)eq[j], 1.f), 2.f)));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) out[row] = sum;
  }
}

}  // namespace

// scores: [B, I] float32; row_ptr: [B + 1] CSR offsets into items; pos,
// pmask: [B, P]; out: [B]
extern "C" int rank_sum(const void* scores, int B, int I, const void* row_ptr,
                        const void* items, const void* pos, const void* pmask,
                        int P, int chunk, void* out, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)((I + 31) >> 5) * 4 + (size_t)chunk * 4 +
                      (size_t)(P > 0 ? P : 1) * 12;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rank_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rank_sum_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)scores, I, (const int*)row_ptr, (const int*)items,
      (const int*)pos, (const uint8_t*)pmask, P, chunk, (float*)out);
  return (int)cudaGetLastError();
}
