// K4: history-masked full-row top-k of the dense full-sort evaluator.
//
// Replaces recbole_cdr_tpu/evaluator/evaluator.py:40-52 _apply_masks_pairs
// plus the lax.top_k of _fused_program (:299-311): every (row, item) history
// pair and column 0 (PAD) is set to finfo(float32).min, then the k largest
// scores of each row are selected, ties going to the lowest column (masked
// entries included, which matters when fewer than k items are unmasked).
// Only the [B, k] ids are written; the masked score matrix never is.
//
// Bound on an H100: bytes. The [B, I] score matrix is read once (4 bytes per
// element, ~1 compare each). Design: one block per row. The block marks the
// row's history items in a shared-memory bitmap (I / 8 bytes; I stays below
// the streaming threshold of 1e6 items, so at most 125 KB), then each thread
// scans a strided, coalesced slice of the row keeping a register-resident
// sorted top-K list (K a template bound >= k); k rounds of a block-wide
// argmax over the list heads, ordered by (score desc, index asc), merge them.
//
// B10, the candidate top-k, shares the selection through the kCand template
// flag. It replaces recbole_cdr_tpu/evaluator/evaluator.py:88-93
// _candidate_topk: over [B, C] scores of each user's sampled candidate list,
// the slots a row's cand_mask leaves out are set to finfo(float32).min and
// the k best positions are taken, ties to the lowest position. There is no
// history and no PAD column: column 0 is a row's first positive. Bound:
// bytes, the scores and the mask read once.

#include <cfloat>
#include <climits>
#include <cmath>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

template <int K, bool kCand>
__global__ void __launch_bounds__(kThreads)
masked_topk_kernel(const float* __restrict__ scores, int I,
                   const int* __restrict__ row_ptr,
                   const int* __restrict__ items,
                   const unsigned char* __restrict__ cand_mask, int k,
                   int* __restrict__ out) {
  extern __shared__ uint32_t mask[];
  __shared__ float wv[kWarps];
  __shared__ int wi[kWarps];
  __shared__ int winner;
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int words = (I + 31) >> 5;

  if (!kCand) {
    for (int w = threadIdx.x; w < words; w += kThreads) mask[w] = 0u;
    __syncthreads();
    if (threadIdx.x == 0) atomicOr(&mask[0], 1u);  // PAD column
    const int p_end = row_ptr[row + 1];
    for (int p = row_ptr[row] + threadIdx.x; p < p_end; p += kThreads) {
      const int it = items[p];
      if (it >= 0 && it < I) atomicOr(&mask[it >> 5], 1u << (it & 31));
    }
    __syncthreads();
  }

  float vals[K];
  int idxs[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    vals[q] = -INFINITY;
    idxs[q] = INT_MAX;
  }
  const float* srow = scores + (long long)row * I;
  const unsigned char* crow = kCand ? cand_mask + (long long)row * I : nullptr;
  for (int j = threadIdx.x; j < I; j += kThreads) {
    const bool masked = kCand ? crow[j] == 0 : ((mask[j >> 5] >> (j & 31)) & 1u);
    const float v = masked ? -FLT_MAX : srow[j];
    if (better(v, j, vals[K - 1], idxs[K - 1])) {
      vals[K - 1] = v;
      idxs[K - 1] = j;
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
  }

  for (int r = 0; r < k; ++r) {
    float bv = vals[0];
    int bi = idxs[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? wv[lane] : -INFINITY;
      bi = lane < kWarps ? wi[lane] : INT_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        winner = bi;
        out[(long long)row * k + r] = bi;
      }
    }
    __syncthreads();
    if (idxs[0] == winner) {  // column ids are unique across threads
#pragma unroll
      for (int q = 0; q < K - 1; ++q) {
        vals[q] = vals[q + 1];
        idxs[q] = idxs[q + 1];
      }
      vals[K - 1] = -INFINITY;
      idxs[K - 1] = INT_MAX;
    }
  }
}

template <int K, bool kCand>
int launch(const float* scores, int B, int I, const int* row_ptr,
           const int* items, const unsigned char* cand_mask, int k, int* out,
           cudaStream_t stream) {
  const size_t smem = kCand ? 0 : (size_t)((I + 31) >> 5) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        masked_topk_kernel<K, kCand>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  masked_topk_kernel<K, kCand><<<B, kThreads, smem, stream>>>(
      scores, I, row_ptr, items, cand_mask, k, out);
  return (int)cudaGetLastError();
}

}  // namespace

// scores: [B, I] float32; row_ptr: [B + 1] CSR offsets into items; out: [B, k]
extern "C" int masked_topk(const void* scores, int B, int I,
                           const void* row_ptr, const void* items, int k,
                           void* out, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const float* s = (const float*)scores;
  const int* rp = (const int*)row_ptr;
  const int* it = (const int*)items;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 16) return launch<16, false>(s, B, I, rp, it, nullptr, k, o, st);
  if (k <= 32) return launch<32, false>(s, B, I, rp, it, nullptr, k, o, st);
  if (k <= 64) return launch<64, false>(s, B, I, rp, it, nullptr, k, o, st);
  return (int)cudaErrorInvalidValue;
}

// B10. scores: [B, C] float32; cand_mask: [B, C] bool (1 byte each); out: [B, k]
extern "C" int candidate_topk(const void* scores, int B, int C,
                              const void* cand_mask, int k, void* out,
                              void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const float* s = (const float*)scores;
  const unsigned char* cm = (const unsigned char*)cand_mask;
  int* o = (int*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 16) return launch<16, true>(s, B, C, nullptr, nullptr, cm, k, o, st);
  if (k <= 32) return launch<32, true>(s, B, C, nullptr, nullptr, cm, k, o, st);
  if (k <= 64) return launch<64, true>(s, B, C, nullptr, nullptr, cm, k, o, st);
  return (int)cudaErrorInvalidValue;
}
