// B5: streaming full-sort top-k with history masking, score product included.
//
// Replaces recbole_cdr_tpu/ops/topk.py:72-205 (streaming_topk_scores,
// _stream_topk_hist_local, _stream_topk_hist_pairs,
// streaming_topk_with_history and the merge of _merge_tile_topk): for a user
// block U [B, D] against the item table T [I, D], the k best items of each
// row of U T^T, where column 0 (PAD) and each row's history items score
// finfo(float32).min and ties go to the lowest item id. The [B, I] score
// matrix is never written: at I = 1.1M and B = 2048 it would be 9 GB.
//
// Bound on an H100: operations. Each score is a D-long float32 dot product
// (2 D flops) against 4 bytes of output candidates at most, so at D = 64 the
// work is ~2 B I D flops over 67 TFLOP/s against a table read of 4 I D bytes.
// The dot products use float32 FMAs in a fixed d-order (0 .. D-1), with no
// TF32 and no bf16, so integer-valued factors score exactly.
//
// Design, two launches:
//   1. grid (user-row block of kRows rows, item chunk of kChunk items). The
//      block stages its user rows in shared memory once, marks its rows'
//      history items that fall in the chunk in a shared bitmap (one bit per
//      (row, item) of the chunk, from the block's CSR history), then walks
//      the chunk in sub-tiles of kCols items: stage the sub-tile, each thread
//      computes a 4 x 2 register tile of scores, the masked scores go to
//      shared memory, and 8 threads per row fold them into sorted register
//      top-K lists ordered by (score desc, id asc). At the chunk's end the 8
//      lists of a row merge by k rounds of an 8-lane shuffle argmax into the
//      chunk's candidates, written to cand [n_chunks, B, k].
//   2. one warp per row merges the n_chunks * k candidates by the same order
//      (each lane keeps a sorted register top-K of a strided slice, then k
//      rounds of a warp argmax) into ids [B, k] and their scores.
// A chunk with fewer than k real items pads its candidates with (-inf,
// INT_MAX), which lose to every real column; k <= I makes them unreachable.

#include <cfloat>
#include <climits>
#include <cmath>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;          // user rows per block
constexpr int kCols = 64;          // items per sub-tile
constexpr int kChunk = 8192;       // items per block (one candidate list per row)
constexpr int kGroup = kThreads / kRows;  // threads folding one row: 8
constexpr int kUPad = kRows + 4;   // user tile row stride: float4-aligned
constexpr int kTPad = kCols + 1;   // item / score tile row stride: no bank conflicts
constexpr int kMaskWords = kChunk / 32;

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

template <int K>
__device__ __forceinline__ void insert(float (&vals)[K], int (&idxs)[K], float v,
                                       int i) {
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
__device__ __forceinline__ void pop_front(float (&vals)[K], int (&idxs)[K]) {
#pragma unroll
  for (int q = 0; q < K - 1; ++q) {
    vals[q] = vals[q + 1];
    idxs[q] = idxs[q + 1];
  }
  vals[K - 1] = -INFINITY;
  idxs[K - 1] = INT_MAX;
}

size_t tile_smem_bytes(int D) {
  return sizeof(float) * ((size_t)D * kUPad + (size_t)D * kTPad + kRows * kTPad) +
         sizeof(uint32_t) * kRows * kMaskWords;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
chunk_topk_kernel(const float* __restrict__ U, const float* __restrict__ T,
                  int B, int I, int D, const int* __restrict__ row_ptr,
                  const int* __restrict__ items, int k,
                  float* __restrict__ cand_s, int* __restrict__ cand_i) {
  extern __shared__ float smem[];
  float* us = smem;                             // [D][kUPad]
  float* ts = us + (size_t)D * kUPad;           // [D][kTPad]
  float* sc = ts + (size_t)D * kTPad;           // [kRows][kTPad]
  uint32_t* hb = (uint32_t*)(sc + kRows * kTPad);  // [kRows][kMaskWords]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * kRows;
  const int lo = blockIdx.y * kChunk;
  const int hi = min(I, lo + kChunk);

  // ---- user rows (zeros past B) and the chunk's history bitmap ----------
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    us[d * kUPad + r] = (r0 + r < B) ? U[(long long)(r0 + r) * D + d] : 0.f;
  }
  for (int w = tid; w < kRows * kMaskWords; w += kThreads) hb[w] = 0u;
  __syncthreads();
  for (int r = warp; r < kRows && r0 + r < B; r += kThreads / 32) {
    const int p_end = row_ptr[r0 + r + 1];
    for (int p = row_ptr[r0 + r] + lane; p < p_end; p += 32) {
      const unsigned off = (unsigned)(items[p] - lo);
      if (off < (unsigned)kChunk)
        atomicOr(&hb[r * kMaskWords + (off >> 5)], 1u << (off & 31));
    }
  }

  float vals[K];
  int idxs[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    vals[q] = -INFINITY;
    idxs[q] = INT_MAX;
  }
  const int ty = tid >> 5;   // compute: users 4 ty .. 4 ty + 3
  const int tx = lane;       // compute: items tx and tx + 32 of the sub-tile
  const int sr = tid / kGroup;  // fold: row of the score tile
  const int sg = tid % kGroup;  // fold: columns sg, sg + 8, ...

  for (int t0 = lo; t0 < hi; t0 += kCols) {
    __syncthreads();  // the previous sub-tile's tiles are consumed
    for (int e = tid; e < kCols * D; e += kThreads) {
      const int c = e / D, d = e - c * D;
      ts[d * kTPad + c] = (t0 + c < I) ? T[(long long)(t0 + c) * D + d] : 0.f;
    }
    __syncthreads();
    float acc[4][2];
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q][0] = acc[q][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(us + d * kUPad + 4 * ty);
      const float b0 = ts[d * kTPad + tx];
      const float b1 = ts[d * kTPad + tx + 32];
      acc[0][0] = fmaf(a.x, b0, acc[0][0]);
      acc[0][1] = fmaf(a.x, b1, acc[0][1]);
      acc[1][0] = fmaf(a.y, b0, acc[1][0]);
      acc[1][1] = fmaf(a.y, b1, acc[1][1]);
      acc[2][0] = fmaf(a.z, b0, acc[2][0]);
      acc[2][1] = fmaf(a.z, b1, acc[2][1]);
      acc[3][0] = fmaf(a.w, b0, acc[3][0]);
      acc[3][1] = fmaf(a.w, b1, acc[3][1]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 4 * ty + q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = tx + 32 * h;
        const int off = t0 + c - lo;
        const bool masked = (t0 + c == 0) ||
            ((hb[r * kMaskWords + (off >> 5)] >> (off & 31)) & 1u);
        sc[r * kTPad + c] = masked ? -FLT_MAX : acc[q][h];
      }
    }
    __syncthreads();
    for (int c = sg; c < kCols && t0 + c < hi; c += kGroup)
      insert<K>(vals, idxs, sc[sr * kTPad + c], t0 + c);
  }

  // ---- the chunk's candidates: k rounds of an 8-lane argmax per row -----
  const int row = r0 + sr;
  float* out_s = cand_s + ((long long)blockIdx.y * B + row) * k;
  int* out_i = cand_i + ((long long)blockIdx.y * B + row) * k;
  for (int r = 0; r < k; ++r) {
    float bv = vals[0];
    int bi = idxs[0];
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (sg == 0 && row < B) {
      out_s[r] = bv;
      out_i[r] = bi;
    }
    if (idxs[0] == bi) pop_front<K>(vals, idxs);
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ cand_s, const int* __restrict__ cand_i,
             int B, int n_chunks, int k, float* __restrict__ out_s,
             int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= B) return;  // uniform across the warp
  float vals[K];
  int idxs[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    vals[q] = -INFINITY;
    idxs[q] = INT_MAX;
  }
  const int n = n_chunks * k;
  for (int q = lane; q < n; q += 32) {
    const int chunk = q / k;
    const long long at = ((long long)chunk * B + row) * k + (q - chunk * k);
    insert<K>(vals, idxs, cand_s[at], cand_i[at]);
  }
  for (int r = 0; r < k; ++r) {
    float bv = vals[0];
    int bi = idxs[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      out_s[(long long)row * k + r] = bv;
      out_i[(long long)row * k + r] = bi;
    }
    if (idxs[0] == bi) pop_front<K>(vals, idxs);
  }
}

template <int K>
int launch(const float* U, const float* T, int B, int I, int D,
           const int* row_ptr, const int* items, int k, float* cand_s,
           int* cand_i, float* out_s, int* out_i, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(
      chunk_topk_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_chunks = (I + kChunk - 1) / kChunk;
  const dim3 grid((B + kRows - 1) / kRows, n_chunks);
  chunk_topk_kernel<K><<<grid, kThreads, smem, stream>>>(
      U, T, B, I, D, row_ptr, items, k, cand_s, cand_i);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rows_per_block = kThreads / 32;
  merge_kernel<K><<<(B + rows_per_block - 1) / rows_per_block, kThreads, 0,
                    stream>>>(cand_s, cand_i, B, n_chunks, k, out_s, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int streaming_topk_chunk() { return kChunk; }

// U: [B, D], T: [I, D] float32; row_ptr: [B + 1] CSR offsets into items;
// cand_s / cand_i: [ceil(I / chunk), B, k] scratch; out_s / out_i: [B, k]
extern "C" int streaming_topk(const void* U, const void* T, int B, int I, int D,
                              const void* row_ptr, const void* items, int k,
                              void* cand_s, void* cand_i, void* out_s,
                              void* out_i, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const float* u = (const float*)U;
  const float* t = (const float*)T;
  const int* rp = (const int*)row_ptr;
  const int* it = (const int*)items;
  float* cs = (float*)cand_s;
  int* ci = (int*)cand_i;
  float* os = (float*)out_s;
  int* oi = (int*)out_i;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 16) return launch<16>(u, t, B, I, D, rp, it, k, cs, ci, os, oi, st);
  if (k <= 32) return launch<32>(u, t, B, I, D, rp, it, k, cs, ci, os, oi, st);
  if (k <= 64) return launch<64>(u, t, B, I, D, rp, it, k, cs, ci, os, oi, st);
  return (int)cudaErrorInvalidValue;
}
