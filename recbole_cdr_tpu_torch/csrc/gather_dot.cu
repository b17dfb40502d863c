// K1: pairwise gather-dot score and its scatter-add backward.
//
// Replaces recbole_cdr_tpu/models/cmf.py:45-48 CMF._score (an XLA gather of
// two embedding rows, multiply, reduce) and its autodiff (XLA scatter-add of
// the row gradients into the dense [N, D] table gradients).
//
//   forward:  s[b] = <U[u_b], I[i_b]>
//   backward: dU[u_b] += g_b * I[i_b],  dI[i_b] += g_b * U[u_b]
//
// Bound on an H100: bytes. Each pair reads two D-float rows (2 * 256 B at
// D = 64) and does 2 * D flops, about 0.25 flop per byte, far below the
// card's ~20 flop/byte float32 balance point. Design: one warp per pair so a
// row is read as one coalesced 256-byte segment; the dot is a lane-local
// partial sum plus a shuffle reduction, with no shared memory. The backward
// walks the same layout and adds with atomicAdd into zeroed dense gradients,
// so the order of the sums (and the last bits of a row that several pairs
// share) changes from run to run. Pairs with a zero upstream gradient (padded
// batch rows) are skipped: adding zero is a no-op.

// K1-bf16, the 16-bit form (bfloat16 tables under compute_dtype: bfloat16;
// float16 through the same template): a pair's rows are 128 bytes at D = 64,
// half the float32 form's, loaded as 16-bit values and widened to float32;
// the products (exact in float32 for bf16 x bf16) and their sum stay float32
// and the score is rounded once to the tables' type, where JAX rounds the
// bf16 product before its float32 loss. The backward adds the row gradients
// into float32 tables by atomics (the wrapper rounds them to the tables'
// type once at the end): summing in bf16 would lose the small terms of a
// popular row.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float x) { return __float2half_rn(x); }

template <typename T>
__global__ void gather_dot_fwd_kernel(const T* __restrict__ U,
                                      const T* __restrict__ I,
                                      const int* __restrict__ u,
                                      const int* __restrict__ it,
                                      T* __restrict__ out, int n, int D) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n) return;  // uniform across the warp
  const T* ur = U + (long long)u[warp] * D;
  const T* ir = I + (long long)it[warp] * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(widen(ur[d]), widen(ir[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[warp] = narrow<T>(acc);
}

template <typename T>
__global__ void gather_dot_bwd_kernel(const T* __restrict__ U,
                                      const T* __restrict__ I,
                                      const int* __restrict__ u,
                                      const int* __restrict__ it,
                                      const T* __restrict__ g,
                                      float* __restrict__ dU,
                                      float* __restrict__ dI, int n, int D) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n) return;
  const float gb = widen(g[warp]);
  if (gb == 0.f) return;
  const long long uo = (long long)u[warp] * D;
  const long long io = (long long)it[warp] * D;
  for (int d = lane; d < D; d += 32) {
    atomicAdd(dU + uo + d, gb * widen(I[io + d]));
    atomicAdd(dI + io + d, gb * widen(U[uo + d]));
  }
}

constexpr int kThreads = 256;  // 8 pairs per block

unsigned blocks_for(int n) { return (unsigned)(((long long)n * 32 + kThreads - 1) / kThreads); }

template <typename T>
int forward_launch(const void* U, const void* I, const void* u, const void* it, void* out,
                   int n, int D, cudaStream_t stream) {
  if (n > 0)
    gather_dot_fwd_kernel<T><<<blocks_for(n), kThreads, 0, stream>>>(
        (const T*)U, (const T*)I, (const int*)u, (const int*)it, (T*)out, n, D);
  return (int)cudaGetLastError();
}

template <typename T>
int backward_launch(const void* U, const void* I, const void* u, const void* it,
                    const void* g, void* dU, void* dI, int n, int D, cudaStream_t stream) {
  if (n > 0)
    gather_dot_bwd_kernel<T><<<blocks_for(n), kThreads, 0, stream>>>(
        (const T*)U, (const T*)I, (const int*)u, (const int*)it, (const T*)g, (float*)dU,
        (float*)dI, n, D);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 tables, scores and gradient (dU, dI zeroed float32
// tables); 1 bfloat16 and 2 float16 tables, scores and gradient, dU and dI
// zeroed float32 scratch tables
extern "C" int gather_dot_forward(const void* U, const void* I, const void* u,
                                  const void* it, void* out, int n, int D, int dtype,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return forward_launch<float>(U, I, u, it, out, n, D, st);
  if (dtype == 1) return forward_launch<__nv_bfloat16>(U, I, u, it, out, n, D, st);
  if (dtype == 2) return forward_launch<__half>(U, I, u, it, out, n, D, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int gather_dot_backward(const void* U, const void* I, const void* u,
                                   const void* it, const void* g, void* dU, void* dI,
                                   int n, int D, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return backward_launch<float>(U, I, u, it, g, dU, dI, n, D, st);
  if (dtype == 1) return backward_launch<__nv_bfloat16>(U, I, u, it, g, dU, dI, n, D, st);
  if (dtype == 2) return backward_launch<__half>(U, I, u, it, g, dU, dI, n, D, st);
  return (int)cudaErrorInvalidValue;
}
