// B6: SparseAdam row update of one embedding table (torch.optim.SparseAdam).
//
// Replaces recbole_cdr_tpu/trainer/trainer.py:274-311 SparseAdam.row_update
// (XLA scatter-min, scatter-add, gathers and scatters over the touched rows).
// g[j] is the gradient of row ids[j]; duplicate ids are coalesced by summing
// into the slot of their first occurrence ("head"), then every head row r
// takes one lazy Adam step:
//   mu[r] = b1 mu[r] + (1 - b1) g_r,   nu[r] = b2 nu[r] + (1 - b2) g_r g_r
//   p[r] += (-step_size) mu[r] / (sqrt(nu[r]) + eps)
// with step_size = lr sqrt(1 - b2^c) / (1 - b1^c) computed by the caller in
// float32. Rows that no id touches are not read or written.
//
// Bound on an H100: bytes. Per touched row the step reads p, mu, nu and
// writes them back (6 D floats) plus its gradient rows; about 2 flops per
// byte. Design, three launches, all O(R) with no O(N) pass:
//   1. one thread per occurrence: atomicMin of its position into firstpos[id]
//      (an [N] int32 scratch the caller keeps filled with INT_MAX);
//   2. one warp per occurrence: atomicAdd of its gradient row into the [R, D]
//      accumulator slot of its head (the caller zeroes it). Duplicates add in
//      a run-dependent order, so a coalesced row's last bits vary between
//      runs; a row touched once is exact;
//   3. one warp per occurrence: heads update their row in place and reset
//      firstpos[id] to INT_MAX, so the scratch is ready for the next step
//      without an O(N) fill. A non-head reads either its head's position or
//      INT_MAX, never its own position, so the reset cannot race.
// The arithmetic uses round-to-nearest intrinsics, so no multiply-add is
// contracted and each operation rounds as torch's (and XLA's) separate
// elementwise ops do.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void first_position_kernel(const int* __restrict__ ids,
                                      int* __restrict__ firstpos, int R) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j < R) atomicMin(firstpos + ids[j], j);
}

__global__ void coalesce_kernel(const float* __restrict__ g,
                                const int* __restrict__ ids,
                                const int* __restrict__ firstpos,
                                float* __restrict__ acc, int R, int D) {
  const long long j = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= R) return;  // uniform across the warp
  const long long fp = firstpos[ids[j]];
  for (int d = lane; d < D; d += 32)
    atomicAdd(acc + fp * D + d, g[j * D + d]);
}

__global__ void row_update_kernel(float* __restrict__ p, float* __restrict__ mu,
                                  float* __restrict__ nu,
                                  const int* __restrict__ ids,
                                  int* __restrict__ firstpos,
                                  const float* __restrict__ acc, int R, int D,
                                  float neg_step, float b1, float omb1,
                                  float b2, float omb2, float eps) {
  const long long j = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= R) return;
  const int id = ids[j];
  const bool head = firstpos[id] == j;
  __syncwarp();  // every lane has read firstpos before the head resets it
  if (!head) return;
  const long long row = (long long)id * D;
  for (int d = lane; d < D; d += 32) {
    const float gc = acc[j * D + d];
    const float m = __fadd_rn(__fmul_rn(b1, mu[row + d]), __fmul_rn(omb1, gc));
    const float v = __fadd_rn(__fmul_rn(b2, nu[row + d]),
                              __fmul_rn(__fmul_rn(omb2, gc), gc));
    const float upd = __fdiv_rn(__fmul_rn(neg_step, m),
                                __fadd_rn(__fsqrt_rn(v), eps));
    p[row + d] = __fadd_rn(p[row + d], upd);
    mu[row + d] = m;
    nu[row + d] = v;
  }
  if (lane == 0) firstpos[id] = INT_MAX;
}

}  // namespace

// p, mu, nu: [N, D] float32, updated in place; g: [R, D]; ids: [R] in
// [0, N); firstpos: [N] int32 holding INT_MAX (left so); acc: [R, D] zeros
extern "C" int sparse_adam(void* p, void* mu, void* nu, const void* g,
                           const void* ids, void* firstpos, void* acc, int R,
                           int D, float step_size, float b1, float omb1,
                           float b2, float omb2, float eps, void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int* id = (const int*)ids;
  int* fp = (int*)firstpos;
  first_position_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      id, fp, R);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const unsigned warp_blocks = (unsigned)((R + kWarps - 1) / kWarps);
  coalesce_kernel<<<warp_blocks, kThreads, 0, st>>>(
      (const float*)g, id, fp, (float*)acc, R, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  row_update_kernel<<<warp_blocks, kThreads, 0, st>>>(
      (float*)p, (float*)mu, (float*)nu, id, fp, (const float*)acc, R, D,
      -step_size, b1, omb1, b2, omb2, eps);
  return (int)cudaGetLastError();
}
