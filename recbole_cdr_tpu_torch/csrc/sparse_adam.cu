// B6: SparseAdam row update of one embedding table (torch.optim.SparseAdam).
//
// Replaces recbole_cdr_tpu/trainer/trainer.py:274-311 SparseAdam.row_update
// (XLA scatter-min, scatter-add, gathers and scatters over the touched rows).
// g[j] is the gradient of row ids[j]; duplicate ids are coalesced by
// summation, then every touched row r takes one lazy Adam step:
//   mu[r] = b1 mu[r] + (1 - b1) g_r,   nu[r] = b2 nu[r] + (1 - b2) g_r g_r
//   p[r] += (-step_size) mu[r] / (sqrt(nu[r]) + eps)
// with step_size = lr sqrt(1 - b2^c) / (1 - b1^c) computed by the caller in
// float32. Rows that no id touches are not read or written.
//
// Row-shard form (a table row-sharded over a mesh's model axis): the table
// passed in is one shard, global rows [row_offset, row_offset + L), and the
// step's ids are the GLOBAL rows of every occurrence, every data rank's
// (parallel/mesh.py::Mesh.gather_occurrences, padded with ids past every
// shard). The plan of those ids over the shard's rows leaves out every
// occurrence outside them, so each rank walks its own rows' occurrences
// only. row_offset = 0 with L = N is the whole table.
//
// Bound on an H100: bytes. Per touched row the step reads p, mu, nu and
// writes them back (6 D floats) plus its gradient rows; about 2 flops per
// byte.
//
// Design: one launch over the step's plan (csrc/row_groups.cu: each touched
// row and its occurrences' positions, ascending; built by the caller, O(R)
// with no pass over the table). G lanes a touched row (16 at D = 64: two rows
// a warp), in 16-byte loads, add its occurrences' gradient rows in position
// order (the order of the plain version's index_add_ on the CPU and of
// torch's coalesce), then take the Adam step on p, mu and nu in registers;
// a row of more than kBigTerms occurrences is summed by a whole block
// (block_terms), then stepped a column a thread.
// No float atomic, no [R, D] accumulator, no zero fill: two runs are
// bit-equal. The arithmetic uses round-to-nearest intrinsics, so no
// multiply-add is contracted and each operation rounds as torch's (and
// XLA's) separate elementwise ops do.

#include <cuda_runtime.h>

#include "row_groups.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// one element's Adam step from its coalesced gradient gc, in place
__device__ __forceinline__ void adam(float& p, float& mu, float& nu, float gc, float neg_step,
                                     float b1, float omb1, float b2, float omb2, float eps) {
  const float m = __fadd_rn(__fmul_rn(b1, mu), __fmul_rn(omb1, gc));
  const float v = __fadd_rn(__fmul_rn(b2, nu), __fmul_rn(__fmul_rn(omb2, gc), gc));
  p = __fadd_rn(p, __fdiv_rn(__fmul_rn(neg_step, m), __fadd_rn(__fsqrt_rn(v), eps)));
  mu = m;
  nu = v;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
adam_kernel(float* __restrict__ p, float* __restrict__ mu, float* __restrict__ nu,
            const float* __restrict__ g, int D, GroupsView gr, float neg_step, float b1,
            float omb1, float b2, float omb2, float eps) {
  extern __shared__ float smem[];
  const RowGeo geo = row_geo<VEC>(D);
  const int lane = threadIdx.x & 31, sub = lane / geo.G, gl = lane % geo.G;
  const int H = __ldg(gr.meta + 1);
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * kThreads) >> 5;
  for (long long h0 = warp * geo.per_warp; h0 < H; h0 += warps * geo.per_warp) {
    const int h = (int)(h0 + sub);
    if (h >= H) continue;  // a whole row group: add_terms shuffles within it
    const long long row = (long long)__ldg(gr.head_row + h) * D;
    const int st = __ldg(gr.head_start + h), n = __ldg(gr.head_len + h);
    if (n > kBigTerms) continue;  // a block's, below
    for (int s = 0; s < geo.steps; ++s) {
      const int d = (s * geo.G + gl) * VEC;
      float gc[VEC];
#pragma unroll
      for (int t = 0; t < VEC; ++t) gc[t] = 0.f;
      // a head's occurrences are few (more go to a block): 4 rows in flight
      add_terms<VEC, 4, false>(n, [&](int k) { return Term{__ldg(gr.pos + st + k), 1.f}; }, g,
                               D, d, geo, gc);
      if (d >= D) continue;
      float pv[VEC], mv[VEC], nv[VEC];
      load_vec<VEC>(p + row + d, pv);
      load_vec<VEC>(mu + row + d, mv);
      load_vec<VEC>(nu + row + d, nv);
#pragma unroll
      for (int t = 0; t < VEC; ++t)
        adam(pv[t], mv[t], nv[t], gc[t], neg_step, b1, omb1, b2, omb2, eps);
      store_vec<VEC>(p + row + d, pv);
      store_vec<VEC>(mu + row + d, mv);
      store_vec<VEC>(nu + row + d, nv);
    }
  }
  // the heads of more than kBigTerms occurrences, a block each
  const int n_big = __ldg(gr.meta + 2);
  for (int b = blockIdx.x; b < n_big; b += gridDim.x) {
    const int h = __ldg(gr.big + b), st = __ldg(gr.head_start + h);
    const float* gc = block_terms<VEC, false>(
        __ldg(gr.head_len + h), [&](int k) { return Term{__ldg(gr.pos + st + k), 1.f}; }, g, D,
        smem);
    const long long row = (long long)__ldg(gr.head_row + h) * D;
    for (int c = threadIdx.x; c < D; c += kThreads)
      adam(p[row + c], mu[row + c], nu[row + c], gc[c], neg_step, b1, omb1, b2, omb2, eps);
    __syncthreads();  // gc is rewritten by the next head
  }
}

template <int VEC>
int launch(float* p, float* mu, float* nu, const float* g, int R, int D, const GroupsView& gr,
           float neg_step, float b1, float omb1, float b2, float omb2, float eps,
           cudaStream_t st) {
  // at most R heads; the kernel reads how many there are
  const int blocks = grid_for(R, kWarps * row_geo<VEC>(D).per_warp, 8);
  if (blocks <= 0) return (int)cudaErrorInvalidDevice;
  adam_kernel<VEC><<<blocks, kThreads, big_smem_bytes(D), st>>>(p, mu, nu, g, D, gr, neg_step,
                                                                b1, omb1, b2, omb2, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// p, mu, nu: [L, D] float32, the shard's rows, updated in place; g: [R, D]
// the occurrences' gradient rows; plan: the plan of the occurrences' ids over
// the shard's rows (meta, head_row, head_start, head_len, pos, row_head, big;
// csrc/row_groups.cu). vec: 1 when D % 4 == 0 and p, mu, nu, g are 16-byte
// aligned, else 0.
extern "C" int sparse_adam(void* p, void* mu, void* nu, const void* g, int R, int D,
                           const void* const* plan, float step_size, float b1, float omb1,
                           float b2, float omb2, float eps, int vec, void* stream) {
  if (D <= 0 || D > kMaxD || R < 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaGetLastError();
  const GroupsView gr = groups_view(plan);
  cudaStream_t st = (cudaStream_t)stream;
  return vec ? launch<4>((float*)p, (float*)mu, (float*)nu, (const float*)g, R, D, gr,
                         -step_size, b1, omb1, b2, omb2, eps, st)
             : launch<1>((float*)p, (float*)mu, (float*)nu, (const float*)g, R, D, gr,
                         -step_size, b1, omb1, b2, omb2, eps, st);
}
