// K1: pairwise gather-dot score and its row-sum backward.
//
// Replaces recbole_cdr_tpu/models/cmf.py:45-48 CMF._score (an XLA gather of
// two embedding rows, multiply, reduce) and its autodiff (XLA scatter-add of
// the row gradients into the dense [N, D] table gradients).
//
//   forward:  s[b] = <U[u_b], I[i_b]>
//   backward: dU[r] = sum over b with u_b = r of g_b * I[i_b]  (dI likewise)
//
// Bound on an H100: bytes. Each pair reads two D-value rows (2 * 256 B at
// D = 64 in float32) and does 2 D flops, about 0.25 flop per byte, far below
// the card's balance point; at a step's 16,384 pairs the bound is about a
// microsecond, under the launch's own floor.
//
// Forward. The ids are loaded first, then the rows in 16-byte loads: a pair
// takes G lanes (16 at D = 64 in float32, 8 in 16 bits), so two or four
// pairs share a warp and each row arrives in one load a lane. Each lane adds
// its VEC products in column order by fused multiply-adds, then the G lanes'
// sums are added by a shuffle tree: one summation order, fixed by D.
//
// Backward. No float atomic: every row of dU and dI is written once, by G
// lanes, as the sum of its pairs' terms g_b * other row in position order,
// each product and each add rounded to nearest (__fmul_rn, __fadd_rn: no
// multiply-add is contracted), so a row equals the plain version's
// index_add_ on the CPU, which adds in position order, and two runs are
// bit-equal. A table's rows are read in one of two forms, per table:
//   - grouped: the rows of a whole table, each with its pairs from the
//     step's plan of those ids (csrc/row_groups.cu); a row no pair names is
//     written 0, so nothing is zeroed first; a row of more than kBigTerms
//     pairs (a popular item's) is summed by a whole block, its terms'
//     products staged in shared memory and each column added up by one
//     thread in pair order, so its chain of dependent loads is cut into a
//     few chunks;
//   - positions: a sub-table whose row r the pairs r, r + N, r + 2 N, ...
//     read (N its rows, P = k N pairs): the sparse step's re-based [R, D]
//     sub-tables, one row per occurrence of the step's ids (k = 1; k = 2 for
//     a BPR user slot shared by the positive and the negative), and the
//     rows a mesh lookup gathers. No plan is built. The kernel checks every
//     pair's id against its position; if any differs, the block that
//     finishes last recomputes that table's rows by scanning all P pairs in
//     order, so a wrong promise costs time, never a wrong gradient.
//
// K1-bf16, the 16-bit form (bfloat16 tables under compute_dtype: bfloat16;
// float16 through the same template): a pair's rows are 128 bytes at D = 64,
// widened to float32 as loaded; the products and sums stay float32, the
// score is rounded once to the tables' type, and each gradient row is
// rounded once as it is written (JAX's bf16 product feeds a float32 loss;
// summing in bf16 would lose the small terms of a popular row).

#include <cuda_runtime.h>

#include "row_groups.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int VEC, typename T>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ U, const T* __restrict__ I, const int* __restrict__ u,
           const int* __restrict__ it, T* __restrict__ out, int n, int D) {
  const RowGeo geo = row_geo<VEC>(D);
  const int lane = threadIdx.x & 31, sub = lane / geo.G, gl = lane % geo.G;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * kThreads) >> 5;
  for (long long p0 = warp * geo.per_warp; p0 < n; p0 += warps * geo.per_warp) {
    const long long p = p0 + sub;
    const bool ok = p < n;
    const int ur = ok ? __ldg(u + p) : 0, ir = ok ? __ldg(it + p) : 0;
    const T* urow = U + (long long)ur * D;
    const T* irow = I + (long long)ir * D;
    float acc = 0.f;
    for (int s = 0; s < geo.steps; ++s) {
      const int d = (s * geo.G + gl) * VEC;
      if (!ok || d >= D) continue;
      float a[VEC], b[VEC];
      load_vec<VEC>(urow + d, a);
      load_vec<VEC>(irow + d, b);
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc = fmaf(a[t], b[t], acc);
    }
    for (int off = geo.G >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (ok && gl == 0) st1(out + p, acc);
  }
}

// One table's side of the backward: its rows, their form, and (grouped) the
// plan of the ids that name them.
struct Side {
  int rows;
  int positions;  // 1: row r is read by pairs r, r + rows, ...; 0: grouped
  GroupsView g;
};

// The positions form's repair, run by one block: every row of a side
// recomputed from all P pairs, those whose own id names the row, in order.
template <int VEC, typename T>
__device__ void rescan_side(int P, int rows, int D, const T* g, const int* own, const int* oth,
                            const T* src, T* out) {
  const RowGeo geo = row_geo<VEC>(D);
  const int lane = threadIdx.x & 31, sub = lane / geo.G, gl = lane % geo.G;
  const unsigned group_mask = geo.G == 32 ? 0xffffffffu : ((1u << geo.G) - 1) << (sub * geo.G);
  for (int r0 = (threadIdx.x >> 5) * geo.per_warp; r0 < rows; r0 += kWarps * geo.per_warp) {
    const int r = r0 + sub;
    for (int s = 0; s < geo.steps; ++s) {
      const int d = (s * geo.G + gl) * VEC;
      float acc[VEC];
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[t] = 0.f;
      for (int q0 = 0; q0 < P; q0 += geo.G) {
        const bool hit = r < rows && q0 + gl < P && __ldg(own + q0 + gl) == r;
        unsigned m = __ballot_sync(0xffffffffu, hit) & group_mask;
        while (m) {
          const int p = q0 + (__ffs(m) - 1) % geo.G;
          m &= m - 1;
          if (d >= D) continue;
          const float gp = ld1(g + p);
          float v[VEC];
          load_vec<VEC>(src + (long long)__ldg(oth + p) * D + d, v);
#pragma unroll
          for (int t = 0; t < VEC; ++t) acc[t] = __fadd_rn(acc[t], __fmul_rn(gp, v[t]));
        }
      }
      if (r < rows && d < D) store_vec<VEC>(out + (long long)r * D + d, acc);
    }
  }
}

// The rows a row group sums: a grouped table's heads of at most kBigTerms
// pairs (h < H, its row head_row[h]), a positions table's rows.
__device__ __forceinline__ int items_of(const Side& S) {
  return S.positions ? S.rows : __ldg(S.g.meta + 1);
}

// dU [su.rows, D] and dI [si.rows, D], every row written once, in three
// grid-stride passes: (1) the grouped tables' heads of more than kBigTerms
// pairs, a block each, first, since they take longest; (2) the other heads
// (grouped) or rows (positions), a row group each, reading the head's pairs
// from the plan; (3) the grouped tables' rows no pair names, written 0.
// guard [3]: the positions form's failed-check flag and the count of
// finished blocks (zeros, left so), then the count of rescans, which only
// grows (the wrapper reads it: a rescan costs milliseconds, so the path
// that should never take one is checked for none). ROWS: rows in flight a lane in add_terms, 16
// (8 in 16 bits) where a popular row's chain is long, 2 where every table
// is read by position (a row's pairs are one or two); at most 128
// registers (two blocks a multiprocessor), or 64 (four) for the positions
// form, whose short chains need many warps in flight.
template <int VEC, int ROWS, typename T>
__global__ void __launch_bounds__(kThreads, ROWS > 2 ? 2 : 4)
bwd_kernel(const T* __restrict__ U, const T* __restrict__ I, const int* __restrict__ u,
           const int* __restrict__ it, const T* __restrict__ g, int P, int D, Side su, Side si,
           T* __restrict__ dU, T* __restrict__ dI, int* guard) {
  extern __shared__ float smem[];
  const RowGeo geo = row_geo<VEC>(D);
  const int lane = threadIdx.x & 31, sub = lane / geo.G, gl = lane % geo.G;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * kThreads) >> 5;
  // (1)
  const int big_u = su.positions ? 0 : __ldg(su.g.meta + 2);
  const int big_i = si.positions ? 0 : __ldg(si.g.meta + 2);
  for (int b = blockIdx.x; b < big_u + big_i; b += gridDim.x) {
    const bool on_u = b < big_u;
    const GroupsView& G = on_u ? su.g : si.g;
    const int* oth = on_u ? it : u;
    const int h = __ldg(G.big + (on_u ? b : b - big_u)), st = __ldg(G.head_start + h);
    const float* sum = block_terms<VEC, true>(__ldg(G.head_len + h), [&](int k) {
      const int p = __ldg(G.pos + st + k);
      return Term{__ldg(oth + p), ld1(g + p)};
    }, on_u ? I : U, D, smem);
    T* row = (on_u ? dU : dI) + (long long)__ldg(G.head_row + h) * D;
    for (int c = threadIdx.x; c < D; c += kThreads) st1(row + c, sum[c]);
    __syncthreads();  // sum is rewritten by the next head
  }
  // (2)
  const int n_u = items_of(su), total = n_u + items_of(si);
  bool broken = false;
  for (long long w0 = warp * geo.per_warp; w0 < total; w0 += warps * geo.per_warp) {
    const long long w = w0 + sub;
    if (w >= total) continue;  // a whole row group: add_terms shuffles within it
    const bool on_u = w < n_u;
    const Side& S = on_u ? su : si;
    const int x = (int)(on_u ? w : w - n_u);
    const int* own = on_u ? u : it;
    const int* oth = on_u ? it : u;
    int r = x, n, st = 0;
    if (S.positions) {
      n = P / S.rows;
      for (int k = gl; k < n; k += geo.G) broken |= __ldg(own + r + (long long)k * S.rows) != r;
    } else {
      n = __ldg(S.g.head_len + x);
      if (n > kBigTerms) continue;  // (1)'s
      r = __ldg(S.g.head_row + x);
      st = __ldg(S.g.head_start + x);
    }
    const int rows = S.rows;
    const int* pos = S.g.pos + st;
    const bool by_position = S.positions;
    const T* src = on_u ? I : U;
    T* out = (on_u ? dU : dI) + (long long)r * D;
    for (int s = 0; s < geo.steps; ++s) {
      const int d = (s * geo.G + gl) * VEC;
      float acc[VEC];
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[t] = 0.f;
      add_terms<VEC, ROWS, true>(n, [&](int k) {
        const int p = by_position ? r + k * rows : __ldg(pos + k);
        return Term{__ldg(oth + p), ld1(g + p)};
      }, src, D, d, geo, acc);
      if (d < D) store_vec<VEC>(out + d, acc);
    }
  }
  // (3)
  const int z_u = su.positions ? 0 : su.rows, zeros = z_u + (si.positions ? 0 : si.rows);
  for (long long w0 = warp * geo.per_warp; w0 < zeros; w0 += warps * geo.per_warp) {
    const long long w = w0 + sub;
    if (w >= zeros) continue;
    const bool on_u = w < z_u;
    const int r = (int)(on_u ? w : w - z_u);
    if (head_of(on_u ? su.g : si.g, r) >= 0) continue;
    float zero[VEC];
#pragma unroll
    for (int t = 0; t < VEC; ++t) zero[t] = 0.f;
    T* out = (on_u ? dU : dI) + (long long)r * D;
    for (int s = 0; s < geo.steps; ++s) {
      const int d = (s * geo.G + gl) * VEC;
      if (d < D) store_vec<VEC>(out + d, zero);
    }
  }
  if (!su.positions && !si.positions) return;  // uniform over the grid
  __shared__ int last;
  broken = __syncthreads_or(broken);
  if (threadIdx.x == 0) {
    if (broken) atomicOr(guard, 1);
    __threadfence();
    last = atomicAdd(guard + 1, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const bool rescan = atomicAdd(guard, 0) != 0;
  if (rescan) {
    if (su.positions) rescan_side<VEC>(P, su.rows, D, g, u, it, I, dU);
    if (si.positions) rescan_side<VEC>(P, si.rows, D, g, it, u, U, dI);
  }
  __syncthreads();
  if (threadIdx.x == 0) guard[0] = 0, guard[1] = 0, guard[2] += rescan;
}

template <int VEC, typename T>
int forward_launch(const void* U, const void* I, const void* u, const void* it, void* out, int n,
                   int D, cudaStream_t st) {
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = grid_for(n, kWarps * row_geo<VEC>(D).per_warp, 16);
  if (blocks <= 0) return (int)cudaErrorInvalidDevice;
  fwd_kernel<VEC, T><<<blocks, kThreads, 0, st>>>((const T*)U, (const T*)I, (const int*)u,
                                                  (const int*)it, (T*)out, n, D);
  return (int)cudaGetLastError();
}

template <int VEC, typename T>
int backward_launch(const void* U, const void* I, const void* u, const void* it, const void* g,
                    int P, int D, const Side& su, const Side& si, void* dU, void* dI, int* guard,
                    cudaStream_t st) {
  const long long rows = (long long)su.rows + si.rows;
  if (rows == 0) return (int)cudaGetLastError();
  const bool positions = su.positions && si.positions;
  // the positions form: few blocks, each over many rows, since every block
  // ends with the promise check's fence and atomic on one counter
  const int blocks = grid_for(rows, kWarps * row_geo<VEC>(D).per_warp, positions ? 3 : 8);
  if (blocks <= 0) return (int)cudaErrorInvalidDevice;
  if (positions)  // no plan: no big head, no shared memory
    bwd_kernel<VEC, 2, T><<<blocks, kThreads, 0, st>>>(
        (const T*)U, (const T*)I, (const int*)u, (const int*)it, (const T*)g, P, D, su, si,
        (T*)dU, (T*)dI, guard);
  else
    bwd_kernel<VEC, 64 / VEC, T><<<blocks, kThreads, big_smem_bytes(D), st>>>(
        (const T*)U, (const T*)I, (const int*)u, (const int*)it, (const T*)g, P, D, su, si,
        (T*)dU, (T*)dI, guard);
  return (int)cudaGetLastError();
}

Side make_side(int rows, int positions, const void* const* plan) {
  return {rows, positions, positions ? GroupsView{} : groups_view(plan)};
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 tables, scores and gradients; vec:
// 1 when D is a multiple of the 16-byte form's values (4 float32, 8 16-bit)
// and every table and output is 16-byte aligned, else 0.
extern "C" int gather_dot_forward(const void* U, const void* I, const void* u, const void* it,
                                  void* out, int n, int D, int dtype, int vec, void* stream) {
  if (D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype * 2 + (vec != 0)) {
    case 0: return forward_launch<1, float>(U, I, u, it, out, n, D, st);
    case 1: return forward_launch<4, float>(U, I, u, it, out, n, D, st);
    case 2: return forward_launch<1, __nv_bfloat16>(U, I, u, it, out, n, D, st);
    case 3: return forward_launch<8, __nv_bfloat16>(U, I, u, it, out, n, D, st);
    case 4: return forward_launch<1, __half>(U, I, u, it, out, n, D, st);
    case 5: return forward_launch<8, __half>(U, I, u, it, out, n, D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dU [Nu, D] and dI [Ni, D] of the tables' dtype, every row written. For
// each table, positions_x 1 (its rows are positions: P a multiple of its
// rows) or 0 with plan_x the plan of its ids over its rows (meta, head_row,
// head_start, head_len, pos, row_head, big). guard: int32 [3], zeros at
// first; its first two left 0, its last the count of rescans so far.
extern "C" int gather_dot_backward(const void* U, const void* I, const void* u, const void* it,
                                   const void* g, int P, int D, int Nu, int positions_u,
                                   const void* const* plan_u, int Ni, int positions_i,
                                   const void* const* plan_i, void* dU, void* dI, void* guard,
                                   int dtype, int vec, void* stream) {
  if (D <= 0 || D > kMaxD || P < 0 || Nu < 0 || Ni < 0 || (positions_u && (Nu == 0 || P % Nu)) ||
      (positions_i && (Ni == 0 || P % Ni)))
    return (int)cudaErrorInvalidValue;
  const Side su = make_side(Nu, positions_u, plan_u), si = make_side(Ni, positions_i, plan_i);
  cudaStream_t st = (cudaStream_t)stream;
  int* gd = (int*)guard;
#define K1_BWD(V, T) backward_launch<V, T>(U, I, u, it, g, P, D, su, si, dU, dI, gd, st)
  switch (dtype * 2 + (vec != 0)) {
    case 0: return K1_BWD(1, float);
    case 1: return K1_BWD(4, float);
    case 2: return K1_BWD(1, __nv_bfloat16);
    case 3: return K1_BWD(8, __nv_bfloat16);
    case 4: return K1_BWD(1, __half);
    case 5: return K1_BWD(8, __half);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K1_BWD
}
