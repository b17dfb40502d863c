// The grouping of a step's ids by row ("the plan"), and the row-sharded
// lookup's backward, a fixed-order row sum over it.
//
// The plan is what the fixed-order sums read: for each distinct row a step's
// ids name ("head"), its occurrences' positions in ascending order (layout in
// row_groups.cuh). K1's backward (csrc/gather_dot.cu) sums each table row's
// pair terms over it, B6 (csrc/sparse_adam.cu) each touched row's gradient
// rows, row_sum below the lookup's gradient rows. JAX has no such program:
// XLA groups inside its scatter-add (recbole_cdr_tpu/models/cmf.py:45-48's
// autodiff) and its scatter-min (recbole_cdr_tpu/trainer/trainer.py:
// 274-311). It replaces the float atomics that made those sums run in an
// order that changed from run to run.
//
// Bound on an H100: neither bytes nor operations. It reads R ids and writes
// about 2 R ints, 0.1 microseconds of memory traffic at a step's 16,384 ids;
// its time is latency: four dependent rounds of loads and integer atomics.
//
// Design. Integer work only, O(R) per step: nothing grows with the table's
// rows L, which may be 1.1M (the catalog's item table). Two int32 arrays of
// L stay with the table from step to step: cnt, all zero between calls, and
// row_head, whose stale entries its consumers reject (row_groups.cuh). One
// launch of thread-block clusters, one cluster a grouping (a second
// grouping, K1's item ids, in a second cluster of the same launch), a block
// for every 1,024 ids up to 16 blocks (one id a thread at a catalog step's
// 16,384), the four rounds split by cluster barriers:
//   A. each occurrence takes a ticket from its row's counter (atomicAdd on
//      cnt[r]);
//   B. the occurrence with ticket 0 claims its row: it reads the row's count,
//      clears the counter, and takes a head index and a range of pos; a
//      block's claims are scanned in shared memory and taken with one 64-bit
//      atomic (heads and positions together, so a block's heads own
//      consecutive ranges); a head of more than kBigTerms positions is also
//      listed in big, for the consumers' block path;
//   C. each occurrence is placed in its head's range at its ticket;
//   D. each occurrence is moved to its place in position order, the number
//      of its range's smaller positions, which a thread counts in its
//      range, or, for a head of more than kBigTerms positions (a popular
//      item's hundreds), a block counts through shared memory.
// Tickets and claims depend on the arrival order, so the heads' order and
// the placing in C do too; D's order does not. Every sum that reads the plan
// runs over a head's positions in D's order.
//
// row_sum: out[r] = the lookup's gradient rows of the positions of row r,
// added in float32 in position order and rounded once to the output's type
// (what index_add_ computes on the CPU, 16-bit rows included); 0 for a row
// no id names. Bytes bound: it reads the own positions' rows once and writes
// every row.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_groups.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;  // Hopper's largest cluster (8 is the portable size)
constexpr int kRankChunk = 4096;  // a big head's positions in shared memory at a time

// One grouping's operands: ids [R] over rows [offset, offset + L); cnt and
// row_head [L] kept; meta [4], head_row, head_start, head_len, pos, big [R]
// out; tick, tmp [R] scratch.
struct Set {
  const int* ids;
  int R, L, offset;
  int* cnt;
  int* row_head;
  int* meta;
  int* head_row;
  int* head_start;
  int* head_len;
  int* pos;
  int* big;
  int* tick;
  int* tmp;
};

__device__ __forceinline__ int local_row(const Set& s, int j) {
  const long long r = (long long)__ldg(s.ids + j) - s.offset;
  return r >= 0 && r < s.L ? (int)r : -1;
}

// block-wide exclusive scan of (a, b) over kThreads threads; returns the
// block's totals
__device__ __forceinline__ int2 block_scan(int& a, int& b, int2* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = a, y = b;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int px = __shfl_up_sync(0xffffffffu, x, off), py = __shfl_up_sync(0xffffffffu, y, off);
    if (lane >= off) x += px, y += py;
  }
  if (lane == 31) warp_tot[warp] = make_int2(x, y);
  __syncthreads();
  int2 before = make_int2(0, 0), total = make_int2(0, 0);
  for (int w = 0; w < kWarps; ++w) {
    const int2 t = warp_tot[w];
    if (w < warp) before.x += t.x, before.y += t.y;
    total.x += t.x, total.y += t.y;
  }
  a = before.x + x - a;
  b = before.y + y - b;
  __syncthreads();
  return total;
}

// the cluster's barrier (arrive with release, wait with acquire semantics at
// cluster scope), after which every block sees every block's writes; the
// reads of another block's writes go through L2 (__ldcg)
__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cluster) { cluster.sync(); }

// grid (cluster, sets), clusters of all gridDim.x blocks along x: cluster y
// builds the grouping of set y
__global__ void __launch_bounds__(kThreads) plan_kernel(Set s0, Set s1) {
  __shared__ int2 warp_tot[kWarps];
  __shared__ unsigned long long base;
  cg::cluster_group cluster = cg::this_cluster();
  const Set s = blockIdx.y ? s1 : s0;
  const int tid = threadIdx.x;
  const int first = (int)cluster.block_rank() * kThreads;
  const int stride = (int)cluster.num_blocks() * kThreads;
  // A: tickets
  for (int j = first + tid; j < s.R; j += stride) {
    const int r = local_row(s, j);
    s.tick[j] = r >= 0 ? atomicAdd(s.cnt + r, 1) : -1;
  }
  if (first == 0 && tid == 0) *reinterpret_cast<unsigned long long*>(s.meta) = 0ull, s.meta[2] = 0;
  cluster_barrier(cluster);
  // B: claims (the loop runs the same count on every thread of a block)
  for (int j0 = first; j0 < s.R; j0 += stride) {
    const int j = j0 + tid;
    int r = -1, n = 0;
    if (j < s.R && s.tick[j] == 0) {
      r = local_row(s, j);
      n = __ldcg(s.cnt + r);
      s.cnt[r] = 0;
    }
    int h = r >= 0, q = n;
    const int2 tot = block_scan(h, q, warp_tot);
    if (tid == 0 && tot.x)  // meta[0]: positions taken, meta[1]: heads
      base = atomicAdd(reinterpret_cast<unsigned long long*>(s.meta),
                       (unsigned long long)tot.x << 32 | (unsigned)tot.y);
    __syncthreads();
    if (r >= 0) {
      h += (int)(base >> 32);
      q += (int)(base & 0xFFFFFFFFu);
      s.head_row[h] = r;
      s.head_start[h] = q;
      s.head_len[h] = n;
      s.row_head[r] = h;
      if (n > kBigTerms) s.big[atomicAdd(s.meta + 2, 1)] = h;
    }
    __syncthreads();  // base is rewritten by the next round
  }
  cluster_barrier(cluster);
  // C: each occurrence into its head's range at its ticket; tick becomes its head
  for (int j = first + tid; j < s.R; j += stride) {
    const int t = s.tick[j];
    if (t < 0) continue;
    const int h = __ldcg(s.row_head + local_row(s, j));
    s.tmp[__ldcg(s.head_start + h) + t] = j;
    s.tick[j] = h;
  }
  cluster_barrier(cluster);
  // D: position order; a head of more than kBigTerms positions by a block,
  // its range read through shared memory kRankChunk at a time
  for (int j = first + tid; j < s.R; j += stride) {
    const int h = s.tick[j];
    if (h < 0) continue;
    const int st = __ldcg(s.head_start + h), n = __ldcg(s.head_len + h);
    if (n > kBigTerms) continue;
    int rank = 0;
    for (int k = st; k < st + n; ++k) rank += __ldcg(s.tmp + k) < j;
    s.pos[st + rank] = j;
  }
  __shared__ int chunk[kRankChunk];
  const int n_big = __ldcg(s.meta + 2);
  for (int b = (int)cluster.block_rank(); b < n_big; b += (int)cluster.num_blocks()) {
    const int h = __ldcg(s.big + b), st = __ldcg(s.head_start + h), n = __ldcg(s.head_len + h);
    for (int e0 = 0; e0 < n; e0 += kThreads) {
      const int mine = e0 + tid < n ? __ldcg(s.tmp + st + e0 + tid) : 0;
      int rank = 0;
      for (int c0 = 0; c0 < n; c0 += kRankChunk) {
        const int m = n - c0 < kRankChunk ? n - c0 : kRankChunk;
        __syncthreads();  // the chunk's previous contents are read
        for (int t = tid; t < m; t += kThreads) chunk[t] = __ldcg(s.tmp + st + c0 + t);
        __syncthreads();
        if (e0 + tid < n)
          for (int t = 0; t < m; ++t) rank += chunk[t] < mine;
      }
      if (e0 + tid < n) s.pos[st + rank] = mine;
    }
  }
}

// out [L, D] of T: row r the positions' rows of src [R, D] added in order in
// float32, rounded once to T; the heads of more than kBigTerms positions by
// a block each, after the rows
template <int VEC, typename T>
__global__ void __launch_bounds__(256) row_sum_kernel(const T* __restrict__ src, int L, int D,
                                                      GroupsView g, T* __restrict__ out) {
  extern __shared__ float smem[];
  const RowGeo geo = row_geo<VEC>(D);
  const int lane = threadIdx.x & 31, sub = lane / geo.G, gl = lane % geo.G;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long r0 = warp * geo.per_warp; r0 < L; r0 += warps * geo.per_warp) {
    const int r = (int)(r0 + sub);
    if (r >= L) continue;  // a whole row group: add_terms shuffles within it
    const int h = head_of(g, r);
    const int st = h < 0 ? 0 : __ldg(g.head_start + h), n = h < 0 ? 0 : __ldg(g.head_len + h);
    if (n > kBigTerms) continue;
    for (int s = 0; s < geo.steps; ++s) {
      const int d = (s * geo.G + gl) * VEC;
      float acc[VEC];
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[t] = 0.f;
      add_terms<VEC, 4, false>(n, [&](int k) { return Term{__ldg(g.pos + st + k), 1.f}; }, src,
                               D, d, geo, acc);
      if (d < D) store_vec<VEC>(out + (long long)r * D + d, acc);
    }
  }
  const int n_big = __ldg(g.meta + 2);
  for (int i = blockIdx.x; i < n_big; i += gridDim.x) {
    const int h = __ldg(g.big + i), st = __ldg(g.head_start + h);
    const float* sum = block_terms<VEC, false>(
        __ldg(g.head_len + h), [&](int k) { return Term{__ldg(g.pos + st + k), 1.f}; }, src, D,
        smem);
    T* row = out + (long long)__ldg(g.head_row + h) * D;
    for (int c = threadIdx.x; c < D; c += blockDim.x) st1(row + c, sum[c]);
    __syncthreads();  // sum is rewritten by the next head
  }
}

template <int VEC, typename T>
int row_sum_launch(const void* src, int L, int D, const GroupsView& g, void* out,
                   cudaStream_t st) {
  const RowGeo geo = row_geo<VEC>(D);
  const int blocks = grid_for(L, 8 * geo.per_warp, 8);
  if (blocks <= 0) return (int)cudaErrorInvalidDevice;
  row_sum_kernel<VEC, T><<<blocks, 256, big_smem_bytes(D), st>>>((const T*)src, L, D, g,
                                                                 (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// The plans of `sets` (1 or 2) id tensors in one launch. Each set: ids [R]
// int32 over rows [offset, offset + L) and bufs, ten int32 arrays: cnt [L]
// zeros (left so) and row_head [L] (any contents) kept by the caller; meta
// [4] (8-byte aligned), head_row, head_start, head_len, pos, big [R] out;
// tick, tmp [R] scratch. Set 1's pointers are read only when sets is 2.
extern "C" int row_groups_plan(int sets, const void* ids0, int R0, int L0, int offset0,
                               void* const* bufs0, const void* ids1, int R1, int L1,
                               int offset1, void* const* bufs1, void* stream) {
  if (sets < 1 || sets > 2 || R0 < 0 || L0 < 0 || (sets == 2 && (R1 < 0 || L1 < 0)))
    return (int)cudaErrorInvalidValue;
  auto make = [](const void* ids, int R, int L, int offset, void* const* b) {
    return Set{(const int*)ids, R, L, offset, (int*)b[0], (int*)b[1], (int*)b[2], (int*)b[3],
               (int*)b[4], (int*)b[5], (int*)b[6], (int*)b[7], (int*)b[8], (int*)b[9]};
  };
  Set s0 = make(ids0, R0, L0, offset0, bufs0);
  Set s1 = sets == 2 ? make(ids1, R1, L1, offset1, bufs1) : s0;
  const int R = sets == 2 && R1 > R0 ? R1 : R0;
  int cluster = (R + kThreads - 1) / kThreads;
  cluster = cluster < 1 ? 1 : cluster > kMaxCluster ? kMaxCluster : cluster;
  if (cluster > 8 && cudaFuncSetAttribute(
                         plan_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
                         cudaSuccess) {
    cudaGetLastError();  // the portable size then
    cluster = 8;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, sets);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, plan_kernel, s0, s1);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The row-sharded lookup's backward: out [L, D] of dtype (0 float32, 1
// bfloat16, 2 float16), every row written, from src [R, D] of the same type
// and the plan of the lookup's ids over the shard (its seven arrays: meta,
// head_row, head_start, head_len, pos, row_head, big). vec: 1 when D is a
// multiple of the 16-byte form's values and src and out are 16-byte
// aligned, else 0.
extern "C" int row_sum(const void* src, int L, int D, int dtype, int vec,
                       const void* const* plan, void* out, void* stream) {
  if (L < 0 || D <= 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  if (L == 0) return (int)cudaGetLastError();
  const GroupsView g = groups_view(plan);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype * 2 + (vec != 0)) {
    case 0: return row_sum_launch<1, float>(src, L, D, g, out, st);
    case 1: return row_sum_launch<4, float>(src, L, D, g, out, st);
    case 2: return row_sum_launch<1, __nv_bfloat16>(src, L, D, g, out, st);
    case 3: return row_sum_launch<8, __nv_bfloat16>(src, L, D, g, out, st);
    case 4: return row_sum_launch<1, __half>(src, L, D, g, out, st);
    case 5: return row_sum_launch<8, __half>(src, L, D, g, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
