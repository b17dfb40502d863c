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
// its time is latency: dependent rounds of loads and integer atomics.
//
// Design. Integer work only, O(R) per step: nothing grows with the table's
// rows L, which may be 1.1M (the catalog's item table). row_head [L] stays
// with the table from step to step; its stale entries its consumers reject
// (row_groups.cuh). One launch of thread-block clusters, one cluster a
// grouping (a second grouping, K1's item ids, in a second cluster of the same
// launch), a block for every kThreads ids up to kMaxCluster blocks.
//
// Up to kInboxMax ids (one a thread: every step of the training paths), the
// inboxes (inbox_kernel), two cluster barriers apart:
//   1. each id's key (local row, position) goes to the block that owns its
//      row (a hash of the row), into that block's inbox in shared memory,
//      through distributed shared memory: a block takes its slots in an
//      owner's inbox with one remote atomic per owner, so the keys arrive
//      in no set order;
//   2. each block groups its keys by row in a hash table in shared memory,
//      each key taking a ticket from its row's count; the first ticket
//      claims the row's head, the block's heads and positions taken with one
//      64-bit atomic (a head of more than kBigTerms positions is also listed
//      in big, for the consumers' block path); a head of one position is
//      placed, the others' positions listed at their tickets and each placed
//      at its rank among its head's. An inbox of more than kHashMax keys (a
//      step whose ids crowd one owner) is sorted instead (bitonic): a row's
//      keys come together, positions ascending, and the sorted keys are the
//      block's part of pos as they stand.
// An inbox holds every id of the step (all may name one row), so a block's
// shared memory bounds R. Above it the four rounds (rounds_kernel), split by
// cluster barriers, with one more array kept per table (cnt [L], zero
// between calls) and two of R (tick, tmp). At phase 2's catalog and dense
// steps the inboxes take about three quarters of the four rounds' time
// (probe_row_groups.py): their routing and two barriers cost about what
// the four rounds' first round does, and the rest is shared memory.
//   A. each occurrence takes a ticket from its row's counter (atomicAdd on
//      cnt[r]);
//   B. the occurrence with ticket 0 claims its row: it reads the row's count,
//      clears the counter, and takes a head index and a range of pos (a
//      block's claims scanned and taken with one 64-bit atomic);
//   C. a head of one position is placed; the others' occurrences go to
//      their head's range of tmp at their ticket;
//   D. each occurrence of a head of 2 .. kBigTerms positions counts the
//      smaller positions of its range (loads eight at a time) and writes
//      itself at that rank; a longer head goes to one block, which counts
//      ranks through shared memory, kRankChunk positions at a time.
// Arrivals and tickets set the heads' order; the positions' order within a
// head is the ids' alone. Every sum that reads the plan runs over a head's
// positions in that order. Each kernel sets its non-portable cluster
// attribute once per process.

// row_sum: out[r] = the lookup's gradient rows of the positions of row r,
// added in float32 in position order and rounded once to the output's type
// (what index_add_ computes on the CPU, 16-bit rows included); 0 for a row
// no id names. Bytes bound: it reads the own positions' rows once and writes
// every row.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_groups.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// Hopper's largest cluster is 16 blocks (8 the portable size)
constexpr int kMaxCluster = 16;
// the inboxes' most ids a grouping: one a thread of a whole cluster;
// an inbox of that many 8-byte keys is 128 KB of shared memory
constexpr int kInboxMax = kThreads * kMaxCluster;
// the four rounds: a big head's positions in shared memory at a time
constexpr int kRankChunk = 4096;

// One grouping's operands: ids [R] over rows [offset, offset + L); cnt and
// row_head [L] kept; meta [4], head_row, head_start, head_len, pos, big [R]
// out; tick, tmp [R] scratch (cnt, tick and tmp for the four rounds only).
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

// an inbox of at most this many keys is grouped through a hash table in
// shared memory; a fuller one (a step whose ids crowd one owner) is sorted
constexpr int kHashMax = 4096;
// the hash table's shared memory at its largest: row, count and start per
// slot (2 kHashMax slots), and each head's positions
constexpr size_t kHashSmem = sizeof(int) * (3 * 2 * kHashMax + kHashMax);

// inbox[0, M) sorted ascending in place: bitonic over the power of two N >=
// M, padded with keys above all. Every thread calls it; it ends with a
// barrier.
__device__ void sort_inbox(unsigned long long* inbox, int M) {
  const int tid = threadIdx.x;
  int N = 1;
  while (N < M) N <<= 1;
  for (int t = M + tid; t < N; t += kThreads) inbox[t] = ~0ull;
  __syncthreads();
  for (int k = 2; k <= N; k <<= 1) {
    for (int m = k >> 1; m > 0; m >>= 1) {
      for (int i = tid; i < N; i += kThreads) {
        const int o = i ^ m;
        if (o > i) {
          const unsigned long long x = inbox[i], y = inbox[o];
          if ((x > y) == ((i & k) == 0)) inbox[i] = y, inbox[o] = x;
        }
      }
      __syncthreads();
    }
  }
}

// The heads of a sorted inbox[0, M): a row's first key starts its head, a
// thread numbering its starts from its share of the block's; the block's
// heads and positions are taken with one 64-bit atomic, so its sorted keys
// are its part of pos as they stand. Every thread calls it.
__device__ void sort_heads(const Set& s, unsigned long long* inbox, int M, int2* warp_tot,
                           unsigned long long* base) {
  const int tid = threadIdx.x;
  sort_inbox(inbox, M);
  int heads = 0, unused = 0;
  for (int i = tid; i < M; i += kThreads) heads += i == 0 || inbox[i] >> 32 != inbox[i - 1] >> 32;
  const int2 tot = block_scan(heads, unused, warp_tot);
  if (tid == 0)  // meta[0]: positions taken, meta[1]: heads
    *base = atomicAdd(reinterpret_cast<unsigned long long*>(s.meta),
                      (unsigned long long)tot.x << 32 | (unsigned)M);
  __syncthreads();
  const int h0 = (int)(*base >> 32) + heads, p0 = (int)(*base & 0xFFFFFFFFu);
  for (int i = tid, h = h0; i < M; i += kThreads) {
    const unsigned long long key = inbox[i];
    const int row = (int)(key >> 32);
    s.pos[p0 + i] = (int)(unsigned)key;
    if (i > 0 && inbox[i - 1] >> 32 == key >> 32) continue;
    // the head's end: the first key of a later row
    int lo = i + 1, hi = M;
    const unsigned long long next = (unsigned long long)(row + 1) << 32;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (inbox[mid] < next) lo = mid + 1;
      else hi = mid;
    }
    s.head_row[h] = row;
    s.head_start[h] = p0 + i;
    s.head_len[h] = lo - i;
    s.row_head[row] = h;
    if (lo - i > kBigTerms) s.big[atomicAdd(s.meta + 2, 1)] = h;
    ++h;
  }
}

// The inboxes. Grid (cluster, sets), clusters of all gridDim.x blocks
// along x: cluster y builds the grouping of set y, R <= kThreads *
// gridDim.x; dynamic shared memory: the larger of the inbox (8 * slots
// bytes, slots a power of two >= R) and the hash table (kHashSmem).
__global__ void __launch_bounds__(kThreads) inbox_kernel(Set s0, Set s1) {
  extern __shared__ unsigned long long inbox[];
  __shared__ int2 warp_tot[kWarps];
  __shared__ int n_in, sent[kMaxCluster];
  __shared__ unsigned long long base;
  cg::cluster_group cluster = cg::this_cluster();
  const Set s = blockIdx.y ? s1 : s0;
  const int tid = threadIdx.x, me = (int)cluster.block_rank();
  const int nb = (int)cluster.num_blocks();
  if (tid == 0) n_in = 0;
  if (tid < kMaxCluster) sent[tid] = 0;
  if (me == 0 && tid == 0) *reinterpret_cast<unsigned long long*>(s.meta) = 0ull, s.meta[2] = 0;
  cluster_barrier(cluster);  // every block of the cluster runs, its counters zero
  // 1. the keys to their owners: a slot of the owner's inbox per key, the
  // block's slots in each owner's inbox taken with one remote atomic
  const int j = me * kThreads + tid;
  const int r = j < s.R ? local_row(s, j) : -1;
  const int owner =
      r >= 0 ? (int)((unsigned long long)((unsigned)r * 0x85EBCA77u) * nb >> 32) : 0;
  // a warp's keys for one owner take their slots with one shared atomic
  const int lane = tid & 31;
  const unsigned peers = __match_any_sync(0xffffffffu, r >= 0 ? owner : -1);
  const int leader = __ffs(peers) - 1;
  int slot = 0;
  if (lane == leader && r >= 0) slot = atomicAdd(&sent[owner], __popc(peers));
  slot = __shfl_sync(0xffffffffu, slot, leader) + __popc(peers & ((1u << lane) - 1));
  __syncthreads();
  if (tid < nb && sent[tid]) sent[tid] = atomicAdd(cluster.map_shared_rank(&n_in, tid), sent[tid]);
  __syncthreads();
  if (r >= 0)
    cluster.map_shared_rank(inbox, owner)[sent[owner] + slot] =
        (unsigned long long)r << 32 | (unsigned)j;
  cluster_barrier(cluster);  // every key is in its inbox
  const int M = n_in;
  if (M > kHashMax) {
    sort_heads(s, inbox, M, warp_tot, &base);
    return;
  }
  // 2. the block's keys (at most kHashMax: kKeys a thread) to registers; the
  // inbox's memory becomes a hash table of the block's rows: row, count (the
  // keys' tickets) and start per slot, S slots, then each head's positions
  constexpr int kKeys = kHashMax / kThreads;
  unsigned long long key[kKeys];
#pragma unroll
  for (int e = 0; e < kKeys; ++e) key[e] = e * kThreads + tid < M ? inbox[e * kThreads + tid] : 0ull;
  int S = 2, bits = 1;
  while (S < 2 * M) S <<= 1, ++bits;
  int* hrow = reinterpret_cast<int*>(inbox);
  int* hcnt = hrow + S;
  int* hstart = hcnt + S;
  int* list = hstart + S;
  __syncthreads();  // the keys are read
  for (int t = tid; t < S; t += kThreads) hrow[t] = -1, hcnt[t] = 0;
  __syncthreads();
  int slot_of[kKeys], tick[kKeys];
#pragma unroll
  for (int e = 0; e < kKeys; ++e) {
    if (e * kThreads + tid >= M) continue;
    const int row = (int)(key[e] >> 32);
    int h = (int)((unsigned)row * 2654435761u >> (32 - bits));
    for (;;) {
      const int prev = atomicCAS(hrow + h, -1, row);
      if (prev == -1 || prev == row) break;
      h = (h + 1) & (S - 1);
    }
    slot_of[e] = h;
    tick[e] = atomicAdd(hcnt + h, 1);
  }
  __syncthreads();
  // 3. heads: a row's first ticket claims it; the block's heads and
  // positions are taken with one 64-bit atomic
  int heads = 0, taken = 0;
#pragma unroll
  for (int e = 0; e < kKeys; ++e)
    if (e * kThreads + tid < M && tick[e] == 0) ++heads, taken += hcnt[slot_of[e]];
  const int2 tot = block_scan(heads, taken, warp_tot);
  if (tid == 0 && M)  // meta[0]: positions taken, meta[1]: heads
    base = atomicAdd(reinterpret_cast<unsigned long long*>(s.meta),
                     (unsigned long long)tot.x << 32 | (unsigned)tot.y);
  __syncthreads();
  const int h0 = (int)(base >> 32), p0 = (int)(base & 0xFFFFFFFFu);
#pragma unroll
  for (int e = 0; e < kKeys; ++e) {
    if (e * kThreads + tid >= M || tick[e]) continue;
    const int row = (int)(key[e] >> 32), n = hcnt[slot_of[e]], h = h0 + heads++;
    hstart[slot_of[e]] = taken;
    s.head_row[h] = row;
    s.head_start[h] = p0 + taken;
    s.head_len[h] = n;
    s.row_head[row] = h;
    if (n > kBigTerms) s.big[atomicAdd(s.meta + 2, 1)] = h;
    taken += n;
  }
  __syncthreads();
  // 4. a head of one position is placed; the others' positions are listed at
  // their tickets, then each placed at its rank among its head's
#pragma unroll
  for (int e = 0; e < kKeys; ++e) {
    if (e * kThreads + tid >= M) continue;
    const int h = slot_of[e], j = (int)(unsigned)key[e];
    if (hcnt[h] == 1) s.pos[p0 + hstart[h]] = j;
    else list[hstart[h] + tick[e]] = j;
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kKeys; ++e) {
    if (e * kThreads + tid >= M) continue;
    const int h = slot_of[e], n = hcnt[h], st = hstart[h], j = (int)(unsigned)key[e];
    if (n == 1) continue;
    int rank = 0;
    for (int t = 0; t < n; ++t) rank += list[st + t] < j;
    s.pos[p0 + st + rank] = j;
  }
}

// The four rounds: grid (cluster, sets) as inbox_kernel's, any R.
__global__ void __launch_bounds__(kThreads) rounds_kernel(Set s0, Set s1) {
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
  // C: a head of one position places its occurrence in pos; the others'
  // occurrences go into their head's range of tmp at their ticket, and tick
  // becomes the head (-1 for one already placed)
  for (int j = first + tid; j < s.R; j += stride) {
    const int t = s.tick[j];
    if (t < 0) continue;
    const int h = __ldcg(s.row_head + local_row(s, j));
    const int st = __ldcg(s.head_start + h), n = __ldcg(s.head_len + h);
    if (n == 1) {
      s.pos[st] = j;
      s.tick[j] = -1;
    } else {
      s.tmp[st + t] = j;
      s.tick[j] = h;
    }
  }
  cluster_barrier(cluster);
  // D: position order for the heads of 2 .. kBigTerms positions, a rank
  // each occurrence counts in its range
  for (int j = first + tid; j < s.R; j += stride) {
    const int h = s.tick[j];
    if (h < 0) continue;
    const int st = __ldcg(s.head_start + h), n = __ldcg(s.head_len + h);
    if (n > kBigTerms) continue;
    int rank = 0;
    for (int k0 = 0; k0 < n; k0 += 8) {
      int v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = k0 + u < n ? __ldcg(s.tmp + st + k0 + u) : INT_MAX;
#pragma unroll
      for (int u = 0; u < 8; ++u) rank += v[u] < j;
    }
    s.pos[st + rank] = j;
  }
  // the heads of more than kBigTerms positions, a block each, ranked by
  // counting through shared memory, kRankChunk positions at a time
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
  const bool inboxes = R <= kInboxMax;
  void (*kernel)(Set, Set) = inboxes ? inbox_kernel : rounds_kernel;
  int slots = 1;
  while (slots < R) slots <<= 1;
  size_t smem = inboxes ? sizeof(unsigned long long) * slots : 0;
  if (inboxes && smem < kHashSmem) smem = kHashSmem;
  int cluster = (R + kThreads - 1) / kThreads;
  cluster = cluster < 1 ? 1 : cluster > kMaxCluster ? kMaxCluster : cluster;
  // whether clusters above the portable 8 blocks are allowed, and the
  // inboxes' shared memory: asked once a kernel
  static const bool wide[2] = {
      cudaFuncSetAttribute(rounds_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) ==
          cudaSuccess,
      cudaFuncSetAttribute(inbox_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) ==
          cudaSuccess};
  static const cudaError_t inbox_smem = cudaFuncSetAttribute(
      inbox_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(unsigned long long) * kInboxMax > kHashSmem
                ? sizeof(unsigned long long) * kInboxMax : kHashSmem));
  if (inboxes && inbox_smem != cudaSuccess) return (int)inbox_smem;
  if (cluster > 8 && !wide[inboxes]) {
    cudaGetLastError();  // the portable size then
    if (inboxes) return (int)cudaErrorInvalidConfiguration;  // an inbox needs every block
    cluster = 8;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, sets);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, s0, s1);
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
