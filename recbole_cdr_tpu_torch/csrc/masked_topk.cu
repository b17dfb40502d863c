// K4: history-masked full-row top-k of the dense full-sort evaluator.
//
// Replaces recbole_cdr_tpu/evaluator/evaluator.py:40-52 _apply_masks_pairs
// plus the lax.top_k of _fused_program (:299-311): every (row, item) history
// pair and column 0 (PAD) is set to finfo(float32).min, then the k largest
// scores of each row are selected, ties going to the lowest column (masked
// entries included, which matters when fewer than k items are unmasked).
// Only the [B, k] ids are written; the masked score matrix never is.
//
// B10, the candidate top-k, is the same kernel under the kCand template
// flag. It replaces recbole_cdr_tpu/evaluator/evaluator.py:88-93
// _candidate_topk: over [B, C] scores of each user's sampled candidate list,
// the slots a row's cand_mask leaves out are set to finfo(float32).min and
// the k best positions are taken, ties to the lowest position. There is no
// history and no PAD column: column 0 is a row's first positive.
//
// Bound on an H100: bytes. The [B, I] scores are read once (4 bytes and
// about one compare each; B10 adds its 1-byte mask): 0.0122 ms for a
// [2,048 x 4,980] dense tile at 3.35 TB/s, 0.0002 ms for a [32 x 4,980]
// predict-fallback tile, 0.0001 ms for a [25 x 2,525] candidate batch.
//
// Design (the first design took one 256-thread block per row, built
// an I / 8-byte history bitmap between two block barriers, and ran k rounds
// of a block-wide argmax with two barriers each: over 20 block barriers per
// row, and only B of the 132 SMs busy at B = 32). The launch plan comes from
// ops/masked_topk.py::masked_topk_plan: grid (chunks, row blocks), 8 warps
// a block, R rows a block and 8 / R warps a row, each warp a segment of
// ``sub`` columns of its row's chunk of ``span`` columns.
//   - Dense tiles (B above 4 rows per SM): R = 8, one warp per whole row.
//   - Short tiles: each row's columns split over a thread-block cluster of up
//     to 8 blocks (the portable size), one chunk a block, 8 warps a chunk.
// Each warp reads its segment with 16-byte float4 loads (scalar head and
// tail to the alignment), and each lane tests its four scores against the
// row's running k-th best (score, id), held in registers. A score that does
// not beat it is dropped after one compare; survivors are compacted by
// __ballot_sync into the warp's buffer in shared memory, and the warp merges
// buffer and list (k rounds of a warp argmax) when the buffer could not take
// another step. History and PAD are tested only there, against the warp's
// own segment bitmap, which the warp builds from the row's CSR slice under
// __syncwarp alone, or, for B10, the row's candidate mask: a masked entry
// enters the merge as -FLT_MAX with its column id, so rows with fewer than k
// unmasked items still take the lowest masked columns, as lax.top_k does.
// The bitmap is kept, not a test of the merge's entries against the CSR
// slice itself: a row's slice arrives unsorted and of any length (a whole
// row, in the card tests), so such a test costs a scan of the slice per
// entry, quadratic where most of a row is history; a hashed set, as B5's,
// would take a second kernel in a launch that is latency-bound on short
// tiles. No block barrier runs before or inside the selection. At the end
// the row's warps' lists merge by list heads (one barrier, where a block
// holds fewer than 8 rows), and a cluster's blocks' lists merge in cluster
// rank 0, whose threads copy them from the others' shared memory
// (distributed shared memory between two cluster barriers): no second kernel
// and no atomics in device memory.

#include <cfloat>
#include <climits>
#include <cmath>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCap = 256;    // survivor buffer of a warp
constexpr int kStep = 128;   // columns a warp tests per step: 32 lanes x float4
constexpr int kUnroll = 4;   // steps whose loads are in flight together
constexpr int kMaxK = 64;
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// an unsigned key in the order of the floats (-0 and +0 equal)
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the warp's best (v, id) by (score desc, id asc), to every lane: one max
// and one min reduction (redux.sync) where shuffles would take ten
__device__ __forceinline__ void warp_best(float& v, int& id) {
  const unsigned key = order_key(v);
  const unsigned m = __reduce_max_sync(kFull, key);
  const int wid = (int)__reduce_min_sync(kFull, key == m ? (unsigned)id : 0xffffffffu);
  const unsigned at = __ballot_sync(kFull, key == m && id == wid);
  v = __shfl_sync(kFull, v, __ffs(at) - 1);
  id = wid;
}

// the masks a warp's merge reads: its segment bitmap of history and PAD bits
// (K4), or the row's candidate mask (B10)
struct RowMask {
  const uint32_t* bits;       // K4: bit j of the segment, column c0 + j
  int c0;
  const unsigned char* cand;  // B10: the row's [C] mask
};

template <bool kCand>
__device__ __forceinline__ bool is_masked(const RowMask& m, int col) {
  if (kCand) return m.cand[col] == 0;
  const int j = col - m.c0;
  return (m.bits[j >> 5] >> (j & 31)) & 1u;
}

// One warp merges its list ls / li (k entries, best first) with its buffer
// bs / bi (n survivors, k + n <= 32 kE): buffered entries that are masked
// score -FLT_MAX, then k rounds of a warp argmax; (ts, ti) becomes the new
// k-th best.
template <bool kCand, int kE>
__device__ void merge_buffer(float* ls, int* li, const float* bs, const int* bi, int n, int k,
                             const RowMask& m, float& ts, int& ti) {
  const int lane = threadIdx.x & 31;
  float v[kE];
  int id[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int s = e * 32 + lane;
    v[e] = -INFINITY;
    id[e] = INT_MAX;
    if (s < k) {
      v[e] = ls[s];
      id[e] = li[s];
    } else if (s - k < n) {
      id[e] = bi[s - k];
      v[e] = is_masked<kCand>(m, id[e]) ? -FLT_MAX : bs[s - k];
    }
  }
  __syncwarp();
  for (int q = 0; q < k; ++q) {
    float bv = v[0];
    int bid = id[0];
#pragma unroll
    for (int e = 1; e < kE; ++e)
      if (better(v[e], id[e], bv, bid)) {
        bv = v[e];
        bid = id[e];
      }
    warp_best(bv, bid);
    if (lane == 0) {
      ls[q] = bv;
      li[q] = bid;
    }
#pragma unroll
    for (int e = 0; e < kE; ++e)  // ids are unique but for the padding
      if (id[e] == bid && v[e] == bv) {
        v[e] = -INFINITY;
        id[e] = INT_MAX;
      }
    ts = bv;
    ti = bid;
  }
  __syncwarp();
}

template <bool kCand>
__device__ __forceinline__ void merge_any(float* ls, int* li, const float* bs, const int* bi,
                                          int n, int k, const RowMask& m, float& ts, int& ti) {
  if (k + n <= 64)
    merge_buffer<kCand, 2>(ls, li, bs, bi, n, k, m, ts, ti);
  else if (k + n <= 160)
    merge_buffer<kCand, 5>(ls, li, bs, bi, n, k, m, ts, ti);
  else
    merge_buffer<kCand, (kMaxK + kCap) / 32>(ls, li, bs, bi, n, k, m, ts, ti);
}

// Merge ``n`` <= 64 sorted lists of k by their heads: list j at s0 + j *
// stride (scores) and i0 + j * stride (ids), read by lane j % 32. The k best,
// best first, go to out_s (if given) and out_i, which may be list 0 (every
// read precedes the writes)
__device__ void merge_lists(const float* s0, const int* i0, int stride, int n, int k,
                            float* out_s, int* out_i) {
  const int lane = threadIdx.x & 31;
  int p0 = 0, p1 = 0;
  const int j0 = lane, j1 = lane + 32;
  float keep_s[2] = {-INFINITY, -INFINITY};
  int keep_i[2] = {INT_MAX, INT_MAX};
  for (int q = 0; q < k; ++q) {
    float v0 = -INFINITY, v1 = -INFINITY;
    int id0 = INT_MAX, id1 = INT_MAX;
    if (j0 < n && p0 < k) {
      v0 = s0[j0 * stride + p0];
      id0 = i0[j0 * stride + p0];
    }
    if (j1 < n && p1 < k) {
      v1 = s0[j1 * stride + p1];
      id1 = i0[j1 * stride + p1];
    }
    const bool second = better(v1, id1, v0, id0);
    float bv = second ? v1 : v0;
    int bid = second ? id1 : id0;
    const float mine_v = bv;
    const int mine_i = bid;
    warp_best(bv, bid);
    if (mine_i == bid && mine_v == bv && bid != INT_MAX) {  // ids unique across lists
      if (second) ++p1; else ++p0;
    }
    if (lane == (q & 31)) {
      keep_s[q >> 5] = bv;
      keep_i[q >> 5] = bid;
    }
  }
  __syncwarp();
  for (int h = 0; h < 2; ++h)
    if (h * 32 + lane < k) {
      if (out_s) out_s[h * 32 + lane] = keep_s[h];
      out_i[h * 32 + lane] = keep_i[h];
    }
  __syncwarp();
}

// plan (ops/masked_topk.py::masked_topk_plan): R rows a block, 8 / R warps
// a row, chunks of ``span`` columns (one per block of a cluster of
// ``gridDim.x`` blocks), segments of ``sub`` columns (one per warp)
template <bool kCand>
__global__ void __launch_bounds__(kThreads)
masked_topk_kernel(const float* __restrict__ scores, int B, int I, int R, int span, int sub,
                   const int* __restrict__ row_ptr, const int* __restrict__ items,
                   const unsigned char* __restrict__ cand_mask, int k, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpr = kWarps / R;                        // warps per row
  const int rl = warp / wpr, sw = warp % wpr;        // row in the block, segment
  const int row = blockIdx.y * R + rl;
  const int cc0 = blockIdx.x * span, cc1 = min(I, cc0 + span);  // the block's chunk
  const int s0 = cc0 + sw * sub, s1 = min(cc1, s0 + sub);  // the warp's segment
  const int words = (sub + 31) >> 5;  // a warp's segment bitmap
  const size_t wstride = 2 * (size_t)(k + kCap);  // floats between warps' lists
  uint32_t* bitmap = reinterpret_cast<uint32_t*>(smem) + (kCand ? 0 : warp * words);
  float* ls0 = reinterpret_cast<float*>(smem + (kCand ? 0 : 4 * (size_t)kWarps * words));
  float* ls = ls0 + warp * wstride;
  int* li = reinterpret_cast<int*>(ls + k);
  float* bs = ls + 2 * k;
  int* bi = reinterpret_cast<int*>(bs + kCap);
  const bool live = row < B;  // uniform across the warp (and the row's warps)

  // ---- the warp's segment bitmap: history and PAD bits --------------------
  // Each warp reads the row's whole CSR slice and keeps its segment's items:
  // the bitmap is warp-private, so __syncwarp orders it, not a block barrier
  if (!kCand) {
    for (int w = lane; w < words; w += 32) bitmap[w] = 0u;
    __syncwarp();
    if (live && s0 < s1) {
      if (lane == 0 && s0 == 0) atomicOr(bitmap, 1u);  // PAD column
      const int p_end = row_ptr[row + 1];
#pragma unroll 4
      for (int p = row_ptr[row] + lane; p < p_end; p += 32) {
        const int it = __ldg(items + p);
        if (it >= s0 && it < s1) atomicOr(bitmap + ((it - s0) >> 5), 1u << ((it - s0) & 31));
      }
    }
    __syncwarp();
  }
  RowMask m{bitmap, s0, kCand && live ? cand_mask + (long long)row * I : nullptr};

  for (int q = lane; q < k; q += 32) {
    ls[q] = -INFINITY;
    li[q] = INT_MAX;
  }
  __syncwarp();
  float ts = -INFINITY;
  int ti = INT_MAX;
  int cnt = 0;  // survivors buffered, uniform across the warp

  // one step: this lane's ``nv`` scores at columns col .. col + nv - 1
  auto step = [&](const float4& x, int col, int nv) {
    if (cnt > kCap - kStep) {
      merge_any<kCand>(ls, li, bs, bi, cnt, k, m, ts, ti);
      cnt = 0;
    }
    const float v[4] = {x.x, x.y, x.z, x.w};
    const unsigned lt = (1u << lane) - 1;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a masked entry scores -FLT_MAX <= fmaxf(v, -FLT_MAX): the test keeps
      // every entry that could enter the list, masked or not
      const bool f = e < nv && better(fmaxf(v[e], -FLT_MAX), col + e, ts, ti);
      const unsigned b = __ballot_sync(kFull, f);
      if (f) {
        const int pos = cnt + __popc(b & lt);
        bs[pos] = v[e];
        bi[pos] = col + e;
      }
      cnt += __popc(b);
    }
  };

  if (live && s0 < s1) {
    const float* srow = scores + (long long)row * I;
    // scalar head up to 16-byte alignment, float4 body, scalar tail
    const int mis = (int)(((uintptr_t)(srow + s0) >> 2) & 3);
    const int b0 = min(s1, s0 + ((4 - mis) & 3));
    const int b1 = b0 + (s1 - b0) / 4 * 4;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    if (b0 > s0) {
      const int c = s0 + lane;
      step(c < b0 ? make_float4(__ldg(srow + c), 0.f, 0.f, 0.f) : zero, c, c < b0 ? 1 : 0);
    }
    for (int base = b0; base < b1; base += kUnroll * kStep) {
      float4 x[kUnroll];  // kUnroll loads in flight before the first test
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = base + u * kStep + 4 * lane;
        x[u] = c < b1 ? __ldg(reinterpret_cast<const float4*>(srow + c)) : zero;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = base + u * kStep + 4 * lane;
        if (base + u * kStep < b1) step(x[u], c, c < b1 ? 4 : 0);  // uniform
      }
    }
    if (s1 > b1) {
      const int c = b1 + lane;
      step(c < s1 ? make_float4(__ldg(srow + c), 0.f, 0.f, 0.f) : zero, c, c < s1 ? 1 : 0);
    }
    if (cnt > 0) merge_any<kCand>(ls, li, bs, bi, cnt, k, m, ts, ti);
  }

  if (gridDim.x == 1) {
    // ---- one chunk a row: the row's warps' lists merge by their heads ------
    if (wpr > 1) {
      __syncthreads();
      if (sw == 0) merge_lists(ls, li, (int)wstride, wpr, k, ls, li);
    }
    if (live && sw == 0)
      for (int q = lane; q < k; q += 32) out[(long long)row * k + q] = li[q];
    return;
  }
  // ---- a cluster a row: rank 0's threads copy every warp's list of every
  // block of the cluster (distributed shared memory), then its warp 0 merges
  // them by their heads
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every warp's list is complete
  const int n = (int)gridDim.x * kWarps;
  float* ms = ls0 + kWarps * wstride;  // rank 0's copy: [n][k] scores, then ids
  int* mi = reinterpret_cast<int*>(ms + n * k);
  if (cluster.block_rank() == 0 && live)
    for (int e = threadIdx.x; e < n * k; e += kThreads) {
      const int L = e / k, pos = e % k;
      const float* src = cluster.map_shared_rank(ls0 + (L % kWarps) * wstride, L / kWarps);
      ms[e] = src[pos];
      mi[e] = reinterpret_cast<const int*>(src + k)[pos];
    }
  // the other blocks' shared memory stays until rank 0 has read it, and rank
  // 0's copy is complete before its warp 0 reads it
  cluster.sync();
  if (cluster.block_rank() == 0 && warp == 0 && live)
    merge_lists(ms, mi, k, n, k, nullptr, out + (long long)row * k);
}

template <bool kCand>
int launch(const float* scores, int B, int I, const int* row_ptr, const int* items,
           const unsigned char* cand_mask, int k, int R, int cluster, int span, int sub,
           int smem, int* out, cudaStream_t stream) {
  if (k <= 0 || k > kMaxK || k > I || cluster < 1 || cluster > kMaxCluster ||
      (R != 1 && R != 2 && R != 4 && R != 8) || (cluster > 1 && R != 1) || span <= 0 ||
      (long long)span * cluster < I || (long long)span * (cluster - 1) >= I || sub <= 0 ||
      (long long)sub * (kWarps / R) < span || smem <= 0 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const size_t need = (kCand ? 0 : 4 * (size_t)kWarps * ((sub + 31) / 32)) +
                      (size_t)kWarps * 8 * (k + kCap) +
                      (cluster > 1 ? (size_t)cluster * kWarps * 8 * k : 0);
  if ((size_t)smem < need) return (int)cudaErrorInvalidValue;
  auto kernel = masked_topk_kernel<kCand>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (B + R - 1) / R);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, scores, B, I, R, span, sub, row_ptr, items, cand_mask, k,
                         out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// scores: [B, I] float32; row_ptr: [B + 1] CSR offsets into items; out: [B, k];
// rows_per_block, cluster, span, sub, smem: the launch plan
extern "C" int masked_topk(const void* scores, int B, int I, const void* row_ptr,
                           const void* items, int k, int rows_per_block, int cluster, int span,
                           int sub, int smem, void* out, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  return launch<false>((const float*)scores, B, I, (const int*)row_ptr, (const int*)items,
                       nullptr, k, rows_per_block, cluster, span, sub, smem, (int*)out,
                       (cudaStream_t)stream);
}

// B10. scores: [B, C] float32; cand_mask: [B, C] bool (1 byte each); out: [B, k]
extern "C" int candidate_topk(const void* scores, int B, int C, const void* cand_mask, int k,
                              int rows_per_block, int cluster, int span, int sub, int smem,
                              void* out, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  return launch<true>((const float*)scores, B, C, nullptr, nullptr,
                      (const unsigned char*)cand_mask, k, rows_per_block, cluster, span, sub,
                      smem, (int*)out, (cudaStream_t)stream);
}
