// B11: DTCDR's DMF rating-vector product, forward and backward.
//
// Replaces recbole_cdr_tpu/models/dtcdr.py:127-154 (_rating_vector: each
// id's padded history row scattered into a dense binary [B, N] vector, its
// PAD column zeroed, then `vec @ table`) and its autodiff (`vec.T @ gout`).
// The vector is a set, so with the history held as a CSR of each row's
// distinct non-PAD entries the same function is
//
//   forward:  out[b] = sum over j in row(ids[b]) of table[cols[j]]
//   backward: dtable[c] = sum over b with c in row(ids[b]) of gout[b]
//
// Bound on an H100: bytes. The dense form reads a [B, N] vector (0.9 GB at
// B = 8,192 and N = 27.8k); the gather-sum reads each distinct id's history
// entries and the table rows they name (D floats each, L2-resident: the
// tables are at most ~11 MB), one add per entry and column.
//
// Design. Every float sum runs in an order that depends on the inputs
// alone, so two runs on the same inputs are bit-equal: there is no float
// atomic. Batches repeat popular ids (a popular item is in hundreds of a
// step's pairs, with thousands of history entries), so all work is per
// distinct id ("head"):
//   1. the grouping of the ids by row (ops/row_groups.py::group_rows, the
//      plan K1, B6, B9 and B16 read too; csrc/row_groups.cuh), built once a
//      step for both sides' ids in one launch and shared by every table and
//      direction that takes those ids: each distinct id's positions in
//      position order, the heads in no set order, and a map from history
//      row to head that is never cleared (a row has a head only where the
//      head names it back: head_of). Ids outside the rows have no head; the
//      forward writes their output rows as zeros. The forward walks the
//      history's short rows in row order, skipping a row without a head,
//      and sums the pieces of every long row, present or not: that costs
//      less than the grouping's unsorted heads and a head check a piece;
//   2. one fixed-order gather-sum (warp_sum), "CSR rows x dense rows ->
//      float32 rows", used three ways: forward, the head's history row of
//      the table; backward (a), the head's positions' rows of gout into
//      gsum[head]; backward (b), for table row c, gsum of every present
//      history row that holds c, walking the transposed history (a CSR from
//      table row to history rows, built once on the host). A warp takes 32
//      entries at a time, packs the kept ones to the front, and its RW row
//      groups (32 / RW lanes each, 16-byte loads of a row) add every RW-th
//      kept entry in order; the groups' sums are added pairwise;
//   3. rows of more than `piece` entries (64) are cut into static pieces of
//      that many entries (on the host, once per history and direction): the
//      pieces' partial sums go to a scratch table, and a second pass adds
//      them in piece order, a warp a row, or a block a row of more than 32
//      pieces (the host's lists of both; the block's 8 warps each sum a
//      contiguous run, then warp 0's, 1's, ... sums are added in order). A
//      head of more than kBigTerms positions (the grouping's big list) is
//      summed by a block the same way.
// The forward writes each head's sum to every one of its positions and the
// backward writes every table row once (0 where no present row holds it),
// so nothing is zeroed before a launch; the 16-bit form rounds each table
// row's float32 sum once as it writes it.
//
// B11-bf16, the 16-bit form (DMF under compute_dtype: bfloat16; float16
// through the same template). JAX's rating vector stays float32
// (dtcdr.py:132), and float32 @ bf16 promotes to float32, so the forward
// reads 16-bit table rows (half the bytes), widens them exactly and sums
// them in float32 into a float32 output. The backward's gout is float32 (the
// towers run in float32); the table's gradient passes back through the
// promotion's cast, so it is the float32 row sum rounded once to the
// table's type.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_groups.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;           // rows a row group loads before it adds them
constexpr int kGridPerSM = 8;
// the block sums' shared memory, (kWarps + 1) D floats, bounds D at
// row_groups.cuh's kMaxD

// a warp's lanes over a row of D values: RW row groups of G lanes, VEC
// consecutive values a lane (one 16-byte float32 or 8-byte 16-bit load when
// VEC is 4), `steps` column steps of G VEC values
struct Geo {
  int G, RW, steps;
};

template <int VEC>
__host__ __device__ inline Geo geo(int D) {
  const int need = (D + VEC - 1) / VEC;
  const int G = VEC == 1 || need > 16 ? 32 : need > 8 ? 16 : 8;
  return {G, 32 / G, (need + G - 1) / G};
}

template <int VEC, typename T>
__device__ __forceinline__ void load(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = ld4(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    v[0] = ld1(p);
  }
}

// VEC float32 values stored as T (rounded once when T is 16-bit)
template <int VEC, typename T>
__device__ __forceinline__ void store(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4 && kWide<T>) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(to_bits<T>(v[0]) | to_bits<T>(v[1]) << 16,
                                              to_bits<T>(v[2]) | to_bits<T>(v[3]) << 16);
  } else {
    st1(p, v[0]);
  }
}

// The warp's sum, at columns d .. d + VEC, of the rows src[row_of(j)] for j
// in [lo, hi), skipping j where row_of(j) < 0. Entries come 32 at a time, one
// a lane; the kept ones are packed to the front in entry order, and row group
// `sub` adds kept entries sub, sub + RW, sub + 2 RW, ... in that order; the
// RW groups' sums are then added pairwise (lanes G apart, then 2 G), so every
// lane ends with the same sum in an order fixed by the entries alone.
template <int VEC, typename T, typename RowOf>
__device__ __forceinline__ void warp_sum(int lo, int hi, RowOf row_of,
                                         const T* __restrict__ src, int D, int d,
                                         const Geo& g, float (&acc)[VEC]) {
  const int lane = threadIdx.x & 31, sub = lane / g.G;
#pragma unroll
  for (int t = 0; t < VEC; ++t) acc[t] = 0.f;
  for (int base = lo; base < hi; base += 32) {
    const int r = base + lane < hi ? row_of(base + lane) : -1;
    const unsigned keep = __ballot_sync(0xffffffffu, r >= 0);
    const int n = __popc(keep);
    const int packed = __shfl_sync(0xffffffffu, r, lane < n ? __fns(keep, 0, lane + 1) : 0);
    for (int e0 = 0; e0 < n; e0 += g.RW * kUnroll) {
      float v[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * g.RW + sub;
        const int row = __shfl_sync(0xffffffffu, packed, e & 31);
        if (e < n && d < D) load<VEC>(src + (long long)row * D + d, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (e0 + u * g.RW + sub < n && d < D) {
#pragma unroll
          for (int t = 0; t < VEC; ++t) acc[t] += v[u][t];
        }
    }
  }
  for (int off = g.G; off < 32; off <<= 1) {
#pragma unroll
    for (int t = 0; t < VEC; ++t) acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], off);
  }
}

// The warp's VEC values v at column d stored to row pos[q] of out for every
// q in [q0, q1): 32 positions loaded at once, row group `sub` taking every
// RW-th of them.
template <int VEC>
__device__ __forceinline__ void warp_scatter(int q0, int q1, const int* __restrict__ pos,
                                             float* __restrict__ out, int D, int d,
                                             const Geo& g, const float (&v)[VEC]) {
  const int lane = threadIdx.x & 31, sub = lane / g.G;
  for (int base = q0; base < q1; base += 32) {
    const int n = min(32, q1 - base);
    const int mine = lane < n ? pos[base + lane] : 0;
    for (int k = 0; k < n; k += g.RW) {
      const int p = __shfl_sync(0xffffffffu, mine, (k + sub) & 31);
      if (k + sub < n && d < D) store<VEC>(out + (long long)p * D + d, v);
    }
  }
}

// The block's sum of the same over [lo, hi), into red[kWarps * D .. + D):
// warp w sums the w-th of kWarps contiguous runs, then the warps' sums are
// added in warp order. Every thread of the block calls it.
template <int VEC, typename T, typename RowOf>
__device__ void block_sum(int lo, int hi, RowOf row_of, const T* __restrict__ src, int D,
                          float* red) {
  const Geo g = geo<VEC>(D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int run = (hi - lo + kWarps - 1) / kWarps;
  const int a = min(hi, lo + warp * run), b = min(hi, a + run);
  for (int s = 0; s < g.steps; ++s) {
    const int d = (s * g.G + lane % g.G) * VEC;
    float acc[VEC];
    warp_sum<VEC>(a, b, row_of, src, D, d, g, acc);
    if (lane < g.G && d < D) {
#pragma unroll
      for (int t = 0; t < VEC; ++t) red[warp * D + d + t] = acc[t];
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float s = red[d];
    for (int w = 1; w < kWarps; ++w) s += red[w * D + d];
    red[kWarps * D + d] = s;
  }
  __syncthreads();
}

// ---- the gather-sums -----------------------------------------------------------

// Forward, first pass: the short history rows that have a head, a warp each
// in row order (a row without one is skipped by its head check), their sums
// written to all their head's positions; the pieces of every long row, a warp
// each, into part[piece] (combine_kernel reads a present row's alone); the
// rows of ids outside [0, R) (no head: read only when the grouping left some
// of the B ids out) as zeros.
template <int VEC, typename T>
__global__ void __launch_bounds__(kThreads)
forward_kernel(const int* __restrict__ ptr, const int* __restrict__ cols, int R,
               const int* __restrict__ p_row, const int* __restrict__ p_first, int n_pieces,
               int piece, const T* __restrict__ table, int D, const int* __restrict__ ids,
               int B, GroupsView gr, float* __restrict__ part, float* __restrict__ out) {
  const Geo g = geo<VEC>(D);
  const int lane = threadIdx.x & 31, sub = lane / g.G;
  const int total = R + n_pieces;
  if (__ldg(gr.meta) < B) {
    for (int b = blockIdx.x * kThreads + threadIdx.x; b < B; b += gridDim.x * kThreads)
      if ((unsigned)__ldg(ids + b) >= (unsigned)R)
        for (int d = 0; d < D; ++d) out[(long long)b * D + d] = 0.f;
  }
  const auto col_of = [&](int j) { return cols[j]; };
  for (int w = blockIdx.x * kWarps + (threadIdx.x >> 5); w < total; w += gridDim.x * kWarps) {
    if (w < R) {
      const int r = w, h = head_of(gr, r);
      // absent, or a long row: the pieces and combine_kernel
      if (h < 0 || p_first[r + 1] > p_first[r]) continue;
      const int lo = ptr[r], hi = ptr[r + 1];
      const int q0 = gr.head_start[h], q1 = q0 + gr.head_len[h];
      for (int s = 0; s < g.steps; ++s) {
        const int d = (s * g.G + lane % g.G) * VEC;
        float acc[VEC];
        warp_sum<VEC>(lo, hi, col_of, table, D, d, g, acc);
        warp_scatter<VEC>(q0, q1, gr.pos, out, D, d, g, acc);
      }
    } else {
      const int p = w - R, r = p_row[p];
      const int lo = ptr[r] + (p - p_first[r]) * piece, hi = min(lo + piece, ptr[r + 1]);
      for (int s = 0; s < g.steps; ++s) {
        const int d = (s * g.G + lane % g.G) * VEC;
        float acc[VEC];
        warp_sum<VEC>(lo, hi, col_of, table, D, d, g, acc);
        if (sub == 0 && d < D) store<VEC>(part + (long long)p * D + d, acc);
      }
    }
  }
}

// Second pass over the rows of more than `piece` entries (of the history in
// the forward, of its transpose in the backward): each row's partial sums
// added in piece order, a block for each row of big_rows (more than 32
// pieces), a warp for each of small_rows. The forward skips a row absent
// from the batch and writes the sum to all its head's positions (out
// float32); the backward writes table row r once in T.
template <int VEC, typename T, bool kFwd>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const int* __restrict__ p_first, const int* __restrict__ big_rows, int n_big,
               const int* __restrict__ small_rows, int n_small, GroupsView gr,
               const float* __restrict__ part, int D, T* __restrict__ out) {
  extern __shared__ float red[];
  const Geo g = geo<VEC>(D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, sub = lane / g.G;
  const auto same = [](int j) { return j; };
  for (int i = blockIdx.x; i < n_big; i += gridDim.x) {
    const int r = big_rows[i];
    const int h = kFwd ? head_of(gr, r) : 0;
    if (h < 0) continue;
    block_sum<VEC>(p_first[r], p_first[r + 1], same, part, D, red);
    const float* sum = red + kWarps * D;
    if constexpr (kFwd) {
      const int q1 = gr.head_start[h] + gr.head_len[h];
      for (int base = gr.head_start[h] + 32 * warp; base < q1; base += 32 * kWarps) {
        const int n = min(32, q1 - base);
        const int mine = lane < n ? gr.pos[base + lane] : 0;
        for (int k = 0; k < n; ++k) {
          const long long p = __shfl_sync(0xffffffffu, mine, k);
          for (int d = lane; d < D; d += 32) out[p * D + d] = sum[d];
        }
      }
    } else {
      for (int d = threadIdx.x; d < D; d += kThreads) st1(out + (long long)r * D + d, sum[d]);
    }
    __syncthreads();
  }
  for (int w = blockIdx.x * kWarps + warp; w < n_small; w += gridDim.x * kWarps) {
    const int r = small_rows[w];
    const int h = kFwd ? head_of(gr, r) : 0;
    if (h < 0) continue;
    for (int s = 0; s < g.steps; ++s) {
      const int d = (s * g.G + lane % g.G) * VEC;
      float acc[VEC];
      warp_sum<VEC>(p_first[r], p_first[r + 1], same, part, D, d, g, acc);
      if constexpr (kFwd) {
        const int q0 = gr.head_start[h];
        warp_scatter<VEC>(q0, q0 + gr.head_len[h], gr.pos, out, D, d, g, acc);
      } else if (sub == 0 && d < D) {
        store<VEC>(out + (long long)r * D + d, acc);
      }
    }
  }
}

// Backward (a): gsum[h] = the head's positions' gout rows in position
// order: a block for each big head, a warp for each other head.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
head_sum_kernel(GroupsView gr, const float* __restrict__ gout, int D, float* __restrict__ gsum) {
  extern __shared__ float red[];
  const Geo g = geo<VEC>(D);
  const int lane = threadIdx.x & 31, sub = lane / g.G;
  const int H = __ldg(gr.meta + 1), n_big = __ldg(gr.meta + 2);
  const auto pos_of = [&](int j) { return gr.pos[j]; };
  for (int i = blockIdx.x; i < n_big; i += gridDim.x) {
    const int h = gr.big[i], q0 = gr.head_start[h];
    block_sum<VEC>(q0, q0 + gr.head_len[h], pos_of, gout, D, red);
    for (int d = threadIdx.x; d < D; d += kThreads) gsum[(long long)h * D + d] = red[kWarps * D + d];
    __syncthreads();
  }
  for (int h = blockIdx.x * kWarps + (threadIdx.x >> 5); h < H; h += gridDim.x * kWarps) {
    const int q0 = gr.head_start[h], n = gr.head_len[h];
    if (n > kBigTerms) continue;
    for (int s = 0; s < g.steps; ++s) {
      const int d = (s * g.G + lane % g.G) * VEC;
      float acc[VEC];
      warp_sum<VEC>(q0, q0 + n, pos_of, gout, D, d, g, acc);
      if (sub == 0 && d < D) store<VEC>(gsum + (long long)h * D + d, acc);
    }
  }
}

// Backward (b), first pass: table row c sums gsum over the present history
// rows of its transposed row, a warp a short row, written once in T (0 where
// none is present); the pieces of long rows, a warp each, into part[piece].
template <int VEC, typename T>
__global__ void __launch_bounds__(kThreads)
table_kernel(const int* __restrict__ tptr, const int* __restrict__ tcols, int N,
             const int* __restrict__ p_row, const int* __restrict__ p_first, int n_pieces,
             int piece, GroupsView gr, const float* __restrict__ gsum, int D,
             float* __restrict__ part, T* __restrict__ dtable) {
  const Geo g = geo<VEC>(D);
  const int lane = threadIdx.x & 31, sub = lane / g.G;
  const int total = N + n_pieces, H = __ldg(gr.meta + 1);
  // the head of the history row of entry j, or -1 (head_of, with H kept)
  const auto head_at = [&](int j) {
    const int r = tcols[j], h = __ldg(gr.row_head + r);
    return (unsigned)h < (unsigned)H && __ldg(gr.head_row + h) == r ? h : -1;
  };
  for (int w = blockIdx.x * kWarps + (threadIdx.x >> 5); w < total; w += gridDim.x * kWarps) {
    const bool whole = w < N;
    const int p = w - N, c = whole ? w : p_row[p];
    if (whole && p_first[c + 1] > p_first[c]) continue;  // a long row: its pieces
    const int lo = whole ? tptr[c] : tptr[c] + (p - p_first[c]) * piece;
    const int hi = whole ? tptr[c + 1] : min(lo + piece, tptr[c + 1]);
    for (int s = 0; s < g.steps; ++s) {
      const int d = (s * g.G + lane % g.G) * VEC;
      float acc[VEC];
      warp_sum<VEC>(lo, hi, head_at, gsum, D, d, g, acc);
      if (sub != 0 || d >= D) continue;
      if (whole) store<VEC>(dtable + (long long)c * D + d, acc);
      else store<VEC>(part + (long long)p * D + d, acc);
    }
  }
}

int grid_blocks(int per_sm) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

size_t red_bytes(int D) { return sizeof(float) * (size_t)(kWarps + 1) * D; }

// the second pass's blocks: one for each big row and a warp for each small
// one, at most `most`
int combine_blocks(int n_big, int n_small, int most) {
  int need = (n_small + kWarps - 1) / kWarps;
  need = need > n_big ? need : n_big;
  return need < most ? need : most;
}

template <int VEC, typename T>
int forward_launch(const int* ptr, const int* cols, int R, const int* p_row, const int* p_first,
                   int n_pieces, const int* big_rows, int n_big, const int* small_rows,
                   int n_small, int piece, const void* table, int D, const int* ids, int B,
                   const GroupsView& gr, float* part, float* out, cudaStream_t st) {
  const int blocks = grid_blocks(kGridPerSM);
  if (blocks <= 0) return (int)cudaErrorInvalidDevice;
  forward_kernel<VEC, T><<<blocks, kThreads, 0, st>>>(ptr, cols, R, p_row, p_first, n_pieces,
                                                     piece, (const T*)table, D, ids, B, gr,
                                                     part, out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_big + n_small == 0) return (int)e;
  combine_kernel<VEC, float, true>
      <<<combine_blocks(n_big, n_small, blocks), kThreads, red_bytes(D), st>>>(
          p_first, big_rows, n_big, small_rows, n_small, gr, part, D, out);
  return (int)cudaGetLastError();
}

template <int VEC, typename T>
int backward_launch(const int* tptr, const int* tcols, int N, const int* p_row,
                    const int* p_first, int n_pieces, const int* big_rows, int n_big,
                    const int* small_rows, int n_small, int piece, const float* gout, int D,
                    const GroupsView& gr, float* gsum, float* part, void* dtable,
                    cudaStream_t st) {
  const int blocks = grid_blocks(kGridPerSM);
  if (blocks <= 0) return (int)cudaErrorInvalidDevice;
  head_sum_kernel<VEC><<<blocks, kThreads, red_bytes(D), st>>>(gr, gout, D, gsum);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || N == 0) return (int)e;
  table_kernel<VEC, T><<<blocks, kThreads, 0, st>>>(tptr, tcols, N, p_row, p_first, n_pieces,
                                                   piece, gr, gsum, D, part, (T*)dtable);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_big + n_small == 0) return (int)e;
  combine_kernel<VEC, T, false>
      <<<combine_blocks(n_big, n_small, blocks), kThreads, red_bytes(D), st>>>(
          p_first, big_rows, n_big, small_rows, n_small, gr, part, D, (T*)dtable);
  return (int)cudaGetLastError();
}

}  // namespace

// Forward: out float32 [B, D] (every row written) from the table [N, D] of
// dtype (0 float32, 1 bfloat16, 2 float16), the history (ptr [R + 1], cols)
// with its static pieces (p_row [n_pieces], p_first [R + 1], `piece` entries
// each; the cut rows of more than 32 pieces big_rows [n_big], the others
// small_rows [n_small]), the ids [B] and their grouping over the history's
// rows (groups: a C array of its seven arrays' addresses, row_groups.cuh);
// part: float32 [n_pieces, D] scratch. vec: 4 when D % 4 == 0 and every row
// is 16-byte (float32) or 8-byte (16-bit) aligned, else 1.
extern "C" int rating_vector_forward(const void* ptr, const void* cols, int R, const void* p_row,
                                     const void* p_first, int n_pieces, const void* big_rows,
                                     int n_big, const void* small_rows, int n_small, int piece,
                                     const void* table, int D, int dtype, int vec,
                                     const void* ids, int B, const void* const* groups,
                                     void* part, void* out, void* stream) {
  if (D <= 0 || D > kMaxD || piece <= 0 || (vec != 1 && vec != 4) || (vec == 4 && D % 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const GroupsView gr = groups_view(groups);
#define B11_FWD(V, T)                                                                         \
  forward_launch<V, T>((const int*)ptr, (const int*)cols, R, (const int*)p_row,               \
                       (const int*)p_first, n_pieces, (const int*)big_rows, n_big,            \
                       (const int*)small_rows, n_small, piece, table, D, (const int*)ids, B,  \
                       gr, (float*)part, (float*)out, st)
  switch (dtype * 2 + (vec == 4)) {
    case 0: return B11_FWD(1, float);
    case 1: return B11_FWD(4, float);
    case 2: return B11_FWD(1, __nv_bfloat16);
    case 3: return B11_FWD(4, __nv_bfloat16);
    case 4: return B11_FWD(1, __half);
    case 5: return B11_FWD(4, __half);
    default: return (int)cudaErrorInvalidValue;
  }
#undef B11_FWD
}

// Backward: dtable [N, D] of dtype (every row written once) from gout
// float32 [B, D], the grouping of the ids (as the forward's), and the
// transposed history (tptr [N + 1], tcols: the history rows holding each
// table row, increasing) with its static pieces; gsum float32 [B, D] and
// part float32 [n_pieces, D] scratch.
extern "C" int rating_vector_backward(const void* tptr, const void* tcols, int N,
                                      const void* p_row, const void* p_first, int n_pieces,
                                      const void* big_rows, int n_big, const void* small_rows,
                                      int n_small, int piece, const void* gout, int D, int vec,
                                      const void* const* groups, void* gsum, void* part,
                                      int dtype, void* dtable, void* stream) {
  if (D <= 0 || D > kMaxD || piece <= 0 || (vec != 1 && vec != 4) || (vec == 4 && D % 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const GroupsView gr = groups_view(groups);
#define B11_BWD(V, T)                                                                          \
  backward_launch<V, T>((const int*)tptr, (const int*)tcols, N, (const int*)p_row,             \
                        (const int*)p_first, n_pieces, (const int*)big_rows, n_big,            \
                        (const int*)small_rows, n_small, piece, (const float*)gout, D, gr,     \
                        (float*)gsum, (float*)part, dtable, st)
  switch (dtype * 2 + (vec == 4)) {
    case 0: return B11_BWD(1, float);
    case 1: return B11_BWD(4, float);
    case 2: return B11_BWD(1, __nv_bfloat16);
    case 3: return B11_BWD(4, __nv_bfloat16);
    case 4: return B11_BWD(1, __half);
    case 5: return B11_BWD(4, __half);
    default: return (int)cudaErrorInvalidValue;
  }
#undef B11_BWD
}
