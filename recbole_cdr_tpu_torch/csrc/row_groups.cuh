// A step's ids grouped by row, as the fixed-order sums read it (K1's
// backward in csrc/gather_dot.cu, B6 in csrc/sparse_adam.cu, the row-sharded
// lookup's backward in csrc/row_groups.cu, which also builds it), and the
// helpers those kernels share: a row's lanes and 16-byte loads of its
// values.
//
// A grouping of ids [R] over the rows [offset, offset + L) of a table (or a
// shard of one): for each distinct row the step names ("head"), the
// positions j of its occurrences, ascending. Ids outside the rows are left
// out. Heads come in no set order (the plan kernel numbers them as blocks
// claim them); each head's positions are in position order, so a sum over
// them runs in the order the ids alone fix. ops/build.py hashes this header
// into every library's name, so an edit here rebuilds them.

#pragma once

#include "float16.cuh"

namespace {

// A grouping as its consumers read it (int32 arrays written by the plan
// kernel): meta[0] the occurrences inside the rows, meta[1] the heads H,
// meta[2] the heads of more than kBigTerms positions; for h < H,
// head_row[h] its row (local: id - offset), pos[head_start[h] ..
// + head_len[h]) its positions, ascending; row_head[r] the head of local row
// r where it names r back (the array is never cleared: an entry left by an
// earlier step fails that test); big[0 .. meta[2]) the heads of more than
// kBigTerms positions, in no set order.
struct GroupsView {
  const int* meta;
  const int* head_row;
  const int* head_start;
  const int* head_len;
  const int* pos;
  const int* row_head;
  const int* big;
};

// a head of more positions is summed by a whole block (block_terms), not by
// a row group
constexpr int kBigTerms = 64;

// the view of a C array of the seven arrays' addresses, in that order
inline GroupsView groups_view(const void* const* a) {
  return {(const int*)a[0], (const int*)a[1], (const int*)a[2], (const int*)a[3],
          (const int*)a[4], (const int*)a[5], (const int*)a[6]};
}

// the head of local row r, or -1 when no id of the step names the row
__device__ __forceinline__ int head_of(const GroupsView& g, int r) {
  const int h = __ldg(g.row_head + r);
  return (unsigned)h < (unsigned)__ldg(g.meta + 1) && __ldg(g.head_row + h) == r ? h : -1;
}

// A warp's lanes over rows of D values: `per_warp` rows at a time, G lanes
// each, VEC consecutive values a lane (one 16-byte load: 4 float32 or 8
// 16-bit values; 1 for the scalar form), `steps` column steps of G VEC values.
struct RowGeo {
  int G, per_warp, steps;
};

template <int VEC>
__host__ __device__ inline RowGeo row_geo(int D) {
  const int need = (D + VEC - 1) / VEC;
  int G = 1;
  while (G < need && G < 32) G <<= 1;
  return {G, 32 / G, (need + G - 1) / G};
}

// the 16-byte form's values a lane of a row of T takes: 4 float32 or 8 16-bit
template <typename T>
constexpr int kVec = kWide<T> ? 4 : 8;

// VEC values of T at p widened to float32 (p 16-byte aligned when VEC > 1)
template <int VEC, typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = ld1(p);
  } else if constexpr (kWide<T>) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = from_bits<T>(w[k] & 0xFFFFu);
      v[2 * k + 1] = from_bits<T>(w[k] >> 16);
    }
  }
}

// VEC float32 values stored at p as T, each rounded once to nearest in T
template <int VEC, typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    st1(p, v[0]);
  } else if constexpr (kWide<T>) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint4 x;
    x.x = to_bits<T>(v[0]) | to_bits<T>(v[1]) << 16;
    x.y = to_bits<T>(v[2]) | to_bits<T>(v[3]) << 16;
    x.z = to_bits<T>(v[4]) | to_bits<T>(v[5]) << 16;
    x.w = to_bits<T>(v[6]) | to_bits<T>(v[7]) << 16;
    *reinterpret_cast<uint4*>(p) = x;
  }
}

// One term of a row's sum: the row of the source table it adds, and its
// weight (1 where the sum is unweighted).
struct Term {
  int row;
  float w;
};

// The row group's sum, at columns d .. d + VEC, of its terms k = 0 .. n - 1
// in order: acc = acc + w_k src[row_k] (acc + src[row_k] unweighted), each
// product and add rounded to nearest, so the sum is the one a sequential
// loop over k gives. Its G lanes fetch G terms at once (term_of(k), lane k
// mod G), the next G while the current ones' rows load, and load U rows of
// src before adding them: a row of many terms waits about one memory latency
// per U terms, not three per term (a grouped head of more than kBigTerms goes
// to block_terms). U trades registers for loads in flight. Every lane of the
// group calls it with the same n.
template <int VEC, int U, bool kWeighted, typename T, typename TermOf>
__device__ __forceinline__ void add_terms(int n, TermOf term_of, const T* __restrict__ src,
                                          int D, int d, const RowGeo& geo, float (&acc)[VEC]) {
  const int lane = threadIdx.x & 31, gl = lane % geo.G;
  const unsigned mask =
      geo.G == 32 ? 0xffffffffu : ((1u << geo.G) - 1) << (lane / geo.G * geo.G);
  Term next = gl < n ? term_of(gl) : Term{0, 0.f};
  for (int k0 = 0; k0 < n; k0 += geo.G) {
    const Term mine = next;
    if (k0 + geo.G < n) next = k0 + geo.G + gl < n ? term_of(k0 + geo.G + gl) : Term{0, 0.f};
    const int m = n - k0 < geo.G ? n - k0 : geo.G;
    for (int t = 0; t < m; t += U) {
      float v[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int row = __shfl_sync(mask, mine.row, t + u, geo.G);
        if (t + u < m && d < D) load_vec<VEC>(src + (long long)row * D + d, v[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float w = __shfl_sync(mask, mine.w, t + u, geo.G);
        if (t + u >= m || d >= D) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[e] = kWeighted ? __fadd_rn(acc[e], __fmul_rn(w, v[u][e]))
                             : __fadd_rn(acc[e], v[u][e]);
      }
    }
  }
}

// A head of more than kBigTerms terms, summed by a block: chunks of
// big_chunk(D) terms, the chunk's terms fetched a thread each, their
// products (w_k src[row_k], rounded as add_terms rounds them) written to
// shared memory by every thread in 16-byte loads, then each column added up
// by one thread in term order. Shared memory: big_smem_bytes(D).
// the widest row the block path takes (its shared memory stays under 48 KB)
constexpr int kMaxD = 1024;

__host__ __device__ inline int big_chunk(int D) {
  const int c = 8192 / D;
  return c < 8 ? 8 : c > 256 ? 256 : c;
}

inline size_t big_smem_bytes(int D) {
  const int c = big_chunk(D);
  return sizeof(float) * ((size_t)c * D + 2 * c + D);
}

// The block's sum of one row's n terms in order (the sum add_terms gives),
// left in shared memory at the returned address, D floats. Every thread of
// the block calls it; it ends with a barrier. VEC > 1 needs D % VEC == 0.
template <int VEC, bool kWeighted, typename T, typename TermOf>
__device__ float* block_terms(int n, TermOf term_of, const T* __restrict__ src, int D,
                              float* smem) {
  const int chunk = big_chunk(D), per_row = D / VEC;
  float* prod = smem;
  int* rows = reinterpret_cast<int*>(smem + chunk * D);
  float* w = smem + chunk * D + chunk;
  float* sum = w + chunk;
  for (int c = threadIdx.x; c < D; c += blockDim.x) sum[c] = 0.f;
  for (int k0 = 0; k0 < n; k0 += chunk) {
    const int m = n - k0 < chunk ? n - k0 : chunk;
    for (int t = threadIdx.x; t < m; t += blockDim.x) {
      const Term x = term_of(k0 + t);
      rows[t] = x.row;
      w[t] = x.w;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m * per_row; i += blockDim.x) {
      const int k = i / per_row, c = i % per_row * VEC;
      float v[VEC];
      load_vec<VEC>(src + (long long)rows[k] * D + c, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) prod[k * D + c + e] = kWeighted ? __fmul_rn(w[k], v[e]) : v[e];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float a = sum[c];
      for (int k = 0; k < m; ++k) a = __fadd_rn(a, prod[k * D + c]);
      sum[c] = a;
    }
    __syncthreads();
  }
  return sum;
}

// the number of blocks a grid-stride kernel takes: enough for `work` items
// at `per_block` a block, at most `per_sm` a multiprocessor (0 when the
// device cannot be read)
inline int grid_for(long long work, int per_block, int per_sm) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  const long long need = (work + per_block - 1) / per_block;
  const long long most = (long long)sms * per_sm;
  return (int)(need < 1 ? 1 : need < most ? need : most);
}

}  // namespace
