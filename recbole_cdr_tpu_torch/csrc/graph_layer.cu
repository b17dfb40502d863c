// B8: one BiTGCF graph layer, its sparse-dense product over the normalised
// bipartite adjacency with the layer's epilogue and dropout, forward and
// backward.
//
// Replaces recbole_cdr_tpu/models/bitgcf.py:116-123 BiTGCF._graph_layer (an
// XLA BCOO sparse-dense matmul, the elementwise epilogue and
// jax.random.bernoulli dropout) and its autodiff.
//
//   forward:  side_i = sum_j L_ij x_j
//             new_i  = x_i + side_i + x_i * side_i
//             new_i  = mask_i ? new_i / keep : 0          (training dropout)
//   backward: g'_i   = mask_i ? g_i / keep : 0
//             h_j    = g'_j + g'_j * x_j                  (cotangent of side)
//             gx_i   = (g'_i + g'_i * side_i) + sum_j LT_ij h_j
//
// The dropout mask comes from uint32 bits, one per element, as JAX's
// bernoulli derives it from its uniform draw: u = bitcast_f32((b >> 9) |
// 0x3F800000) - 1, mask = u < keep. Fed JAX's bits, the mask is JAX's.
//
// Bound on an H100: bytes. Per row the product does 2 flops per nonzero and
// column against 4 bytes of the gathered row, far below the card's float32
// balance point. x [~50,400 x 64] is 12.9 MB and sits in the 50 MB L2, so the
// nnz x D gathers are L2 traffic (about 113 MB a float32 layer of the bench
// pair's source graph); device memory sees the CSR, x, the bits and the
// outputs once each.
//
// Design. The graph's degrees follow a power law (the bench pair's source
// graph: median degree 2, mean 9, a row of 14,159 nonzeros), so the work is
// cut into pieces of at most `piece` nonzeros of one row (the host builds
// the schedule once per graph, ops/graph_layer.py::make_csr), the rows of
// several pieces first, and a block takes kPieces consecutive pieces, one a
// group of G lanes (G * kLaneColumns >= D where it fits). The time is the
// latency of each piece's chain of loads (its header, its (col, val), its
// rows, the epilogue), so the design keeps chains short and many groups
// resident: a group loads its piece's (col, val) kRound at a time, coalesced,
// one pair a lane, and broadcasts them by shuffles; each lane loads eight
// columns of kRound rows (16-byte loads in every form) before their FMAs, in
// CSR order; the epilogue's operands are loaded after the product, which
// keeps registers low. One launch finishes every row:
// - a row of one piece gets its epilogue from its group's registers;
// - the pieces of a row inside one block are summed in shared memory in
//   piece order by the row's first group there (blocks without such a row
//   pass no barrier);
// - a row over several blocks (the schedule's split rows) writes one
//   float32 partial per block; the row's last block to arrive, which an
//   integer counter names, sums the partials in block order and applies the
//   epilogue, then sets the counter back to 0 for the next launch.
// So the longest row's pieces run in 28 blocks side by side, ahead of the
// light rows, and then one gather of 28 partials: no second launch, no
// serial chain over the pieces. No float atomic: every output element is
// summed in one order that the schedule fixes, so the result is
// bit-reproducible run to run. The backward is the same product on the
// transposed CSR (the kernel does not assume L symmetric), after an
// elementwise launch that forms h (16 bytes a thread); forming h from
// gathered g, x and bits inside the product instead would triple the
// gathered bytes, and a grid barrier in place of the second launch saves
// no bytes. The epilogues use round-to-nearest intrinsics so that no
// multiply-add is contracted: they round as the plain PyTorch version does.
// probe_graph_layer.py times the kernel beside variants of these choices.
//
// B8-bf16, the 16-bit form (BiTGCF under compute_dtype: bfloat16; float16
// through the same template): x, the CSR's values, the upstream gradient
// and every output are 16-bit, as JAX's bf16 propagation has them
// (bitgcf.py:62-88 casts the adjacency and the degrees). Rows are loaded as
// 16-bit values and widened exactly; each row's sparse sum, the partials
// included, accumulates in float32 and is rounded where JAX's value has a
// 16-bit type: side; new = x + side + x * side, computed in float32 from the
// 16-bit x and side; the dropout's new / keep; in the backward g' = g / keep,
// h = g' + g' * x (stored 16-bit, the cotangent of side) and gx. The float32
// form is the same template with every rounding the identity.

#include <cuda_runtime.h>
#include <stdint.h>

#include "float16.cuh"

namespace {

constexpr int kPieces = 16;   // pieces a block, one a group (PIECES_PER_BLOCK)
constexpr int kRound = 4;     // nonzeros a group gathers at once (rows in flight)
constexpr int kLaneColumns = 8;  // columns of a gathered row a lane loads (16-byte loads)
constexpr int kSingle = -2;   // a piece's slot: the row's only piece
constexpr int kPrepThreads = 256;

template <int VEC>
struct F {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ F<VEC> zeros() {
  F<VEC> r;
#pragma unroll
  for (int v = 0; v < VEC; ++v) r.v[v] = 0.f;
  return r;
}

// VEC values of T as loaded: one value widened, or VEC * sizeof(T) bytes in
// 16-byte loads kept packed until widen
template <int N>
struct Raw {
  uint4 q[N];
};

template <int VEC, typename T>
__device__ __forceinline__ auto raw_load(const T* p) {
  if constexpr (VEC == 1) {
    return ld1(p);
  } else {
    constexpr int N = VEC * (int)sizeof(T) / 16;
    Raw<N> r;
#pragma unroll
    for (int i = 0; i < N; ++i) r.q[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
    return r;
  }
}

template <int VEC, typename T, typename R>
__device__ __forceinline__ F<VEC> widen(const R& raw) {
  F<VEC> r;
  if constexpr (VEC == 1) {
    r.v[0] = raw;
  } else {
    constexpr int N = VEC * (int)sizeof(T) / 16, PER = VEC / N;  // values a 16-byte load
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const unsigned w[4] = {raw.q[i].x, raw.q[i].y, raw.q[i].z, raw.q[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kWide<T>) {
          r.v[i * PER + j] = __uint_as_float(w[j]);
        } else {
          r.v[i * PER + 2 * j] = from_bits<T>(w[j] & 0xFFFFu);
          r.v[i * PER + 2 * j + 1] = from_bits<T>(w[j] >> 16);
        }
      }
    }
  }
  return r;
}

template <int VEC, typename T>
__device__ __forceinline__ F<VEC> load(const T* p) {
  return widen<VEC, T>(raw_load<VEC, T>(p));
}

// float32 values: shared memory and the partials (16-byte aligned for VEC > 1)
template <int VEC>
__device__ __forceinline__ void store_f(float* p, const F<VEC>& r) {
  if constexpr (VEC == 1) {
    *p = r.v[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(r.v[4 * i], r.v[4 * i + 1], r.v[4 * i + 2], r.v[4 * i + 3]);
  }
}

template <int VEC>
__device__ __forceinline__ F<VEC> load_f(const float* p) {
  F<VEC> r;
  if constexpr (VEC == 1) {
    r.v[0] = *p;
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      r.v[4 * i] = t.x; r.v[4 * i + 1] = t.y; r.v[4 * i + 2] = t.z; r.v[4 * i + 3] = t.w;
    }
  }
  return r;
}

// the partials other blocks wrote in this launch: from L2, past L1
template <int VEC>
__device__ __forceinline__ F<VEC> load_cg(const float* p) {
  F<VEC> r;
  if constexpr (VEC == 1) {
    r.v[0] = __ldcg(p);
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 t = __ldcg(reinterpret_cast<const float4*>(p) + i);
      r.v[4 * i] = t.x; r.v[4 * i + 1] = t.y; r.v[4 * i + 2] = t.z; r.v[4 * i + 3] = t.w;
    }
  }
  return r;
}

// values already rounded to T (rnd<T>), stored in T
template <int VEC, typename T>
__device__ __forceinline__ void store_t(T* p, const F<VEC>& r) {
  if constexpr (VEC == 1) {
    st1(p, r.v[0]);
  } else if constexpr (kWide<T>) {
    store_f<VEC>(p, r);
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 8; ++i) {
      unsigned w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = to_bits<T>(r.v[8 * i + 2 * j]) | (to_bits<T>(r.v[8 * i + 2 * j + 1]) << 16);
      reinterpret_cast<uint4*>(p)[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <int VEC>
__device__ __forceinline__ void load_bits(const int* p, int (&b)[VEC]) {
  if constexpr (VEC == 1) {
    b[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(p) + i);
      b[4 * i] = t.x; b[4 * i + 1] = t.y; b[4 * i + 2] = t.z; b[4 * i + 3] = t.w;
    }
  }
}

__device__ __forceinline__ bool kept(int bits, float keep) {
  const float u = __uint_as_float(((unsigned)bits >> 9) | 0x3F800000u) - 1.0f;
  return u < keep;
}

// The dense operands of the epilogue, of the table's type T.
//   forward:  a = x,  b unused,  out0 = new, out1 = side
//   backward: a = g,  b = side,  out0 = gx,  out1 unused
template <typename T>
struct Epilogue {
  const T* a;
  const T* b;
  const int* bits;
  float keep;
  T* out0;
  T* out1;
};

// the epilogue's loads for one lane's columns (issued before the partials'
// loads where a split row is finished, so that the two overlap)
template <int VEC, bool BWD, bool DROP>
struct Pre {
  F<VEC> a;
  F<VEC> b;
  int bits[VEC];
};

template <int VEC, typename T, bool BWD, bool DROP>
__device__ __forceinline__ Pre<VEC, BWD, DROP> prefetch(const Epilogue<T>& e, long long off) {
  Pre<VEC, BWD, DROP> r;
  r.a = load<VEC, T>(e.a + off);
  if constexpr (BWD) r.b = load<VEC, T>(e.b + off);
  if constexpr (DROP) load_bits<VEC>(e.bits + off, r.bits);
  return r;
}

template <int VEC, typename T, bool BWD, bool DROP>
__device__ __forceinline__ void finish(const Epilogue<T>& e, long long off,
                                       const Pre<VEC, BWD, DROP>& pre, const F<VEC>& acc) {
  F<VEC> out;
  if constexpr (BWD) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float gp = pre.a.v[v];
      if constexpr (DROP) gp = kept(pre.bits[v], e.keep) ? rnd<T>(__fdiv_rn(gp, e.keep)) : 0.f;
      out.v[v] = rnd<T>(__fadd_rn(__fadd_rn(gp, __fmul_rn(gp, pre.b.v[v])), acc.v[v]));
    }
  } else {
    F<VEC> side;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float a = pre.a.v[v];
      side.v[v] = rnd<T>(acc.v[v]);
      float nw = rnd<T>(__fadd_rn(__fadd_rn(a, side.v[v]), __fmul_rn(a, side.v[v])));
      if constexpr (DROP) nw = kept(pre.bits[v], e.keep) ? rnd<T>(__fdiv_rn(nw, e.keep)) : 0.f;
      out.v[v] = nw;
    }
    store_t<VEC, T>(e.out1 + off, side);
  }
  store_t<VEC, T>(e.out0 + off, out);
}

// sum over nonzeros k in [lo, hi) of val[k] * src[col[k], c .. c+VEC), in
// CSR order and in float32. The group's lanes load kRound (col, val) pairs
// at once, coalesced, and every lane takes each pair by a shuffle, then
// loads its columns of the pair's row; kRound rows are in flight, packed,
// before their FMAs. A lane whose columns lie past D (`on` false) takes part
// in the shuffles and loads nothing.
template <int VEC, int G, typename T>
__device__ __forceinline__ F<VEC> gather_sum(const int* __restrict__ col,
                                             const T* __restrict__ val,
                                             const T* __restrict__ src, int lo, int hi, int D,
                                             int c, int t, unsigned mask, bool on) {
  constexpr int J = kRound > G ? kRound / G : 1;  // pairs a lane loads a round
  F<VEC> acc = zeros<VEC>();
  for (int k0 = lo; k0 < hi; k0 += kRound) {
    int cj[J];
    float wj[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int u = t + j * G;
      const bool ok = u < kRound && k0 + u < hi;
      cj[j] = ok ? __ldg(col + k0 + u) : 0;
      wj[j] = ok ? ld1(val + k0 + u) : 0.f;
    }
    const int n = min(kRound, hi - k0);
    decltype(raw_load<VEC, T>(src)) s[kRound];  // packed
    float w[kRound];
#pragma unroll
    for (int u = 0; u < kRound; ++u) {
      const int cu = __shfl_sync(mask, cj[u / G], u % G, G);
      w[u] = __shfl_sync(mask, wj[u / G], u % G, G);
      if (on && u < n) s[u] = raw_load<VEC, T>(src + (long long)cu * D + c);
    }
    if (on) {
#pragma unroll
      for (int u = 0; u < kRound; ++u) {
        if (u < n) {
          const F<VEC> r = widen<VEC, T>(s[u]);
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc.v[v] = fmaf(w[u], r.v[v], acc.v[v]);
        }
      }
    }
  }
  return acc;
}

// a + b elementwise, in that order
template <int VEC>
__device__ __forceinline__ void add_to(F<VEC>& a, const F<VEC>& b) {
#pragma unroll
  for (int v = 0; v < VEC; ++v) a.v[v] = __fadd_rn(a.v[v], b.v[v]);
}

// The schedule of one CSR (see ops/graph_layer.py::make_csr): per piece
// (row, lo, hi, slot), slot kSingle for a row's only piece, -1 for a piece
// of a row inside one block (or not its block's first of the row), else the
// float32 partial slot that the piece's block writes for its row; split row
// h owns the slots split_ptr[h] .. split_ptr[h + 1] in block order, and
// slot_owner[s] names the split row of slot s; split_count[h] counts the
// blocks of row h that are done (0 between launches).
template <typename T>
struct Schedule {
  const int4* pieces;
  int n_pieces;
  const int* col;
  const T* val;
  const int* slot_owner;
  const int* split_ptr;
  int* split_count;
};

// a block of kPieces groups of G lanes, one piece a group; VEC columns a lane
template <int VEC, int G, typename T, bool BWD, bool DROP>
__global__ void __launch_bounds__(kPieces * G)
    product_kernel(Schedule<T> s, const T* __restrict__ src, float* __restrict__ partial,
                   Epilogue<T> e, int D) {
  constexpr int W = G * VEC;  // columns a pass
  __shared__ __align__(16) float s_acc[kPieces][W];
  __shared__ int s_row[kPieces];
  const int gid = threadIdx.x / G;
  const int t = threadIdx.x % G;
  const unsigned mask =
      (unsigned)((1ull << G) - 1) << ((threadIdx.x & 31) & ~(G - 1));
  const long long p = (long long)blockIdx.x * kPieces + gid;
  int4 pc = make_int4(-1, 0, 0, -1);  // past the last piece: no row, no work
  if (p < s.n_pieces) pc = __ldg(s.pieces + p);
  const int row = pc.x, lo = pc.y, hi = pc.z, slot = pc.w;
  if (t == 0) s_row[gid] = row;
  const bool single = slot == kSingle;
  // blocks without a row of several pieces (most) never wait on each other
  const bool several = __syncthreads_or(!single && row >= 0);
  for (int c0 = 0; c0 < D; c0 += W) {
    const int c = c0 + t * VEC;
    const bool on = row >= 0 && c < D;
    const long long off = (long long)row * D + c;
    const F<VEC> acc = gather_sum<VEC, G, T>(s.col, s.val, src, lo, hi, D, c, t, mask, on);
    if (single) {
      if (on) finish<VEC, T, BWD, DROP>(e, off, prefetch<VEC, T, BWD, DROP>(e, off), acc);
    } else {
      store_f<VEC>(&s_acc[gid][t * VEC], acc);
    }
    if (!several) continue;
    __syncthreads();
    // the first group of each run of one row's pieces in this block sums the
    // run in piece order
    if (!single && row >= 0 && (gid == 0 || s_row[gid - 1] != row)) {
      F<VEC> sum = load_f<VEC>(&s_acc[gid][t * VEC]);
      for (int q = gid + 1; q < kPieces && s_row[q] == row; ++q)
        add_to<VEC>(sum, load_f<VEC>(&s_acc[q][t * VEC]));
      if (on) {
        if (slot < 0)
          finish<VEC, T, BWD, DROP>(e, off, prefetch<VEC, T, BWD, DROP>(e, off), sum);
        else
          store_f<VEC>(partial + (long long)slot * D + c, sum);
      }
    }
    __syncthreads();
  }
  if (slot < 0) return;
  // a split row: the last of its blocks to arrive sums their partials in
  // block order
  __threadfence();
  __syncwarp(mask);
  const int h = __ldg(s.slot_owner + slot);
  const int s0 = __ldg(s.split_ptr + h), s1 = __ldg(s.split_ptr + h + 1);
  int last = 0;
  if (t == 0) last = atomicAdd(s.split_count + h, 1) == s1 - s0 - 1;
  if (!__shfl_sync(mask, last, 0, G)) return;
  __threadfence();
  for (int c = t * VEC; c < D; c += W) {
    const long long off = (long long)row * D + c;
    const Pre<VEC, BWD, DROP> pre = prefetch<VEC, T, BWD, DROP>(e, off);
    F<VEC> sum = load_cg<VEC>(partial + (long long)s0 * D + c);
    int q = s0 + 1;
    for (; q + 8 <= s1; q += 8) {
      F<VEC> r[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) r[u] = load_cg<VEC>(partial + (long long)(q + u) * D + c);
#pragma unroll
      for (int u = 0; u < 8; ++u) add_to<VEC>(sum, r[u]);
    }
    for (; q < s1; ++q) add_to<VEC>(sum, load_cg<VEC>(partial + (long long)q * D + c));
    finish<VEC, T, BWD, DROP>(e, off, pre, sum);
  }
  if (t == 0) s.split_count[h] = 0;  // ready for the next launch
}

// h = g' + g' * x, elementwise over [n, D] in runs of VEC, rounded to T
template <int VEC, typename T, bool DROP>
__global__ void prep_kernel(const T* __restrict__ g, const T* __restrict__ x,
                            const int* __restrict__ bits, float keep, T* __restrict__ h,
                            long long runs) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < runs;
       i += (long long)gridDim.x * blockDim.x) {
    const long long off = i * VEC;
    const F<VEC> gv = load<VEC, T>(g + off), xv = load<VEC, T>(x + off);
    int b[VEC];
    if constexpr (DROP) load_bits<VEC>(bits + off, b);
    F<VEC> r;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float gp = gv.v[v];
      if constexpr (DROP) gp = kept(b[v], keep) ? rnd<T>(__fdiv_rn(gp, keep)) : 0.f;
      r.v[v] = rnd<T>(__fadd_rn(gp, __fmul_rn(gp, xv.v[v])));
    }
    store_t<VEC, T>(h + off, r);
  }
}

bool aligned(const void* p) { return p == nullptr || ((uintptr_t)p & 15) == 0; }

template <int VEC, int G, typename T, bool BWD>
void launch(const Schedule<T>& s, const T* src, float* partial, const Epilogue<T>& e, int D,
            cudaStream_t stream) {
  const unsigned blocks = (unsigned)((s.n_pieces + kPieces - 1) / kPieces);
  if (e.bits)
    product_kernel<VEC, G, T, BWD, true><<<blocks, kPieces * G, 0, stream>>>(s, src, partial, e, D);
  else
    product_kernel<VEC, G, T, BWD, false><<<blocks, kPieces * G, 0, stream>>>(s, src, partial, e, D);
}

// kLaneColumns a lane where D is a multiple of them and every dense operand
// is 16-byte aligned, with the fewest lanes a group (4, 8, 16 or 32) that
// cover a row; else one column a lane, 32 lanes a group. The prep kernel
// takes 16 bytes a thread.
template <typename T>
constexpr int kPrepVec = 16 / (int)sizeof(T);

template <typename T>
bool vec_ok(const void* src, const float* partial, const Epilogue<T>& e, int D) {
  return D % kLaneColumns == 0 && aligned(src) && aligned(partial) && aligned(e.a) &&
         aligned(e.b) && aligned(e.bits) && aligned(e.out0) && aligned(e.out1);
}

template <typename T, bool BWD>
void product(const Schedule<T>& s, const T* src, float* partial, const Epilogue<T>& e, int D,
             cudaStream_t stream) {
  constexpr int V = kLaneColumns;
  if (!vec_ok<T>(src, partial, e, D)) {
    launch<1, 32, T, BWD>(s, src, partial, e, D, stream);
    return;
  }
  const int lanes = D / V;
  if (lanes <= 4)
    launch<V, 4, T, BWD>(s, src, partial, e, D, stream);
  else if (lanes <= 8)
    launch<V, 8, T, BWD>(s, src, partial, e, D, stream);
  else if (lanes <= 16)
    launch<V, 16, T, BWD>(s, src, partial, e, D, stream);
  else
    launch<V, 32, T, BWD>(s, src, partial, e, D, stream);
}

template <typename T>
Schedule<T> schedule(const void* pieces, int n_pieces, const void* col, const void* val,
                     const void* slot_owner, const void* split_ptr, void* split_count) {
  return Schedule<T>{(const int4*)pieces,     n_pieces,
                     (const int*)col,         (const T*)val,
                     (const int*)slot_owner,  (const int*)split_ptr,
                     (int*)split_count};
}

template <typename T>
int forward_t(const Schedule<T>& s, const void* x, const void* bits, float keep, void* out_new,
              void* out_side, void* partial, int n, int D, cudaStream_t stream) {
  if (n > 0 && D > 0) {
    const Epilogue<T> e{(const T*)x, nullptr, (const int*)bits, keep, (T*)out_new,
                        (T*)out_side};
    product<T, false>(s, (const T*)x, (float*)partial, e, D, stream);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int backward_t(const Schedule<T>& s, const void* x, const void* side, const void* bits,
               float keep, const void* g, void* h, void* gx, void* partial, int n, int D,
               cudaStream_t st) {
  if (n > 0 && D > 0) {
    const Epilogue<T> e{(const T*)g, (const T*)side, (const int*)bits, keep, (T*)gx, nullptr};
    const bool vec = D % kPrepVec<T> == 0 && aligned(g) && aligned(x) && aligned(bits) &&
                     aligned(h);
    const int V = vec ? kPrepVec<T> : 1;
    const long long runs = (long long)n * D / V;
    const unsigned blocks = (unsigned)(runs < 132LL * 8 * kPrepThreads
                                           ? (runs + kPrepThreads - 1) / kPrepThreads
                                           : 132LL * 8);
    const T *gp = (const T*)g, *xp = (const T*)x;
    const int* bp = (const int*)bits;
    T* hp = (T*)h;
    if (vec && bits)
      prep_kernel<kPrepVec<T>, T, true><<<blocks, kPrepThreads, 0, st>>>(gp, xp, bp, keep, hp, runs);
    else if (vec)
      prep_kernel<kPrepVec<T>, T, false><<<blocks, kPrepThreads, 0, st>>>(gp, xp, bp, keep, hp, runs);
    else if (bits)
      prep_kernel<1, T, true><<<blocks, kPrepThreads, 0, st>>>(gp, xp, bp, keep, hp, runs);
    else
      prep_kernel<1, T, false><<<blocks, kPrepThreads, 0, st>>>(gp, xp, bp, keep, hp, runs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    product<T, true>(s, (const T*)h, (float*)partial, e, D, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16, the type of val, x, the outputs
// (and in the backward side, g and the scratch h); pieces: int32 [n_pieces,
// 4], laid out pieces_per_block to a block, which must be kPieces (else
// cudaErrorInvalidValue: the schedule's slots would not match the launch's
// blocks); partial: float32 scratch of [slots, D], slots = slot_owner's
// length; split_count: int32 zeros, left zero
extern "C" int graph_layer_forward(const void* pieces, int n_pieces, int pieces_per_block,
                                   const void* col, const void* val, const void* slot_owner,
                                   const void* split_ptr, void* split_count, const void* x,
                                   const void* bits, float keep, void* out_new, void* out_side,
                                   void* partial, int n, int D, int dtype, void* stream) {
  if (pieces_per_block != kPieces) return (int)cudaErrorInvalidValue;
#define B8_FWD(T)                                                                          \
  forward_t<T>(schedule<T>(pieces, n_pieces, col, val, slot_owner, split_ptr, split_count), \
               x, bits, keep, out_new, out_side, partial, n, D, (cudaStream_t)stream)
  if (dtype == 0) return B8_FWD(float);
  if (dtype == 1) return B8_FWD(__nv_bfloat16);
  if (dtype == 2) return B8_FWD(__half);
#undef B8_FWD
  return (int)cudaErrorInvalidValue;
}

// h: scratch of [n, D] of the dtype's type
extern "C" int graph_layer_backward(const void* pieces, int n_pieces, int pieces_per_block,
                                    const void* col_t, const void* val_t,
                                    const void* slot_owner, const void* split_ptr,
                                    void* split_count, const void* x, const void* side,
                                    const void* bits, float keep, const void* g, void* h,
                                    void* gx, void* partial, int n, int D, int dtype,
                                    void* stream) {
  if (pieces_per_block != kPieces) return (int)cudaErrorInvalidValue;
#define B8_BWD(T)                                                                             \
  backward_t<T>(schedule<T>(pieces, n_pieces, col_t, val_t, slot_owner, split_ptr,             \
                            split_count),                                                      \
                x, side, bits, keep, g, h, gx, partial, n, D, (cudaStream_t)stream)
  if (dtype == 0) return B8_BWD(float);
  if (dtype == 1) return B8_BWD(__nv_bfloat16);
  if (dtype == 2) return B8_BWD(__half);
#undef B8_BWD
  return (int)cudaErrorInvalidValue;
}
