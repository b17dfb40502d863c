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
// nnz x D gathers are L2 traffic; device memory sees the CSR, x, the bits and
// the outputs once each.
//
// Design. The graph's degrees follow a power law (the bench pair's source
// graph has rows of 13,901 nonzeros beside a mean of 9), so a group per row
// would leave the card waiting on the longest row. The work is cut instead
// into pieces of at most `piece` nonzeros of one row (the host builds the
// schedule once per graph, ops/graph_layer.py::make_csr). A group of G
// threads (a power of two up to a warp, G * 4 >= D where it fits) takes one
// piece: float4 loads along D, eight nonzeros' rows loaded before their
// eight FMAs, in CSR order. A row of one piece gets its epilogue at once; a
// row of several writes one partial per piece, and a second launch sums each
// such row's partials in piece order and applies the epilogue. No atomics:
// every output element is summed in one fixed order, so the result is
// bit-reproducible from run to run. The backward is the same product on the
// transposed CSR (the kernel does not assume L symmetric), after an
// elementwise launch that forms h. The epilogues use round-to-nearest
// intrinsics so that no multiply-add is contracted: they round as the plain
// PyTorch version does. Not done yet: L2 residency control, TMA.
//
// B8-bf16, the 16-bit form (BiTGCF under compute_dtype: bfloat16; float16
// through the same template): x, the CSR's values, the upstream gradient
// and every output are 16-bit, as JAX's bf16 propagation has them
// (bitgcf.py:62-88 casts the adjacency and the degrees). Rows are loaded as
// 16-bit values (8 bytes for four columns) and widened exactly; each row's
// sparse sum, the heavy rows' partials included, accumulates in float32 and
// is rounded where JAX's value has a 16-bit type: side; new = x + side + x *
// side, computed in float32 from the 16-bit x and side; the dropout's new /
// keep; in the backward g' = g / keep, h = g' + g' * x (stored 16-bit, the
// cotangent of side) and gx. The float32 form is the same template with
// every rounding the identity.

#include <cuda_runtime.h>
#include <stdint.h>

#include "float16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

template <int VEC>
struct F {
  float v[VEC];
};

template <int VEC, typename T>
__device__ __forceinline__ F<VEC> load(const T* p) {
  F<VEC> r;
  if constexpr (VEC == 4 && std::is_same_v<T, float>) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = t.x; r.v[1] = t.y; r.v[2] = t.z; r.v[3] = t.w;
  } else if constexpr (VEC == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    r.v[0] = from_bits<T>(t.x & 0xFFFFu); r.v[1] = from_bits<T>(t.x >> 16);
    r.v[2] = from_bits<T>(t.y & 0xFFFFu); r.v[3] = from_bits<T>(t.y >> 16);
  } else {
    r.v[0] = ld1(p);
  }
  return r;
}

// the partial sums' scratch is float32 in every form
template <int VEC>
__device__ __forceinline__ void store(float* p, const F<VEC>& r) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
    *p = r.v[0];
  }
}

// values already rounded to T (rnd<T>), stored in T
template <int VEC, typename T>
__device__ __forceinline__ void store_t(T* p, const F<VEC>& r) {
  if constexpr (std::is_same_v<T, float>) {
    store<VEC>(p, r);
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(to_bits<T>(r.v[0]) | (to_bits<T>(r.v[1]) << 16),
                                              to_bits<T>(r.v[2]) | (to_bits<T>(r.v[3]) << 16));
  } else {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)to_bits<T>(r.v[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void load_bits(const int* p, int (&b)[VEC]) {
  if constexpr (VEC == 4) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p));
    b[0] = t.x; b[1] = t.y; b[2] = t.z; b[3] = t.w;
  } else {
    b[0] = __ldg(p);
  }
}

__device__ __forceinline__ bool kept(int bits, float keep) {
  const float u = __uint_as_float(((unsigned)bits >> 9) | 0x3F800000u) - 1.0f;
  return u < keep;
}

// sum over nonzeros k in [lo, hi) of val[k] * src[col[k], c .. c+VEC), in
// CSR order and in float32; kUnroll rows are loaded before their FMAs
template <int VEC, typename T>
__device__ __forceinline__ F<VEC> range_product(const int* __restrict__ col,
                                                const T* __restrict__ val,
                                                const T* __restrict__ src,
                                                int lo, int hi, int D, int c) {
  F<VEC> acc;
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc.v[v] = 0.f;
  int k = lo;
  for (; k + kUnroll <= hi; k += kUnroll) {
    float w[kUnroll];
    F<VEC> s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      w[u] = ld1(val + k + u);
      s[u] = load<VEC, T>(src + (long long)__ldg(col + k + u) * D + c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc.v[v] = fmaf(w[u], s[u].v[v], acc.v[v]);
  }
  for (; k < hi; ++k) {
    const float w = ld1(val + k);
    const F<VEC> s = load<VEC, T>(src + (long long)__ldg(col + k) * D + c);
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc.v[v] = fmaf(w, s.v[v], acc.v[v]);
  }
  return acc;
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

template <int VEC, typename T, bool BWD, bool DROP>
__device__ __forceinline__ void finish(const Epilogue<T>& e, long long off, const F<VEC>& acc) {
  const F<VEC> a = load<VEC, T>(e.a + off);
  int b[VEC];
  if constexpr (DROP) load_bits<VEC>(e.bits + off, b);
  F<VEC> out;
  if constexpr (BWD) {
    const F<VEC> side = load<VEC, T>(e.b + off);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float gp = a.v[v];
      if constexpr (DROP) gp = kept(b[v], e.keep) ? rnd<T>(__fdiv_rn(gp, e.keep)) : 0.f;
      out.v[v] = rnd<T>(__fadd_rn(__fadd_rn(gp, __fmul_rn(gp, side.v[v])), acc.v[v]));
    }
  } else {
    F<VEC> side;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      side.v[v] = rnd<T>(acc.v[v]);
      float nw = rnd<T>(
          __fadd_rn(__fadd_rn(a.v[v], side.v[v]), __fmul_rn(a.v[v], side.v[v])));
      if constexpr (DROP) nw = kept(b[v], e.keep) ? rnd<T>(__fdiv_rn(nw, e.keep)) : 0.f;
      out.v[v] = nw;
    }
    store_t<VEC, T>(e.out1 + off, side);
  }
  store_t<VEC, T>(e.out0 + off, out);
}

// one group of 2^glog threads per piece: the piece's product, then the
// epilogue (a row of one piece) or a partial (a row of several)
template <int VEC, typename T, bool BWD, bool DROP>
__global__ void piece_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                             const T* __restrict__ val, const T* __restrict__ src,
                             const int* __restrict__ piece_row,
                             const int* __restrict__ piece_lo,
                             const int* __restrict__ piece_slot, int n_pieces, int piece,
                             float* __restrict__ partial, Epilogue<T> e, int D, int glog) {
  const long long p = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> glog;
  const int G = 1 << glog;
  const int t = threadIdx.x & (G - 1);
  if (p >= n_pieces) return;  // uniform across the piece's group
  const int row = __ldg(piece_row + p);
  const int lo = __ldg(piece_lo + p);
  const int hi = min(lo + piece, __ldg(row_ptr + row + 1));
  const int slot = __ldg(piece_slot + p);
  for (int c = t * VEC; c < D; c += G * VEC) {
    const F<VEC> acc = range_product<VEC, T>(col, val, src, lo, hi, D, c);
    if (slot < 0)
      finish<VEC, T, BWD, DROP>(e, (long long)row * D + c, acc);
    else
      store<VEC>(partial + (long long)slot * D + c, acc);
  }
}

// one group per row of several pieces: its partials summed in piece order,
// then the epilogue
template <int VEC, typename T, bool BWD, bool DROP>
__global__ void heavy_kernel(const int* __restrict__ heavy_row,
                             const int* __restrict__ heavy_ptr, int n_heavy,
                             const float* __restrict__ partial, Epilogue<T> e, int D,
                             int glog) {
  const long long h = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> glog;
  const int G = 1 << glog;
  const int t = threadIdx.x & (G - 1);
  if (h >= n_heavy) return;
  const int row = __ldg(heavy_row + h);
  const int s0 = __ldg(heavy_ptr + h), s1 = __ldg(heavy_ptr + h + 1);
  for (int c = t * VEC; c < D; c += G * VEC) {
    F<VEC> acc = load<VEC, float>(partial + (long long)s0 * D + c);
    int s = s0 + 1;
    for (; s + kUnroll <= s1; s += kUnroll) {
      F<VEC> q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        q[u] = load<VEC, float>(partial + (long long)(s + u) * D + c);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc.v[v] = __fadd_rn(acc.v[v], q[u].v[v]);
    }
    for (; s < s1; ++s) {
      const F<VEC> q = load<VEC, float>(partial + (long long)s * D + c);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc.v[v] = __fadd_rn(acc.v[v], q.v[v]);
    }
    finish<VEC, T, BWD, DROP>(e, (long long)row * D + c, acc);
  }
}

// h = g' + g' * x, elementwise over [n, D], rounded to T
template <typename T, bool DROP>
__global__ void bwd_prep_kernel(const T* __restrict__ g, const T* __restrict__ x,
                                const int* __restrict__ bits, float keep, T* __restrict__ h,
                                long long total) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float gp = ld1(g + i);
    if constexpr (DROP) gp = kept(__ldg(bits + i), keep) ? rnd<T>(__fdiv_rn(gp, keep)) : 0.f;
    F<1> r;
    r.v[0] = rnd<T>(__fadd_rn(gp, __fmul_rn(gp, ld1(x + i))));
    store_t<1, T>(h + i, r);
  }
}

bool aligned(const void* p, unsigned bytes) {
  return p == nullptr || ((uintptr_t)p & (bytes - 1)) == 0;
}

// The schedule of one CSR (see ops/graph_layer.py::make_csr).
template <typename T>
struct Schedule {
  const int* row_ptr;
  const int* col;
  const T* val;
  const int* piece_row;
  const int* piece_lo;
  const int* piece_slot;
  const int* heavy_row;
  const int* heavy_ptr;
  int n_pieces;
  int n_heavy;
  int piece;
};

template <int VEC, typename T, bool BWD, bool DROP>
void launch(const Schedule<T>& s, const T* src, float* partial, const Epilogue<T>& e, int D,
            int glog, cudaStream_t stream) {
  const unsigned pb =
      (unsigned)((((long long)s.n_pieces << glog) + kThreads - 1) / kThreads);
  piece_kernel<VEC, T, BWD, DROP><<<pb, kThreads, 0, stream>>>(
      s.row_ptr, s.col, s.val, src, s.piece_row, s.piece_lo, s.piece_slot, s.n_pieces,
      s.piece, partial, e, D, glog);
  if (s.n_heavy > 0) {
    const unsigned hb =
        (unsigned)((((long long)s.n_heavy << glog) + kThreads - 1) / kThreads);
    heavy_kernel<VEC, T, BWD, DROP><<<hb, kThreads, 0, stream>>>(
        s.heavy_row, s.heavy_ptr, s.n_heavy, partial, e, D, glog);
  }
}

// the product and its epilogue, for the vector width the operands allow:
// four columns a thread where D % 4 == 0 and every dense operand is aligned
// to four values
template <typename T, bool BWD>
void product(const Schedule<T>& s, const T* src, float* partial, const Epilogue<T>& e, int D,
             cudaStream_t stream) {
  const unsigned a4 = 4 * sizeof(T);
  const bool vec_ok = D % 4 == 0 && aligned(src, a4) && aligned(partial, 16) &&
                      aligned(e.a, a4) && aligned(e.b, a4) && aligned(e.bits, 16) &&
                      aligned(e.out0, a4) && aligned(e.out1, a4);
  const int vec = vec_ok ? 4 : 1;
  const int per_row = (D + vec - 1) / vec;
  int glog = 0;
  while ((1 << glog) < per_row && glog < 5) ++glog;
  const bool drop = e.bits != nullptr;
  if (vec == 4) {
    if (drop) launch<4, T, BWD, true>(s, src, partial, e, D, glog, stream);
    else launch<4, T, BWD, false>(s, src, partial, e, D, glog, stream);
  } else {
    if (drop) launch<1, T, BWD, true>(s, src, partial, e, D, glog, stream);
    else launch<1, T, BWD, false>(s, src, partial, e, D, glog, stream);
  }
}

template <typename T>
Schedule<T> schedule(const void* row_ptr, const void* col, const void* val,
                     const void* piece_row, const void* piece_lo, const void* piece_slot,
                     const void* heavy_row, const void* heavy_ptr, int n_pieces, int n_heavy,
                     int piece) {
  return Schedule<T>{(const int*)row_ptr,   (const int*)col,       (const T*)val,
                     (const int*)piece_row, (const int*)piece_lo,  (const int*)piece_slot,
                     (const int*)heavy_row, (const int*)heavy_ptr, n_pieces,
                     n_heavy,               piece};
}

template <typename T>
int forward_t(const void* row_ptr, const void* col, const void* val, const void* piece_row,
              const void* piece_lo, const void* piece_slot, const void* heavy_row,
              const void* heavy_ptr, int n_pieces, int n_heavy, int piece, const void* x,
              const void* bits, float keep, void* out_new, void* out_side, void* partial,
              int n, int D, cudaStream_t stream) {
  if (n > 0 && D > 0) {
    const Schedule<T> s = schedule<T>(row_ptr, col, val, piece_row, piece_lo, piece_slot,
                                      heavy_row, heavy_ptr, n_pieces, n_heavy, piece);
    const Epilogue<T> e{(const T*)x, nullptr, (const int*)bits, keep, (T*)out_new,
                        (T*)out_side};
    product<T, false>(s, (const T*)x, (float*)partial, e, D, stream);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int backward_t(const void* row_ptr_t, const void* col_t, const void* val_t,
               const void* piece_row, const void* piece_lo, const void* piece_slot,
               const void* heavy_row, const void* heavy_ptr, int n_pieces, int n_heavy,
               int piece, const void* x, const void* side, const void* bits, float keep,
               const void* g, void* h, void* gx, void* partial, int n, int D,
               cudaStream_t st) {
  if (n > 0 && D > 0) {
    const long long total = (long long)n * D;
    const unsigned prep_blocks = (unsigned)(total < 132LL * 8 * kThreads
                                                ? (total + kThreads - 1) / kThreads
                                                : 132LL * 8);
    if (bits)
      bwd_prep_kernel<T, true><<<prep_blocks, kThreads, 0, st>>>(
          (const T*)g, (const T*)x, (const int*)bits, keep, (T*)h, total);
    else
      bwd_prep_kernel<T, false><<<prep_blocks, kThreads, 0, st>>>(
          (const T*)g, (const T*)x, nullptr, keep, (T*)h, total);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const Schedule<T> s = schedule<T>(row_ptr_t, col_t, val_t, piece_row, piece_lo,
                                      piece_slot, heavy_row, heavy_ptr, n_pieces, n_heavy,
                                      piece);
    const Epilogue<T> e{(const T*)g, (const T*)side, (const int*)bits, keep, (T*)gx, nullptr};
    product<T, true>(s, (const T*)h, (float*)partial, e, D, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16, the type of val, x, the outputs
// (and in the backward side, g and the scratch h); partial: float32 scratch
// of [slots, D], slots = the pieces of the rows of several pieces
extern "C" int graph_layer_forward(const void* row_ptr, const void* col, const void* val,
                                   const void* piece_row, const void* piece_lo,
                                   const void* piece_slot, const void* heavy_row,
                                   const void* heavy_ptr, int n_pieces, int n_heavy,
                                   int piece, const void* x, const void* bits, float keep,
                                   void* out_new, void* out_side, void* partial, int n,
                                   int D, int dtype, void* stream) {
#define B8_FWD(T)                                                                         \
  forward_t<T>(row_ptr, col, val, piece_row, piece_lo, piece_slot, heavy_row, heavy_ptr, \
               n_pieces, n_heavy, piece, x, bits, keep, out_new, out_side, partial, n, D, \
               (cudaStream_t)stream)
  if (dtype == 0) return B8_FWD(float);
  if (dtype == 1) return B8_FWD(__nv_bfloat16);
  if (dtype == 2) return B8_FWD(__half);
#undef B8_FWD
  return (int)cudaErrorInvalidValue;
}

// h: scratch of [n, D] of the dtype's type
extern "C" int graph_layer_backward(const void* row_ptr_t, const void* col_t,
                                    const void* val_t, const void* piece_row,
                                    const void* piece_lo, const void* piece_slot,
                                    const void* heavy_row, const void* heavy_ptr,
                                    int n_pieces, int n_heavy, int piece, const void* x,
                                    const void* side, const void* bits, float keep,
                                    const void* g, void* h, void* gx, void* partial, int n,
                                    int D, int dtype, void* stream) {
#define B8_BWD(T)                                                                           \
  backward_t<T>(row_ptr_t, col_t, val_t, piece_row, piece_lo, piece_slot, heavy_row,       \
                heavy_ptr, n_pieces, n_heavy, piece, x, side, bits, keep, g, h, gx, partial, \
                n, D, (cudaStream_t)stream)
  if (dtype == 0) return B8_BWD(float);
  if (dtype == 1) return B8_BWD(__nv_bfloat16);
  if (dtype == 2) return B8_BWD(__half);
#undef B8_BWD
  return (int)cudaErrorInvalidValue;
}
