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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

template <int VEC>
struct F {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ F<VEC> load(const float* p) {
  F<VEC> r;
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = t.x; r.v[1] = t.y; r.v[2] = t.z; r.v[3] = t.w;
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const F<VEC>& r) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
    *p = r.v[0];
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
// CSR order; kUnroll rows are loaded before their FMAs
template <int VEC>
__device__ __forceinline__ F<VEC> range_product(const int* __restrict__ col,
                                                const float* __restrict__ val,
                                                const float* __restrict__ src,
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
      w[u] = __ldg(val + k + u);
      s[u] = load<VEC>(src + (long long)__ldg(col + k + u) * D + c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc.v[v] = fmaf(w[u], s[u].v[v], acc.v[v]);
  }
  for (; k < hi; ++k) {
    const float w = __ldg(val + k);
    const F<VEC> s = load<VEC>(src + (long long)__ldg(col + k) * D + c);
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc.v[v] = fmaf(w, s.v[v], acc.v[v]);
  }
  return acc;
}

// The dense operands of the epilogue.
//   forward:  a = x,  b unused,  out0 = new, out1 = side
//   backward: a = g,  b = side,  out0 = gx,  out1 unused
struct Epilogue {
  const float* a;
  const float* b;
  const int* bits;
  float keep;
  float* out0;
  float* out1;
};

template <int VEC, bool BWD, bool DROP>
__device__ __forceinline__ void finish(const Epilogue& e, long long off, const F<VEC>& acc) {
  const F<VEC> a = load<VEC>(e.a + off);
  int b[VEC];
  if constexpr (DROP) load_bits<VEC>(e.bits + off, b);
  F<VEC> out;
  if constexpr (BWD) {
    const F<VEC> side = load<VEC>(e.b + off);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float gp = a.v[v];
      if constexpr (DROP) gp = kept(b[v], e.keep) ? __fdiv_rn(gp, e.keep) : 0.f;
      out.v[v] = __fadd_rn(__fadd_rn(gp, __fmul_rn(gp, side.v[v])), acc.v[v]);
    }
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      float nw = __fadd_rn(__fadd_rn(a.v[v], acc.v[v]), __fmul_rn(a.v[v], acc.v[v]));
      if constexpr (DROP) nw = kept(b[v], e.keep) ? __fdiv_rn(nw, e.keep) : 0.f;
      out.v[v] = nw;
    }
    store<VEC>(e.out1 + off, acc);
  }
  store<VEC>(e.out0 + off, out);
}

// one group of 2^glog threads per piece: the piece's product, then the
// epilogue (a row of one piece) or a partial (a row of several)
template <int VEC, bool BWD, bool DROP>
__global__ void piece_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                             const float* __restrict__ val, const float* __restrict__ src,
                             const int* __restrict__ piece_row,
                             const int* __restrict__ piece_lo,
                             const int* __restrict__ piece_slot, int n_pieces, int piece,
                             float* __restrict__ partial, Epilogue e, int D, int glog) {
  const long long p = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> glog;
  const int G = 1 << glog;
  const int t = threadIdx.x & (G - 1);
  if (p >= n_pieces) return;  // uniform across the piece's group
  const int row = __ldg(piece_row + p);
  const int lo = __ldg(piece_lo + p);
  const int hi = min(lo + piece, __ldg(row_ptr + row + 1));
  const int slot = __ldg(piece_slot + p);
  for (int c = t * VEC; c < D; c += G * VEC) {
    const F<VEC> acc = range_product<VEC>(col, val, src, lo, hi, D, c);
    if (slot < 0)
      finish<VEC, BWD, DROP>(e, (long long)row * D + c, acc);
    else
      store<VEC>(partial + (long long)slot * D + c, acc);
  }
}

// one group per row of several pieces: its partials summed in piece order,
// then the epilogue
template <int VEC, bool BWD, bool DROP>
__global__ void heavy_kernel(const int* __restrict__ heavy_row,
                             const int* __restrict__ heavy_ptr, int n_heavy,
                             const float* __restrict__ partial, Epilogue e, int D, int glog) {
  const long long h = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> glog;
  const int G = 1 << glog;
  const int t = threadIdx.x & (G - 1);
  if (h >= n_heavy) return;
  const int row = __ldg(heavy_row + h);
  const int s0 = __ldg(heavy_ptr + h), s1 = __ldg(heavy_ptr + h + 1);
  for (int c = t * VEC; c < D; c += G * VEC) {
    F<VEC> acc = load<VEC>(partial + (long long)s0 * D + c);
    int s = s0 + 1;
    for (; s + kUnroll <= s1; s += kUnroll) {
      F<VEC> q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) q[u] = load<VEC>(partial + (long long)(s + u) * D + c);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc.v[v] = __fadd_rn(acc.v[v], q[u].v[v]);
    }
    for (; s < s1; ++s) {
      const F<VEC> q = load<VEC>(partial + (long long)s * D + c);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc.v[v] = __fadd_rn(acc.v[v], q.v[v]);
    }
    finish<VEC, BWD, DROP>(e, (long long)row * D + c, acc);
  }
}

// h = g' + g' * x, elementwise over [n, D]
template <bool DROP>
__global__ void bwd_prep_kernel(const float* __restrict__ g, const float* __restrict__ x,
                                const int* __restrict__ bits, float keep,
                                float* __restrict__ h, long long total) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float gp = __ldg(g + i);
    if constexpr (DROP) gp = kept(__ldg(bits + i), keep) ? __fdiv_rn(gp, keep) : 0.f;
    h[i] = __fadd_rn(gp, __fmul_rn(gp, __ldg(x + i)));
  }
}

bool aligned16(const void* p) { return p == nullptr || ((uintptr_t)p & 15u) == 0; }

// The schedule of one CSR (see ops/graph_layer.py::make_csr).
struct Schedule {
  const int* row_ptr;
  const int* col;
  const float* val;
  const int* piece_row;
  const int* piece_lo;
  const int* piece_slot;
  const int* heavy_row;
  const int* heavy_ptr;
  int n_pieces;
  int n_heavy;
  int piece;
};

template <int VEC, bool BWD, bool DROP>
void launch(const Schedule& s, const float* src, float* partial, const Epilogue& e, int D,
            int glog, cudaStream_t stream) {
  const unsigned pb =
      (unsigned)((((long long)s.n_pieces << glog) + kThreads - 1) / kThreads);
  piece_kernel<VEC, BWD, DROP><<<pb, kThreads, 0, stream>>>(
      s.row_ptr, s.col, s.val, src, s.piece_row, s.piece_lo, s.piece_slot, s.n_pieces,
      s.piece, partial, e, D, glog);
  if (s.n_heavy > 0) {
    const unsigned hb =
        (unsigned)((((long long)s.n_heavy << glog) + kThreads - 1) / kThreads);
    heavy_kernel<VEC, BWD, DROP><<<hb, kThreads, 0, stream>>>(
        s.heavy_row, s.heavy_ptr, s.n_heavy, partial, e, D, glog);
  }
}

// the product and its epilogue, for the vector width the operands allow
template <bool BWD>
void product(const Schedule& s, const float* src, float* partial, const Epilogue& e,
             int D, cudaStream_t stream) {
  const bool vec_ok = D % 4 == 0 && aligned16(src) && aligned16(partial) &&
                      aligned16(e.a) && aligned16(e.b) && aligned16(e.bits) &&
                      aligned16(e.out0) && aligned16(e.out1);
  const int vec = vec_ok ? 4 : 1;
  const int per_row = (D + vec - 1) / vec;
  int glog = 0;
  while ((1 << glog) < per_row && glog < 5) ++glog;
  const bool drop = e.bits != nullptr;
  if (vec == 4) {
    if (drop) launch<4, BWD, true>(s, src, partial, e, D, glog, stream);
    else launch<4, BWD, false>(s, src, partial, e, D, glog, stream);
  } else {
    if (drop) launch<1, BWD, true>(s, src, partial, e, D, glog, stream);
    else launch<1, BWD, false>(s, src, partial, e, D, glog, stream);
  }
}

Schedule schedule(const void* row_ptr, const void* col, const void* val,
                  const void* piece_row, const void* piece_lo, const void* piece_slot,
                  const void* heavy_row, const void* heavy_ptr, int n_pieces, int n_heavy,
                  int piece) {
  return Schedule{(const int*)row_ptr,   (const int*)col,        (const float*)val,
                  (const int*)piece_row, (const int*)piece_lo,   (const int*)piece_slot,
                  (const int*)heavy_row, (const int*)heavy_ptr,  n_pieces,
                  n_heavy,               piece};
}

}  // namespace

// partial: scratch of [slots, D] floats, slots = the pieces of the rows of
// several pieces
extern "C" int graph_layer_forward(const void* row_ptr, const void* col, const void* val,
                                   const void* piece_row, const void* piece_lo,
                                   const void* piece_slot, const void* heavy_row,
                                   const void* heavy_ptr, int n_pieces, int n_heavy,
                                   int piece, const void* x, const void* bits, float keep,
                                   void* out_new, void* out_side, void* partial, int n,
                                   int D, void* stream) {
  if (n > 0 && D > 0) {
    const Schedule s = schedule(row_ptr, col, val, piece_row, piece_lo, piece_slot,
                                heavy_row, heavy_ptr, n_pieces, n_heavy, piece);
    const Epilogue e{(const float*)x, nullptr, (const int*)bits, keep,
                     (float*)out_new, (float*)out_side};
    product<false>(s, (const float*)x, (float*)partial, e, D, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

// h: scratch of [n, D] floats
extern "C" int graph_layer_backward(const void* row_ptr_t, const void* col_t,
                                    const void* val_t, const void* piece_row,
                                    const void* piece_lo, const void* piece_slot,
                                    const void* heavy_row, const void* heavy_ptr,
                                    int n_pieces, int n_heavy, int piece, const void* x,
                                    const void* side, const void* bits, float keep,
                                    const void* g, void* h, void* gx, void* partial, int n,
                                    int D, void* stream) {
  if (n > 0 && D > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const long long total = (long long)n * D;
    const unsigned prep_blocks = (unsigned)(total < 132LL * 8 * kThreads
                                                ? (total + kThreads - 1) / kThreads
                                                : 132LL * 8);
    if (bits)
      bwd_prep_kernel<true><<<prep_blocks, kThreads, 0, st>>>(
          (const float*)g, (const float*)x, (const int*)bits, keep, (float*)h, total);
    else
      bwd_prep_kernel<false><<<prep_blocks, kThreads, 0, st>>>(
          (const float*)g, (const float*)x, nullptr, keep, (float*)h, total);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const Schedule s = schedule(row_ptr_t, col_t, val_t, piece_row, piece_lo, piece_slot,
                                heavy_row, heavy_ptr, n_pieces, n_heavy, piece);
    const Epilogue e{(const float*)g, (const float*)side, (const int*)bits, keep,
                     (float*)gx, nullptr};
    product<true>(s, (const float*)h, (float*)partial, e, D, st);
  }
  return (int)cudaGetLastError();
}
