// B16: DeepAPF's attention-gated score, forward, backward and grid.
//
// Replaces recbole_cdr_tpu/models/deepapf.py:70-101 DeepAPF._att_mlp and
// _forward (XLA gathers, two [P, D] x [D, D] products of the attention MLP,
// a 2-way softmax, the blend and the predict dot) and their autodiff. Per
// pair, with the entity's shared row e, its domain-only row o and the other
// side's row t (the entity is the item in overlap_items mode, the user in
// overlap_users mode):
//
//   x_s = e * t,  x_o = o * t
//   a_. = relu(x_. @ W + b) . w2                      (W [D, D], b [D], w2 [D])
//   a_s = -1e31 where the entity does not overlap      (id > overlapped_num)
//   (al_s, al_o) = softmax(a_s, a_o),  ent = al_s e + al_o o
//   logit = (ent * t) . pl
//
// -1e31 stays finite: exp(-1e31 - max) is exactly 0, never NaN, and the
// masked share logit gets exactly zero gradient (al_s is 0 and its gradient
// is set to 0, as jnp.where gives it).
//
// Bound on an H100: operations. A pair costs two D x D matrix-vector
// products (4 D^2 flops) plus O(D): at D = 64 about 17.3 k flops, so a
// training step's 16,384 pairs are ~0.28 GFLOP (4.2 us at 67 TFLOP/s on
// the CUDA cores) against ~13 MB of rows (3.9 us at 3.35 TB/s). A [32,
// 4,980] grid tile of the predict fallback holds 2.61 GFLOP of products:
// 3 x 2.61 over the TF32 tensor rate (495 TFLOP/s) is 16 us in float32 (39
// us on the CUDA cores), 2.6 us at the bf16 rate of 989 TFLOP/s. The
// attention input depends on both sides of the pair, so nothing is shared
// between pairs: unlike NATR (B9) there is no anchor split.
//
// Forward and backward of gathered pairs: persistent blocks of 256 threads
// keep W (and, in the backward, its transpose) in shared memory for the
// whole launch and take tiles of TP pairs (2048 / D: 32 at D = 64). A tile
// stages its pairs' e, o, t rows and the 2 TP rows of x (x_s rows, then x_o
// rows) in shared memory with 16-byte loads; the product x @ W runs with a
// 4 x 4 register tile per thread on the CUDA cores; each row's a reduces
// over the threads of its columns with shuffles. The pair stage gives each
// pair G = 256 / TP threads and each thread 8 columns. The backward
// recomputes the forward (nothing of it is kept), then: the pair stage's
// chain rule into d(a_s) = al_s al_o (d al_s - d al_o) (and -d(a_s) for
// a_o), dZ = relu'(z) d(a) w2 in shared memory, dW += x^T dZ in registers
// (D^2 / 256 entries per thread), dx = dZ @ W^T with the same register
// tile on the staged transpose, and the rows' gradients d e, d o, d t. The
// weight gradients are sums over every pair: each block keeps its partial
// sums in registers over its tiles, writes them once, and a second launch
// adds the blocks' partials in block order.
//
// The grid (grid_kernel), the predict fallback's [B, I] tile from the
// tables and the ids: persistent blocks keep W's MMA fragments in shared
// memory for the whole launch and take 2-D tiles of bu = min(8, B) users x
// bi = 16 items (8 in 16 bits when I <= 8; grid() picks them). A
// tile stages each of its users' rows and each of its items' rows once
// (cp.async, 16 bytes a copy; a block's first tile while it stages W): 8 +
// 32 rows serve 128 pairs, where a tile of the pair kernels loaded three
// rows per pair. A warp takes 8 pairs (8 items of one user) as the 16 rows
// of an mma.sync tile, x_s of pair g in row g and x_o in row g + 8, and
// forms x = e * t and o * t straight into its A fragments from the staged
// rows (in 16 bits one rounding each, as before); W's B fragments are
// stored in the order the lanes read them (one 8-byte load each), and b
// seeds the accumulators. float32: 3xTF32 m16n8k8 (hi * lo, lo * hi, hi *
// hi, as B5), float32 accuracy, a warp taking two such tiles at once so
// that they share each B fragment's load and split; 16 bits: m16n8k16 on
// the 16-bit values, exact products and float32 sums. The epilogue runs on
// the accumulator fragments: lane (g, c) holds columns 8 j + 2 c, + 1 of
// both rows of pair g, so relu and . w2 reduce over the quad's 4 lanes with
// two shuffles; the softmax follows in the quad, then the logit: in float32
// al_s (x_s . pl) + al_o (x_o . pl), those dots summed while x is formed;
// in 16 bits from ent rounded as JAX rounds it, over the quad's columns of
// the staged rows. One lane writes the sigmoid; z never leaves the
// registers. Measured on an H100 (PERF.md): the float32 grid is bound by
// mma.sync's TF32 rate (its products alone take 0.051 ms of 0.056 on a
// fallback tile), so wgmma is its next step; the 16-bit grid by the
// per-tile staging and the epilogue.
//
// No atomics: every result is bit-reproducible from run to run.
//
// B16-bf16, the 16-bit form (DeepAPF under compute_dtype: bfloat16; float16
// through the same templates): every operand and output is 16-bit (the rows
// or tables, the weights, the logits' gradient; the logits, the grid's
// probabilities, every gradient). The pair kernels widen values exactly as
// they stage them (their shared memory is float32); the grid stages the
// 16-bit rows and W as they are and feeds them to the tensor cores. Each dot
// and each sum accumulates in float32 and is rounded to the 16-bit type where
// JAX's bf16 _forward has a named intermediate: x_s and x_o, x @ W + b, the
// a's, alpha after the softmax, entity_e, the logit, and the grid's sigmoid.
// The masked share logit stays the float32 kMasked: under float16 JAX's
// -1e31 is -inf, and both give alpha_s = 0 exactly and no NaN. The backward
// is the float32 chain rule on those rounded values (a rounding passes its
// gradient through unchanged; the softmax's slope at its unrounded value),
// each gradient rounded once to the operands' type: the rows' as they are
// written, the weights' after the block-order sum. The float32 form is the
// same template with every rounding the identity.

#include <cmath>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "float16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;
constexpr float kMasked = -1e31f;

template <typename T>
__device__ __forceinline__ float4 rnd4(float4 v) {
  return make_float4(rnd<T>(v.x), rnd<T>(v.y), rnd<T>(v.z), rnd<T>(v.w));
}

template <int D>
struct Shape {
  static constexpr int C4 = D / 4;             // column groups of 4
  static constexpr int RT = kThreads / C4;     // row threads of a product
  static constexpr int ROWS = 4 * RT;          // rows of x in a tile: two per pair
  static constexpr int TP = ROWS / 2;          // pairs of a tile
  static constexpr int G = kThreads / TP;      // threads of a pair in its pair stage
  static constexpr int V = D / G;              // columns of such a thread
  static constexpr int PS = D + G;             // row stride of the pair rows
  static constexpr int XS = D + 4;             // row stride of x and dZ
  static constexpr int RK = D / RT;            // rows of dW per thread
  static constexpr int NPART = D * D + 3 * D;  // dW | db | dw2 | dpl
  static_assert(V == 8 && ROWS % 2 == 0, "the tiling assumes 8 columns a pair thread");
};

template <int D>
__host__ __device__ constexpr size_t smem_floats(bool backward) {
  using S = Shape<D>;
  return (size_t)D * D * (backward ? 2 : 1) + 3 * (size_t)S::TP * S::PS +
         (size_t)S::ROWS * S::XS * (backward ? 2 : 1) + 3 * D + 2 * S::ROWS + 3 * S::TP;
}

template <int D>
size_t smem_bytes(bool backward) {
  return 4 * smem_floats<D>(backward) + 4 * 3 * (size_t)Shape<D>::TP;
}

struct Smem {
  float* W;      // [D, D]
  float* WT;     // [D, D] its transpose (backward)
  float* E;      // [TP, PS] shared rows
  float* O;      // [TP, PS] domain-only rows
  float* T;      // [TP, PS] the other side's rows
  float* X;      // [ROWS, XS] x_s rows, then x_o rows; later dx
  float* dZ;     // [ROWS, XS] (backward)
  float* b;      // [D]
  float* w2;     // [D]
  float* pl;     // [D]
  float* a;      // [ROWS] attention logits
  float* da;     // [ROWS] their gradients (backward)
  float* al;     // [2 TP] al_s, then al_o, rounded to the operands' type
  float* g;      // [TP] the logits' gradients (backward)
  int* msk;      // [TP] the share logit is masked
  int* ent;      // [TP] entity row, -1 past the last pair
  int* oth;      // [TP] other row
};

template <int D>
__device__ Smem carve(unsigned char* base, bool backward) {
  using S = Shape<D>;
  Smem m;
  float* f = reinterpret_cast<float*>(base);
  m.W = f;   f += D * D;
  m.WT = f;  f += backward ? D * D : 0;
  m.E = f;   f += S::TP * S::PS;
  m.O = f;   f += S::TP * S::PS;
  m.T = f;   f += S::TP * S::PS;
  m.X = f;   f += S::ROWS * S::XS;
  m.dZ = f;  f += backward ? S::ROWS * S::XS : 0;
  m.b = f;   f += D;
  m.w2 = f;  f += D;
  m.pl = f;  f += D;
  m.a = f;   f += S::ROWS;
  m.da = f;  f += S::ROWS;
  m.al = f;  f += 2 * S::TP;
  m.g = f;   f += S::TP;
  m.msk = reinterpret_cast<int*>(f);
  m.ent = m.msk + S::TP;
  m.oth = m.ent + S::TP;
  return m;
}

// a launch's gathered pairs: pair q is row q of share, only, other
template <typename T>
struct Pairs {
  const T* share;
  const T* only;
  const T* other;
  const uint8_t* mask;  // the share logit is masked
  long long n;          // pairs
};

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z),
                     __fmul_rn(a.w, b.w));
}

template <int W>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D, typename T>
__device__ void stage_weights(const T* __restrict__ W, const T* __restrict__ b,
                              const T* __restrict__ w2, const T* __restrict__ pl,
                              bool transpose, Smem& m) {
  for (int i = threadIdx.x; i < D * D; i += kThreads) {
    const float w = ld1(W + i);
    m.W[i] = w;
    if (transpose) m.WT[(i % D) * D + i / D] = w;
  }
  for (int d = threadIdx.x; d < D; d += kThreads) {
    m.b[d] = ld1(b + d);
    m.w2[d] = ld1(w2 + d);
    m.pl[d] = ld1(pl + d);
  }
}

// The tile of pairs [q0, q0 + TP): their rows, x (rounded to T), masks (and
// the logits' gradients). Ends synchronised.
template <int D, typename T>
__device__ void load_tile(const Pairs<T>& pr, long long q0, const T* __restrict__ g, Smem& m) {
  using S = Shape<D>;
  const int tid = threadIdx.x;
  for (int j = tid; j < S::TP; j += kThreads) {
    const long long q = q0 + j;
    const bool ok = q < pr.n;
    int ent = -1, oth = 0, masked = 0;
    if (ok) {
      ent = oth = (int)q;
      masked = __ldg(pr.mask + q) != 0;
    }
    m.ent[j] = ent;
    m.oth[j] = oth;
    m.msk[j] = masked;
    if (g != nullptr) m.g[j] = ok ? ld1(g + q) : 0.f;
  }
  __syncthreads();
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = tid; e < S::TP * S::C4; e += kThreads) {
    const int j = e / S::C4, d = 4 * (e % S::C4);
    const int ent = m.ent[j];
    float4 ev = zero, ov = zero, tv = zero;
    if (ent >= 0) {
      const long long er = (long long)ent * D + d, orow = (long long)m.oth[j] * D + d;
      ev = ld4(pr.share + er);
      ov = ld4(pr.only + er);
      tv = ld4(pr.other + orow);
    }
    *reinterpret_cast<float4*>(m.E + j * S::PS + d) = ev;
    *reinterpret_cast<float4*>(m.O + j * S::PS + d) = ov;
    *reinterpret_cast<float4*>(m.T + j * S::PS + d) = tv;
    *reinterpret_cast<float4*>(m.X + j * S::XS + d) = rnd4<T>(mul4(ev, tv));
    *reinterpret_cast<float4*>(m.X + (S::TP + j) * S::XS + d) = rnd4<T>(mul4(ov, tv));
  }
  __syncthreads();
}

// acc = in @ Wm for rows ty + RT r (r < 4) and columns 4 tx .. 4 tx + 3 of
// the [ROWS, XS] rows `in` and the [D, D] matrix `Wm`
template <int D>
__device__ __forceinline__ void product(const float* __restrict__ in, const float* __restrict__ Wm,
                                        float acc[4][4]) {
  using S = Shape<D>;
  const int tx = threadIdx.x % S::C4, ty = threadIdx.x / S::C4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  const float* x0 = in + ty * S::XS;
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    const float4 w = *reinterpret_cast<const float4*>(Wm + k * D + 4 * tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = x0[r * S::RT * S::XS + k];
      acc[r][0] = fmaf(x, w.x, acc[r][0]);
      acc[r][1] = fmaf(x, w.y, acc[r][1]);
      acc[r][2] = fmaf(x, w.z, acc[r][2]);
      acc[r][3] = fmaf(x, w.w, acc[r][3]);
    }
  }
}

// z = x @ W + b into acc (kept for the backward) and a = relu(z) . w2 of
// every row into m.a, each rounded to T. Ends synchronised.
template <int D, typename T>
__device__ void attention_logits(Smem& m, float z[4][4]) {
  using S = Shape<D>;
  const int tx = threadIdx.x % S::C4, ty = threadIdx.x / S::C4;
  product<D>(m.X, m.W, z);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      z[r][c] = rnd<T>(__fadd_rn(z[r][c], m.b[4 * tx + c]));
      part = fmaf(fmaxf(z[r][c], 0.f), m.w2[4 * tx + c], part);
    }
    part = group_sum<S::C4>(part);
    if (tx == 0) m.a[ty + S::RT * r] = rnd<T>(part);
  }
  __syncthreads();
}

// the softmax of pair j: (al_s, al_o), unrounded
template <int D>
__device__ __forceinline__ void softmax2(const Smem& m, int j, float& als, float& alo) {
  using S = Shape<D>;
  const float as = m.msk[j] ? kMasked : m.a[j];
  const float ao = m.a[S::TP + j];
  const float mx = fmaxf(as, ao);
  const float es = expf(__fsub_rn(as, mx)), eo = expf(__fsub_rn(ao, mx));
  const float sum = __fadd_rn(es, eo);
  als = __fdiv_rn(es, sum);
  alo = __fdiv_rn(eo, sum);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
forward_kernel(Pairs<T> pr, const T* __restrict__ W, const T* __restrict__ b,
               const T* __restrict__ w2, const T* __restrict__ pl, T* __restrict__ out) {
  using S = Shape<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  Smem m = carve<D>(smem, false);
  stage_weights<D>(W, b, w2, pl, false, m);
  const int j = threadIdx.x / S::G, l = threadIdx.x % S::G;
  const long long tiles = (pr.n + S::TP - 1) / S::TP;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long q0 = t * S::TP;
    load_tile<D>(pr, q0, (const T*)nullptr, m);
    float z[4][4];
    attention_logits<D, T>(m, z);
    float als, alo;
    softmax2<D>(m, j, als, alo);
    als = rnd<T>(als);
    alo = rnd<T>(alo);
    float acc = 0.f;
#pragma unroll
    for (int v = 0; v < S::V; ++v) {
      const int d = l + S::G * v;
      const float ent = rnd<T>(__fadd_rn(__fmul_rn(als, m.E[j * S::PS + d]),
                                         __fmul_rn(alo, m.O[j * S::PS + d])));
      acc = fmaf(__fmul_rn(ent, m.T[j * S::PS + d]), m.pl[d], acc);
    }
    acc = rnd<T>(group_sum<S::G>(acc));
    if (l == 0 && q0 + j < pr.n) st1(out + q0 + j, acc);
    __syncthreads();
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
backward_kernel(Pairs<T> pr, const T* __restrict__ W, const T* __restrict__ b,
                const T* __restrict__ w2, const T* __restrict__ pl, const T* __restrict__ g,
                T* __restrict__ d_share, T* __restrict__ d_only, T* __restrict__ d_other,
                float* __restrict__ partial) {
  using S = Shape<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  Smem m = carve<D>(smem, true);
  stage_weights<D>(W, b, w2, pl, true, m);
  const int tid = threadIdx.x;
  const int tx = tid % S::C4, ty = tid / S::C4;  // product tiles
  const int j = tid / S::G, l = tid % S::G;      // pair stage

  float acc_w[S::RK][4];
#pragma unroll
  for (int r = 0; r < S::RK; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_w[r][c] = 0.f;
  float acc_b[4] = {0.f, 0.f, 0.f, 0.f}, acc_w2[4] = {0.f, 0.f, 0.f, 0.f};
  float acc_pl[S::V];
#pragma unroll
  for (int v = 0; v < S::V; ++v) acc_pl[v] = 0.f;

  const long long tiles = (pr.n + S::TP - 1) / S::TP;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long q0 = t * S::TP;
    load_tile<D>(pr, q0, g, m);
    float z[4][4];
    attention_logits<D, T>(m, z);

    // the pair stage's chain rule: d(al) from d(ent) = g t pl, then the
    // softmax's d(a_s) = al_s al_o (d al_s - d al_o), d(a_o) = -d(a_s), its
    // slope at the unrounded al; the rounded al stay for the rows' gradients
    {
      float als, alo;
      softmax2<D>(m, j, als, alo);
      const float gj = m.g[j];
      float ds = 0.f, dov = 0.f;
#pragma unroll
      for (int v = 0; v < S::V; ++v) {
        const int d = l + S::G * v;
        const float dent = __fmul_rn(__fmul_rn(gj, m.T[j * S::PS + d]), m.pl[d]);
        ds = fmaf(dent, m.E[j * S::PS + d], ds);
        dov = fmaf(dent, m.O[j * S::PS + d], dov);
      }
      ds = group_sum<S::G>(ds);
      dov = group_sum<S::G>(dov);
      if (l == 0) {
        const float das =
            m.msk[j] ? 0.f : __fmul_rn(__fmul_rn(als, alo), __fsub_rn(ds, dov));
        m.da[j] = das;
        m.da[S::TP + j] = -das;
        m.al[j] = rnd<T>(als);
        m.al[S::TP + j] = rnd<T>(alo);
      }
    }
    __syncthreads();

    // dZ = relu'(z) d(a) w2; the block's sums of d(w2) and d(b)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty + S::RT * r;
      const float dar = m.da[row];
      float dz[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float w = m.w2[4 * tx + c];
        dz[c] = z[r][c] > 0.f ? __fmul_rn(dar, w) : 0.f;
        acc_w2[c] = fmaf(dar, fmaxf(z[r][c], 0.f), acc_w2[c]);
        acc_b[c] = __fadd_rn(acc_b[c], dz[c]);
      }
      *reinterpret_cast<float4*>(m.dZ + row * S::XS + 4 * tx) =
          make_float4(dz[0], dz[1], dz[2], dz[3]);
    }
    __syncthreads();

    // dW += x^T dZ: rows ty + RT r of dW, columns 4 tx .. 4 tx + 3
    for (int row = 0; row < S::ROWS; ++row) {
      const float4 dz = *reinterpret_cast<const float4*>(m.dZ + row * S::XS + 4 * tx);
      const float* x = m.X + row * S::XS + ty;
#pragma unroll
      for (int r = 0; r < S::RK; ++r) {
        const float xv = x[S::RT * r];
        acc_w[r][0] = fmaf(xv, dz.x, acc_w[r][0]);
        acc_w[r][1] = fmaf(xv, dz.y, acc_w[r][1]);
        acc_w[r][2] = fmaf(xv, dz.z, acc_w[r][2]);
        acc_w[r][3] = fmaf(xv, dz.w, acc_w[r][3]);
      }
    }
    // dx = dZ @ W^T, then into X's place once every thread is done reading x
    float dx[4][4];
    product<D>(m.dZ, m.WT, dx);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(m.X + (ty + S::RT * r) * S::XS + 4 * tx) =
          make_float4(dx[r][0], dx[r][1], dx[r][2], dx[r][3]);
    __syncthreads();

    // the rows' gradients: d e = al_s d ent + dx_s t, d o = al_o d ent +
    // dx_o t, d t = g ent pl + dx_s e + dx_o o; d pl += g ent t
    {
      const long long q = q0 + j;
      const bool ok = q < pr.n;
      const float gj = m.g[j], als = m.al[j], alo = m.al[S::TP + j];
#pragma unroll
      for (int v = 0; v < S::V; ++v) {
        const int d = l + S::G * v;
        const float e = m.E[j * S::PS + d], o = m.O[j * S::PS + d], tt = m.T[j * S::PS + d];
        const float dxs = m.X[j * S::XS + d], dxo = m.X[(S::TP + j) * S::XS + d];
        const float ent = rnd<T>(__fadd_rn(__fmul_rn(als, e), __fmul_rn(alo, o)));
        const float gent = __fmul_rn(gj, ent);
        const float dent = __fmul_rn(__fmul_rn(gj, tt), m.pl[d]);
        acc_pl[v] = fmaf(gent, tt, acc_pl[v]);
        if (ok) {
          st1(d_share + q * D + d, rnd<T>(fmaf(dxs, tt, __fmul_rn(als, dent))));
          st1(d_only + q * D + d, rnd<T>(fmaf(dxo, tt, __fmul_rn(alo, dent))));
          st1(d_other + q * D + d,
              rnd<T>(fmaf(dxo, o, fmaf(dxs, e, __fmul_rn(gent, m.pl[d])))));
        }
      }
    }
    __syncthreads();
  }

  // this block's partial sums [dW | db | dw2 | dpl], the cross-thread parts
  // added in a fixed order through X's space
  float* part = partial + (long long)blockIdx.x * S::NPART;
#pragma unroll
  for (int r = 0; r < S::RK; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[(ty + S::RT * r) * D + 4 * tx + c] = acc_w[r][c];
  float* red = m.X;  // [RT, D], then [TP, D]
#pragma unroll
  for (int c = 0; c < 4; ++c) red[ty * D + 4 * tx + c] = acc_b[c];
  __syncthreads();
  if (tid < D) {
    float s = 0.f;
    for (int k = 0; k < S::RT; ++k) s = __fadd_rn(s, red[k * D + tid]);
    part[D * D + tid] = s;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 4; ++c) red[ty * D + 4 * tx + c] = acc_w2[c];
  __syncthreads();
  if (tid < D) {
    float s = 0.f;
    for (int k = 0; k < S::RT; ++k) s = __fadd_rn(s, red[k * D + tid]);
    part[D * D + D + tid] = s;
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < S::V; ++v) red[j * D + l + S::G * v] = acc_pl[v];
  __syncthreads();
  if (tid < D) {
    float s = 0.f;
    for (int k = 0; k < S::TP; ++k) s = __fadd_rn(s, red[k * D + tid]);
    part[D * D + 2 * D + tid] = s;
  }
}

// out[i] = sum over blocks k, in order, of partial[k, i], rounded to T
template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ partial, int blocks, int n, T* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < blocks; ++k) s = __fadd_rn(s, partial[(long long)k * n + i]);
  st1(out + i, rnd<T>(s));
}

// blocks of a persistent launch: every SM full, never more blocks than tiles
template <typename K>
int persistent_blocks(K kernel, size_t smem, long long tiles) {
  if (tiles <= 0) return 0;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  const long long full = (long long)sms * (occ > 0 ? occ : 1);
  return (int)(full < tiles ? full : tiles);
}

template <int D, typename T>
int forward(const Pairs<T>& pr, const T* W, const T* b, const T* w2, const T* pl, T* out,
            cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(false);
  const long long tiles = (pr.n + Shape<D>::TP - 1) / Shape<D>::TP;
  const int blocks = persistent_blocks(forward_kernel<D, T>, smem, tiles);
  if (blocks < 0) return -blocks;
  if (blocks > 0)
    forward_kernel<D, T><<<blocks, kThreads, smem, stream>>>(pr, W, b, w2, pl, out);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int backward(const Pairs<T>& pr, const T* W, const T* b, const T* w2, const T* pl, const T* g,
             T* d_share, T* d_only, T* d_other, float* partial, int blocks, T* out,
             cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(true);
  const int n = Shape<D>::NPART;
  if (blocks > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        backward_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    backward_kernel<D, T><<<blocks, kThreads, smem, stream>>>(pr, W, b, w2, pl, g, d_share,
                                                               d_only, d_other, partial);
    const cudaError_t e2 = cudaGetLastError();
    if (e2 != cudaSuccess) return (int)e2;
  } else {
    const cudaError_t e = cudaMemsetAsync(partial, 0, (size_t)n * sizeof(float), stream);
    if (e != cudaSuccess) return (int)e;
  }
  reduce_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, blocks > 0 ? blocks : 1, n, out);
  return (int)cudaGetLastError();
}

template <typename T>
Pairs<T> gathered(const void* share, const void* only, const void* other, const void* mask,
                  int P) {
  Pairs<T> pr{};
  pr.share = (const T*)share;
  pr.only = (const T*)only;
  pr.other = (const T*)other;
  pr.mask = (const uint8_t*)mask;
  pr.n = P;
  return pr;
}


// ---- the grid: 2-D pair tiles, both products on the tensor cores ----------

constexpr int kWarps = kThreads / 32;
constexpr int kTileUsers = 8;   // at most, users of a grid tile
constexpr int kTileItems = 16;  // at most, items of a grid tile (a multiple of 8 MT)

template <int D, typename T>
struct Grid {
  static constexpr bool kF32 = kWide<T>;
  static constexpr int NK = D / (kF32 ? 8 : 16);        // k-steps: m16n8k8 tf32, m16n8k16
  static constexpr int NT = D / 8;                      // n-tiles of 8 columns
  static constexpr int RS = D + 16 / (int)sizeof(T);    // staged row stride (elements)
  static constexpr int WWORDS = NK * NT * 64;           // W's B fragments, 32-bit words
  static constexpr int CHUNK = 16 / (int)sizeof(T);     // elements of a 16-byte copy
  // m-tiles a warp takes at once: two share each B fragment's load and
  // split in 3xTF32; the 16-bit products are cheap and one keeps 64 registers
  static constexpr int MT = kF32 && D <= 64 ? 2 : 1;
  static constexpr int UNIT = 8 * MT;                   // their items
};

// a grid block's shared memory: W's fragments, b | w2 | pl widened, the
// tile's ids, its rows (two a user and one an item when the user is the
// entity, else one and two), each 16 bytes longer than D values
template <int D, typename T>
size_t grid_smem_bytes(int bu, int bi, int entity_is_item) {
  using G = Grid<D, T>;
  const int rows = entity_is_item ? bu + 2 * bi : 2 * bu + bi;
  return 4 * (size_t)G::WWORDS + 12 * (size_t)D + 4 * (size_t)(kTileUsers + kTileItems) +
         (size_t)rows * G::RS * sizeof(T);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ void mma_16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi is x cut to TF32 (its top 19 bits), lo the exact float32
// rest, of which the tensor core reads the TF32 part (as B5's split)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// two 16-bit values (a packed word) times two, each product rounded once to
// T: the exact product of two 16-bit values, as rnd<T>(__fmul_rn(...))
template <typename T>
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                     *reinterpret_cast<const __nv_bfloat162*>(&b));
    return *reinterpret_cast<const uint32_t*>(&r);
  } else {
    const __half2 r = __hmul2(*reinterpret_cast<const __half2*>(&a),
                              *reinterpret_cast<const __half2*>(&b));
    return *reinterpret_cast<const uint32_t*>(&r);
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);  // bit-equal in the quad's 4 lanes
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// W [D, D] into its B fragments, in the order the warps read them: for
// k-step ks and n-tile j, lane L's two words at ((ks NT + j) 32 + L) 2 (one
// 8-byte load). tf32: W[8 ks + c + 4 r][8 j + g]; 16 bits: the pair W[k][n],
// W[k + 1][n] at k = 16 ks + 2 c + 8 r (g = L / 4, c = L % 4, r the word).
// W is read in 16-byte pieces of its rows
template <int D, typename T>
__device__ void stage_fragments(const T* __restrict__ W, uint32_t* wf) {
  using G = Grid<D, T>;
  constexpr int kPieces = D / G::CHUNK;  // 16-byte pieces of a row
  for (int v = threadIdx.x; v < D * kPieces; v += kThreads) {
    const int k = v / kPieces, n0 = (v % kPieces) * G::CHUNK;
    const uint4 piece = __ldg(reinterpret_cast<const uint4*>(W + k * D + n0));
    const uint32_t words[4] = {piece.x, piece.y, piece.z, piece.w};
#pragma unroll
    for (int q = 0; q < G::CHUNK; ++q) {
      const int n = n0 + q;
      if constexpr (G::kF32) {
        const int ks = k / 8, kk = k % 8;
        wf[((ks * G::NT + n / 8) * 32 + 4 * (n % 8) + kk % 4) * 2 + kk / 4] = words[q];
      } else {
        const int ks = k / 16, kk = k % 16;
        const int w = ((ks * G::NT + n / 8) * 32 + 4 * (n % 8) + (kk % 8) / 2) * 2 + kk / 8;
        reinterpret_cast<unsigned short*>(wf)[2 * w + (k & 1)] =
            (unsigned short)(q & 1 ? words[q / 2] >> 16 : words[q / 2] & 0xffffu);
      }
    }
  }
}

// acc[s] = b + [x_s; x_o] @ W for the 16 rows of each of the warp's MT
// m-tiles: rows g (x_s) and g + 8 (x_o) of the quad g's pair of m-tile s, x
// formed in the A fragments from the staged rows (b first: the float32
// sum's order is the only change); the m-tiles share each B fragment.
// float32 also sums this thread's share of x_s . pl and x_o . pl into se,
// so: its logit al_s (x_s . pl) + al_o (x_o . pl) needs no second pass over
// the rows
template <int D, typename T, int MT>
__device__ __forceinline__ void grid_products(const T* (&E)[MT], const T* (&O)[MT],
                                              const T* (&Tt)[MT], const uint32_t* wf,
                                              const float* bs, const float* pls,
                                              float (&acc)[MT][D / 8][4], float (&se)[MT],
                                              float (&so)[MT]) {
  using G = Grid<D, T>;
  const int lane = threadIdx.x & 31, c = lane & 3;
  const uint2* wf2 = reinterpret_cast<const uint2*>(wf) + lane;
#pragma unroll
  for (int j = 0; j < G::NT; ++j) {
    const float2 bv = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * c);
#pragma unroll
    for (int s = 0; s < MT; ++s) {
      acc[s][j][0] = acc[s][j][2] = bv.x;
      acc[s][j][1] = acc[s][j][3] = bv.y;
    }
  }
#pragma unroll
  for (int s = 0; s < MT; ++s) se[s] = so[s] = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < G::NK; ++ks) {
    if constexpr (G::kF32) {
      const int k = 8 * ks + c;
      const float p0 = pls[k], p1 = pls[k + 4];
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int s = 0; s < MT; ++s) {
        const float t0 = Tt[s][k], t1 = Tt[s][k + 4];
        const float x[4] = {__fmul_rn(E[s][k], t0), __fmul_rn(O[s][k], t0),
                            __fmul_rn(E[s][k + 4], t1), __fmul_rn(O[s][k + 4], t1)};
        se[s] = fmaf(x[2], p1, fmaf(x[0], p0, se[s]));
        so[s] = fmaf(x[3], p1, fmaf(x[1], p0, so[s]));
#pragma unroll
        for (int i = 0; i < 4; ++i) split(x[i], ah[s][i], al[s][i]);
      }
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const uint2 w = wf2[(ks * G::NT + j) * 32];
        uint32_t bh0, bl0, bh1, bl1;
        split(__uint_as_float(w.x), bh0, bl0);
        split(__uint_as_float(w.y), bh1, bl1);
#pragma unroll
        for (int s = 0; s < MT; ++s) {
          mma_tf32(acc[s][j], al[s], bh0, bh1);  // the small terms first
          mma_tf32(acc[s][j], ah[s], bl0, bl1);
          mma_tf32(acc[s][j], ah[s], bh0, bh1);
        }
      }
    } else {
      const int k = 16 * ks + 2 * c;
      uint32_t a[MT][4];
#pragma unroll
      for (int s = 0; s < MT; ++s) {
        const uint32_t* e = reinterpret_cast<const uint32_t*>(E[s] + k);
        const uint32_t* o = reinterpret_cast<const uint32_t*>(O[s] + k);
        const uint32_t* t = reinterpret_cast<const uint32_t*>(Tt[s] + k);
        a[s][0] = mul2<T>(e[0], t[0]);
        a[s][1] = mul2<T>(o[0], t[0]);
        a[s][2] = mul2<T>(e[4], t[4]);
        a[s][3] = mul2<T>(o[4], t[4]);
      }
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const uint2 w = wf2[(ks * G::NT + j) * 32];
#pragma unroll
        for (int s = 0; s < MT; ++s) mma_16<T>(acc[s][j], a[s], w.x, w.y);
      }
    }
  }
}

// 16 bits: ent = rnd(al_s e + al_o o), logit += (ent * t) . pl over the
// thread's columns of the A fragments (pairs of columns, one 32-bit load of
// each row a pair), as the pair kernels round
template <int D, typename T>
__device__ __forceinline__ float blend16(const T* E, const T* O, const T* Tt, const float* pls,
                                         float als, float alo) {
  using G = Grid<D, T>;
  const int c = threadIdx.x & 3;
  float lg[2] = {0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < G::NK; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = 16 * ks + 2 * c + 8 * h;
      const uint32_t e = *reinterpret_cast<const uint32_t*>(E + d);
      const uint32_t o = *reinterpret_cast<const uint32_t*>(O + d);
      const uint32_t t = *reinterpret_cast<const uint32_t*>(Tt + d);
      const float2 p = *reinterpret_cast<const float2*>(pls + d);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const float en = rnd<T>(__fadd_rn(__fmul_rn(als, from_bits<T>(v ? e >> 16 : e & 0xffffu)),
                                          __fmul_rn(alo, from_bits<T>(v ? o >> 16 : o & 0xffffu))));
        lg[v] = fmaf(__fmul_rn(en, from_bits<T>(v ? t >> 16 : t & 0xffffu)), v ? p.y : p.x, lg[v]);
      }
    }
  return __fadd_rn(lg[0], lg[1]);
}

// the grid: [bu users x bi items] tiles of the [B, I] pairs, tile t at users
// (t % n_ub) bu.., items (t / n_ub) bi..; a warp takes units of MT m-tiles
// (8 MT consecutive items of one user; m-tile s its items 8 s .. 8 s + 7),
// quad g of its lanes pair g of each
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
grid_kernel(const T* __restrict__ share_tab, const T* __restrict__ only_tab,
            const T* __restrict__ other_tab, const int* __restrict__ users,
            const int* __restrict__ items, int B, int I, int bu, int bi, int overlapped,
            int entity_is_item, const T* __restrict__ W, const T* __restrict__ b,
            const T* __restrict__ w2, const T* __restrict__ pl, T* __restrict__ out) {
  using G = Grid<D, T>;
  constexpr int MT = G::MT;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* wf = reinterpret_cast<uint32_t*>(smem);
  float* bs = reinterpret_cast<float*>(wf + G::WWORDS);
  float* w2s = bs + D;
  float* pls = w2s + D;
  int* uid = reinterpret_cast<int*>(pls + D);
  int* iid = uid + kTileUsers;
  T* urows = reinterpret_cast<T*>(iid + kTileItems);  // a user's t, or its e and o
  const int nu = entity_is_item ? 1 : 2, ni = 3 - nu;   // staged rows per user, per item
  const int n_rows = bu * nu + bi * ni;
  T* irows = urows + (size_t)bu * nu * G::RS;           // an item's e and o, or its t
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, c = lane & 3;
  const int n_ub = (B + bu - 1) / bu, units = bi / G::UNIT;
  const long long tiles = (long long)n_ub * ((I + bi - 1) / bi);
  constexpr int kRowChunks = D / G::CHUNK;

  // tile t's rows, each staged once (zeros past the edges), and its ids
  auto stage_rows = [&](long long t) {
    const int u0 = (int)(t % n_ub) * bu, i0 = (int)(t / n_ub) * bi;
    for (int e = threadIdx.x; e < n_rows * kRowChunks; e += kThreads) {
      const int r = e / kRowChunks, q = e % kRowChunks;
      const T* src = nullptr;
      if (r < bu * nu) {
        const int u = r / nu;
        if (u0 + u < B)
          src = (entity_is_item ? other_tab : (r % nu ? only_tab : share_tab)) +
                (long long)__ldg(users + u0 + u) * D;
      } else {
        const int i = (r - bu * nu) / ni;
        if (i0 + i < I)
          src = (entity_is_item ? ((r - bu * nu) % ni ? only_tab : share_tab) : other_tab) +
                (long long)__ldg(items + i0 + i) * D;
      }
      cp_async16(urows + (size_t)r * G::RS + q * G::CHUNK,
                 src ? src + q * G::CHUNK : share_tab, src != nullptr);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    const int x = threadIdx.x;
    if (x < bu) uid[x] = u0 + x < B ? __ldg(users + u0 + x) : -1;
    if (x < bi) iid[x] = i0 + x < I ? __ldg(items + i0 + x) : -1;
  };

  // the first tile's copies fly while W's fragments are staged
  if (blockIdx.x < tiles) stage_rows(blockIdx.x);
  stage_fragments<D, T>(W, wf);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    bs[d] = ld1(b + d);
    w2s[d] = ld1(w2 + d);
    pls[d] = ld1(pl + d);
  }
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int u0 = (int)(t % n_ub) * bu, i0 = (int)(t / n_ub) * bi;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    for (int m = warp; m < bu * units; m += kWarps) {
      const int u = m / units, s0 = (m % units) * G::UNIT;
      if (u0 + u >= B || i0 + s0 >= I) continue;  // uniform across the warp
      const T *E[MT], *O[MT], *Tt[MT];
      int ent[MT];
#pragma unroll
      for (int s = 0; s < MT; ++s) {
        const int slot = s0 + 8 * s + g;
        if (entity_is_item) {
          E[s] = irows + (size_t)(2 * slot) * G::RS;
          Tt[s] = urows + (size_t)u * G::RS;
          ent[s] = iid[slot];
        } else {
          E[s] = urows + (size_t)(2 * u) * G::RS;
          Tt[s] = irows + (size_t)slot * G::RS;
          ent[s] = uid[u];
        }
        O[s] = E[s] + G::RS;
      }
      float acc[MT][G::NT][4], se[MT], so[MT];
      grid_products<D, T, MT>(E, O, Tt, wf, bs, pls, acc, se, so);
#pragma unroll
      for (int s = 0; s < MT; ++s) {
        // a = relu(z) . w2 from the fragments, z = acc rounded to T: acc[s][j]
        // holds columns 8 j + 2 c, + 1 of rows g (x_s) and g + 8 (x_o)
        float ps[2] = {0.f, 0.f}, po[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < G::NT; ++j) {
          const float2 wv = *reinterpret_cast<const float2*>(w2s + 8 * j + 2 * c);
          ps[0] = fmaf(fmaxf(rnd<T>(acc[s][j][0]), 0.f), wv.x, ps[0]);
          ps[1] = fmaf(fmaxf(rnd<T>(acc[s][j][1]), 0.f), wv.y, ps[1]);
          po[0] = fmaf(fmaxf(rnd<T>(acc[s][j][2]), 0.f), wv.x, po[0]);
          po[1] = fmaf(fmaxf(rnd<T>(acc[s][j][3]), 0.f), wv.y, po[1]);
        }
        const float sa = quad_sum(__fadd_rn(ps[0], ps[1]));  // every lane shuffles
        const float oa = quad_sum(__fadd_rn(po[0], po[1]));
        const float as = ent[s] > overlapped ? kMasked : rnd<T>(sa);  // strict >
        const float ao = rnd<T>(oa);
        const float mx = fmaxf(as, ao);
        const float es = expf(__fsub_rn(as, mx)), eo = expf(__fsub_rn(ao, mx));
        const float sum = __fadd_rn(es, eo);
        const float als = rnd<T>(__fdiv_rn(es, sum)), alo = rnd<T>(__fdiv_rn(eo, sum));
        float lg;
        if constexpr (G::kF32)
          lg = fmaf(als, quad_sum(se[s]), __fmul_rn(alo, quad_sum(so[s])));
        else
          lg = rnd<T>(quad_sum(blend16<D, T>(E[s], O[s], Tt[s], pls, als, alo)));
        const int slot = s0 + 8 * s + g;
        if (c == 0 && i0 + slot < I)
          st1(out + (long long)(u0 + u) * I + i0 + slot,
              rnd<T>(__fdiv_rn(1.f, __fadd_rn(1.f, expf(-lg)))));
      }
    }
    __syncthreads();  // the rows are restaged next
    if (t + gridDim.x < tiles) stage_rows(t + gridDim.x);
  }
}

template <int D, typename T>
int grid(const T* share, const T* only, const T* other, const int* users, const int* items, int B,
         int I, int overlapped, int entity_is_item, const T* W, const T* b, const T* w2,
         const T* pl, T* out, cudaStream_t stream) {
  // the tile: min(8, B) users x kTileItems items, or one unit of items when
  // I fits in it
  constexpr int unit = Grid<D, T>::UNIT;
  static_assert(kTileItems % unit == 0, "a tile holds whole units of items");
  if (B < 0 || I < 0) return (int)cudaErrorInvalidValue;
  const int bu = B < 1 ? 1 : B < kTileUsers ? B : kTileUsers;
  const int bi = I <= unit ? unit : kTileItems;
  const size_t smem = grid_smem_bytes<D, T>(bu, bi, entity_is_item);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((B + bu - 1) / bu) * ((I + bi - 1) / bi);
  const int blocks = persistent_blocks(grid_kernel<D, T>, smem, tiles);
  if (blocks < 0) return -blocks;
  if (blocks > 0)
    grid_kernel<D, T><<<blocks, kThreads, smem, stream>>>(share, only, other, users, items, B, I,
                                                          bu, bi, overlapped, entity_is_item, W,
                                                          b, w2, pl, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry takes the operands' type code, dtype: 0 float32, 1 bfloat16, 2
// float16 (every floating operand and output of one call has that type; the
// partial sums stay float32), and the width D (32, 64 or 128); the pair (D,
// dtype) picks the instance, and any other pair returns INVALID.
#define DEEPAPF_DISPATCH(CALL, INVALID)                               \
  switch (dtype * 1000 + D) {                                         \
    case 32: return CALL(32, float);                                  \
    case 64: return CALL(64, float);                                  \
    case 128: return CALL(128, float);                                \
    case 1032: return CALL(32, __nv_bfloat16);                        \
    case 1064: return CALL(64, __nv_bfloat16);                        \
    case 1128: return CALL(128, __nv_bfloat16);                       \
    case 2032: return CALL(32, __half);                               \
    case 2064: return CALL(64, __half);                               \
    case 2128: return CALL(128, __half);                              \
    default: return (INVALID);                                        \
  }

#define DEEPAPF_W(T) (const T*)W, (const T*)b, (const T*)w2, (const T*)pl

// share, only, other: [P, D] gathered rows; mask: [P] bool; W [D, D], b
// [D], w2 [D], pl [D]; out: [P] logits
extern "C" int deepapf_forward(const void* share, const void* only, const void* other,
                               const void* mask, const void* W, const void* b, const void* w2,
                               const void* pl, int P, int D, void* out, int dtype,
                               void* stream) {
#define DEEPAPF_FWD(d, T)                                                                 \
  forward<d, T>(gathered<T>(share, only, other, mask, P), DEEPAPF_W(T), (T*)out,   \
                       (cudaStream_t)stream)
  DEEPAPF_DISPATCH(DEEPAPF_FWD, (int)cudaErrorInvalidValue)
#undef DEEPAPF_FWD
}

// share_tab, only_tab: the entity side's tables; other_tab: the other
// side's; users [B], items [I] int32; out: [B, I] sigmoid probabilities
extern "C" int deepapf_grid(const void* share_tab, const void* only_tab, const void* other_tab,
                            const void* users, const void* items, int B, int I,
                            int overlapped, int entity_is_item, const void* W,
                            const void* b, const void* w2, const void* pl, int D, void* out,
                            int dtype, void* stream) {
#define DEEPAPF_GRID(d, T)                                                                  \
  grid<d, T>((const T*)share_tab, (const T*)only_tab, (const T*)other_tab, (const int*)users, \
             (const int*)items, B, I, overlapped, entity_is_item, DEEPAPF_W(T),                \
             (T*)out, (cudaStream_t)stream)
  DEEPAPF_DISPATCH(DEEPAPF_GRID, (int)cudaErrorInvalidValue)
#undef DEEPAPF_GRID
}

// the backward's block count for P pairs (its partial-sum scratch has one
// row per block), or minus a CUDA error code
extern "C" int deepapf_backward_blocks(int D, int P, int dtype) {
#define DEEPAPF_BLOCKS(d, T)                                                    \
  persistent_blocks(backward_kernel<d, T>, smem_bytes<d>(true),                 \
                    ((long long)P + Shape<d>::TP - 1) / Shape<d>::TP)
  DEEPAPF_DISPATCH(DEEPAPF_BLOCKS, -(int)cudaErrorInvalidValue)
#undef DEEPAPF_BLOCKS
}

// g: [P]; d_share, d_only, d_other: [P, D]; partial: float32 [max(blocks,
// 1), D*D + 3D]; out: the summed weight gradients [dW | db | dw2 | dpl]
extern "C" int deepapf_backward(const void* share, const void* only, const void* other,
                                const void* mask, const void* W, const void* b, const void* w2,
                                const void* pl, int P, int D, const void* g, void* d_share,
                                void* d_only, void* d_other, void* partial, int blocks,
                                void* out, int dtype, void* stream) {
#define DEEPAPF_BWD(d, T)                                                                   \
  backward<d, T>(gathered<T>(share, only, other, mask, P), DEEPAPF_W(T), (const T*)g,       \
                 (T*)d_share, (T*)d_only, (T*)d_other, (float*)partial, blocks, (T*)out,     \
                 (cudaStream_t)stream)
  DEEPAPF_DISPATCH(DEEPAPF_BWD, (int)cudaErrorInvalidValue)
#undef DEEPAPF_BWD
}
