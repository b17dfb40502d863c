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
// the CUDA cores) against ~13 MB of rows (3.9 us at 3.35 TB/s), and a
// [32, 4,980] grid tile of the predict fallback ~2.76 GFLOP (41 us). The
// attention input depends on both sides of the pair, so nothing is shared
// between pairs: unlike NATR (B9) there is no anchor split, and the pair
// stage is the whole work.
//
// Design: persistent blocks of 256 threads keep W (and, in the backward,
// its transpose) in shared memory for the whole launch and take tiles of TP
// pairs (2048 / D: 32 at D = 64). A tile stages its pairs' e, o, t rows and
// the 2 TP rows of x (x_s rows, then x_o rows) in shared memory with 16-byte
// loads; the product x @ W runs with a 4 x 4 register tile per thread (one
// 16-byte load of W, broadcast to the warp, and four of x per 16
// multiply-adds); each row's a reduces over the threads of its columns with
// shuffles. The pair stage gives each pair G = 256 / TP threads and each
// thread 8 columns, interleaved so that a group reads consecutive words; the
// pair rows' stride D + G puts the groups of a warp on distinct banks. The
// grid form builds its pair's rows from the tables and the user and item
// ids itself (pair q = b I + i), so no [B I, D] tensor exists. The backward
// recomputes the forward (nothing of it is kept), then: the pair stage's
// chain rule into d(a_s) = al_s al_o (d al_s - d al_o) (and -d(a_s) for
// a_o), dZ = relu'(z) d(a) w2 in shared memory, dW += x^T dZ in registers
// (D^2 / 256 entries per thread), dx = dZ @ W^T with the same register
// tile on the staged transpose, and the rows' gradients d e, d o, d t. The
// weight gradients are sums over every pair: each block keeps its partial
// sums in registers over its tiles, writes them once, and a second launch
// adds the blocks' partials in block order. No atomics: every result is
// bit-reproducible from run to run. Not done yet: the two D x D products on
// the tensor cores (3xTF32 keeps float32 accuracy).

#include <cmath>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kMasked = -1e31f;

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
  float* al;     // [2 TP] al_s, then al_o
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

// where a launch's pairs come from: gathered rows (pair q is row q of
// share, only, other) or, for the grid, the tables and the ids (pair q =
// b I + i of users[b] x items[i])
struct Pairs {
  const float* share;
  const float* only;
  const float* other;
  const uint8_t* mask;  // pair mode: the share logit is masked
  const int* users;     // grid mode
  const int* items;
  int I;
  int overlapped;
  int entity_is_item;
  long long n;          // pairs
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

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

template <int D>
__device__ void stage_weights(const float* __restrict__ W, const float* __restrict__ b,
                              const float* __restrict__ w2, const float* __restrict__ pl,
                              bool transpose, Smem& m) {
  for (int i = threadIdx.x; i < D * D; i += kThreads) {
    const float w = __ldg(W + i);
    m.W[i] = w;
    if (transpose) m.WT[(i % D) * D + i / D] = w;
  }
  for (int d = threadIdx.x; d < D; d += kThreads) {
    m.b[d] = __ldg(b + d);
    m.w2[d] = __ldg(w2 + d);
    m.pl[d] = __ldg(pl + d);
  }
}

// The tile of pairs [q0, q0 + TP): their rows, x, masks (and the logits'
// gradients). Ends synchronised.
template <int D, bool kGrid>
__device__ void load_tile(const Pairs& pr, long long q0, const float* __restrict__ g, Smem& m) {
  using S = Shape<D>;
  const int tid = threadIdx.x;
  for (int j = tid; j < S::TP; j += kThreads) {
    const long long q = q0 + j;
    const bool ok = q < pr.n;
    int ent = -1, oth = 0, masked = 0;
    if (ok && kGrid) {
      const int bq = (int)(q / pr.I), iq = (int)(q - (long long)bq * pr.I);
      const int u = __ldg(pr.users + bq), it = __ldg(pr.items + iq);
      ent = pr.entity_is_item ? it : u;
      oth = pr.entity_is_item ? u : it;
      masked = ent > pr.overlapped;  // strict >, as the reference's
    } else if (ok) {
      ent = oth = (int)q;
      masked = __ldg(pr.mask + q) != 0;
    }
    m.ent[j] = ent;
    m.oth[j] = oth;
    m.msk[j] = masked;
    if (g != nullptr) m.g[j] = ok ? __ldg(g + q) : 0.f;
  }
  __syncthreads();
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = tid; e < S::TP * S::C4; e += kThreads) {
    const int j = e / S::C4, d = 4 * (e % S::C4);
    const int ent = m.ent[j];
    float4 ev = zero, ov = zero, tv = zero;
    if (ent >= 0) {
      const long long er = (long long)ent * D + d, orow = (long long)m.oth[j] * D + d;
      ev = ldg4(pr.share + er);
      ov = ldg4(pr.only + er);
      tv = ldg4(pr.other + orow);
    }
    *reinterpret_cast<float4*>(m.E + j * S::PS + d) = ev;
    *reinterpret_cast<float4*>(m.O + j * S::PS + d) = ov;
    *reinterpret_cast<float4*>(m.T + j * S::PS + d) = tv;
    *reinterpret_cast<float4*>(m.X + j * S::XS + d) = mul4(ev, tv);
    *reinterpret_cast<float4*>(m.X + (S::TP + j) * S::XS + d) = mul4(ov, tv);
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
// every row into m.a. Ends synchronised.
template <int D>
__device__ void attention_logits(Smem& m, float z[4][4]) {
  using S = Shape<D>;
  const int tx = threadIdx.x % S::C4, ty = threadIdx.x / S::C4;
  product<D>(m.X, m.W, z);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      z[r][c] = __fadd_rn(z[r][c], m.b[4 * tx + c]);
      part = fmaf(fmaxf(z[r][c], 0.f), m.w2[4 * tx + c], part);
    }
    part = group_sum<S::C4>(part);
    if (tx == 0) m.a[ty + S::RT * r] = part;
  }
  __syncthreads();
}

// the softmax of pair j: (al_s, al_o)
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

template <int D, bool kGrid>
__global__ void __launch_bounds__(kThreads)
forward_kernel(Pairs pr, const float* __restrict__ W, const float* __restrict__ b,
               const float* __restrict__ w2, const float* __restrict__ pl,
               float* __restrict__ out) {
  using S = Shape<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  Smem m = carve<D>(smem, false);
  stage_weights<D>(W, b, w2, pl, false, m);
  const int j = threadIdx.x / S::G, l = threadIdx.x % S::G;
  const long long tiles = (pr.n + S::TP - 1) / S::TP;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long q0 = t * S::TP;
    load_tile<D, kGrid>(pr, q0, nullptr, m);
    float z[4][4];
    attention_logits<D>(m, z);
    float als, alo;
    softmax2<D>(m, j, als, alo);
    float acc = 0.f;
#pragma unroll
    for (int v = 0; v < S::V; ++v) {
      const int d = l + S::G * v;
      const float ent = __fadd_rn(__fmul_rn(als, m.E[j * S::PS + d]),
                                  __fmul_rn(alo, m.O[j * S::PS + d]));
      acc = fmaf(__fmul_rn(ent, m.T[j * S::PS + d]), m.pl[d], acc);
    }
    acc = group_sum<S::G>(acc);
    if (l == 0 && q0 + j < pr.n)
      out[q0 + j] = kGrid ? __fdiv_rn(1.f, __fadd_rn(1.f, expf(-acc))) : acc;
    __syncthreads();
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
backward_kernel(Pairs pr, const float* __restrict__ W, const float* __restrict__ b,
                const float* __restrict__ w2, const float* __restrict__ pl,
                const float* __restrict__ g, float* __restrict__ d_share,
                float* __restrict__ d_only, float* __restrict__ d_other,
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
    load_tile<D, false>(pr, q0, g, m);
    float z[4][4];
    attention_logits<D>(m, z);

    // the pair stage's chain rule: d(al) from d(ent) = g t pl, then the
    // softmax's d(a_s) = al_s al_o (d al_s - d al_o), d(a_o) = -d(a_s)
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
        m.al[j] = als;
        m.al[S::TP + j] = alo;
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
        const float ent = __fadd_rn(__fmul_rn(als, e), __fmul_rn(alo, o));
        const float gent = __fmul_rn(gj, ent);
        const float dent = __fmul_rn(__fmul_rn(gj, tt), m.pl[d]);
        acc_pl[v] = fmaf(gent, tt, acc_pl[v]);
        if (ok) {
          d_share[q * D + d] = fmaf(dxs, tt, __fmul_rn(als, dent));
          d_only[q * D + d] = fmaf(dxo, tt, __fmul_rn(alo, dent));
          d_other[q * D + d] = fmaf(dxo, o, fmaf(dxs, e, __fmul_rn(gent, m.pl[d])));
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

// out[i] = sum over blocks k, in order, of partial[k, i]
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ partial, int blocks, int n, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < blocks; ++k) s = __fadd_rn(s, partial[(long long)k * n + i]);
  out[i] = s;
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

template <int D, bool kGrid>
int forward(const Pairs& pr, const float* W, const float* b, const float* w2, const float* pl,
            float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(false);
  const long long tiles = (pr.n + Shape<D>::TP - 1) / Shape<D>::TP;
  const int blocks = persistent_blocks(forward_kernel<D, kGrid>, smem, tiles);
  if (blocks < 0) return -blocks;
  if (blocks > 0)
    forward_kernel<D, kGrid><<<blocks, kThreads, smem, stream>>>(pr, W, b, w2, pl, out);
  return (int)cudaGetLastError();
}

template <int D>
int backward(const Pairs& pr, const float* W, const float* b, const float* w2, const float* pl,
             const float* g, float* d_share, float* d_only, float* d_other, float* partial,
             int blocks, float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(true);
  const int n = Shape<D>::NPART;
  if (blocks > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        backward_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    backward_kernel<D><<<blocks, kThreads, smem, stream>>>(pr, W, b, w2, pl, g, d_share,
                                                            d_only, d_other, partial);
    const cudaError_t e2 = cudaGetLastError();
    if (e2 != cudaSuccess) return (int)e2;
  } else {
    const cudaError_t e = cudaMemsetAsync(partial, 0, (size_t)n * sizeof(float), stream);
    if (e != cudaSuccess) return (int)e;
  }
  reduce_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, blocks > 0 ? blocks : 1, n, out);
  return (int)cudaGetLastError();
}

Pairs gathered(const void* share, const void* only, const void* other, const void* mask,
               int P) {
  Pairs pr{};
  pr.share = (const float*)share;
  pr.only = (const float*)only;
  pr.other = (const float*)other;
  pr.mask = (const uint8_t*)mask;
  pr.n = P;
  return pr;
}

}  // namespace

#define DEEPAPF_W (const float*)W, (const float*)b, (const float*)w2, (const float*)pl

// share, only, other: [P, D] gathered rows; mask: [P] bool; W [D, D], b
// [D], w2 [D], pl [D]; out: [P] logits
extern "C" int deepapf_forward(const void* share, const void* only, const void* other,
                               const void* mask, const void* W, const void* b, const void* w2,
                               const void* pl, int P, int D, void* out, void* stream) {
  const Pairs pr = gathered(share, only, other, mask, P);
  cudaStream_t st = (cudaStream_t)stream;
  float* o = (float*)out;
  switch (D) {
    case 32: return forward<32, false>(pr, DEEPAPF_W, o, st);
    case 64: return forward<64, false>(pr, DEEPAPF_W, o, st);
    case 128: return forward<128, false>(pr, DEEPAPF_W, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// share_tab, only_tab: the entity side's tables; other_tab: the other
// side's; users [B], items [I] int32; out: [B, I] sigmoid probabilities
extern "C" int deepapf_grid(const void* share_tab, const void* only_tab, const void* other_tab,
                            const void* users, const void* items, int B, int I, int overlapped,
                            int entity_is_item, const void* W, const void* b, const void* w2,
                            const void* pl, int D, void* out, void* stream) {
  Pairs pr{};
  pr.share = (const float*)share_tab;
  pr.only = (const float*)only_tab;
  pr.other = (const float*)other_tab;
  pr.users = (const int*)users;
  pr.items = (const int*)items;
  pr.I = I;
  pr.overlapped = overlapped;
  pr.entity_is_item = entity_is_item;
  pr.n = (long long)B * I;
  cudaStream_t st = (cudaStream_t)stream;
  float* o = (float*)out;
  switch (D) {
    case 32: return forward<32, true>(pr, DEEPAPF_W, o, st);
    case 64: return forward<64, true>(pr, DEEPAPF_W, o, st);
    case 128: return forward<128, true>(pr, DEEPAPF_W, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the backward's block count for P pairs (its partial-sum scratch has one
// row per block), or minus a CUDA error code
extern "C" int deepapf_backward_blocks(int D, int P) {
#define DEEPAPF_BLOCKS(d)                                                       \
  persistent_blocks(backward_kernel<d>, smem_bytes<d>(true),                   \
                    ((long long)P + Shape<d>::TP - 1) / Shape<d>::TP)
  switch (D) {
    case 32: return DEEPAPF_BLOCKS(32);
    case 64: return DEEPAPF_BLOCKS(64);
    case 128: return DEEPAPF_BLOCKS(128);
    default: return -(int)cudaErrorInvalidValue;
  }
#undef DEEPAPF_BLOCKS
}

// g: [P]; d_share, d_only, d_other: [P, D]; partial: [max(blocks, 1), D*D +
// 3D]; out: the summed weight gradients [dW | db | dw2 | dpl]
extern "C" int deepapf_backward(const void* share, const void* only, const void* other,
                                const void* mask, const void* W, const void* b, const void* w2,
                                const void* pl, int P, int D, const void* g, void* d_share,
                                void* d_only, void* d_other, void* partial, int blocks,
                                void* out, void* stream) {
  const Pairs pr = gathered(share, only, other, mask, P);
  cudaStream_t st = (cudaStream_t)stream;
  const float* gg = (const float*)g;
  float *ds = (float*)d_share, *dn = (float*)d_only, *dt = (float*)d_other;
  float *pa = (float*)partial, *o = (float*)out;
  switch (D) {
    case 32: return backward<32>(pr, DEEPAPF_W, gg, ds, dn, dt, pa, blocks, o, st);
    case 64: return backward<64>(pr, DEEPAPF_W, gg, ds, dn, dt, pa, blocks, o, st);
    case 128: return backward<128>(pr, DEEPAPF_W, gg, ds, dn, dt, pa, blocks, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
