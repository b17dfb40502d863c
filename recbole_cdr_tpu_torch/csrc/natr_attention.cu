// B9: NATR's history attention, forward, backward and full-sort.
//
// Replaces recbole_cdr_tpu/models/natr.py:101-128 NATR._phase2_logit (XLA
// gathers of a [P, H, D] history block, its transfer matmul, the masked
// softmax and the blend, recomputed for every (user, item) pair) and its
// autodiff. For an anchor a (the user in overlap_items mode, the item in
// overlap_users mode) with target embedding pu and history ids hist[a, :H]:
//
//   anchor stage: h_j  = src[hist[a, j]] @ W + b          (every j < H; padded
//                                                          slots gather row 0)
//                 s_j  = relu(pu * h_j) . w_ua + b_ua + (mask_j ? 0 : -10000)
//                 att  = softmax(s),   su = sum_j att_j h_j
//   pair stage:   b_s  = relu(su * q) . w_da + b_da,  b_p = relu(pu * q) . w_da + b_da
//                 beta = exp(b_s) / (exp(b_s) + exp(b_p))        (JAX's form)
//                 logit = (beta su + (1 - beta) pu) . q
//
// Bound on an H100: bytes in training, operations in a full-sort tile. h_j
// depends on the source row alone, so the least work transfers each distinct
// gathered row once (a training step's ~2,100 distinct anchors gather ~4,000
// distinct rows: 2 D^2 each, ~33 MFLOP) and does O(D) per slot and per pair;
// a step then moves ~6 MB and the forward is bound near 2 us by bytes, the
// backward near 3 us; a [32, ~5,000] full-sort tile near 1.6 us by its
// pairs' O(D) blends (10 D + 13 operations a pair: the products su_d q_d and
// pu_d q_d serve both the gates and the dots). The training kernels are far
// above their bounds: they run the transfer once per slot of every anchor
// they take (H D^2 multiply-adds per anchor, ~30 flops per gathered byte, so
// each anchor stage is compute-heavy) and take one anchor per pair. Design:
// su and pu depend only on the anchor, so the anchor stage runs once per
// anchor it takes and the pair stage once per pair, where JAX's fallback
// repeats the whole attention for every pair. Training takes one anchor per
// pair. Full-sort scoring splits in two launches: the anchor table (the
// anchor stage of every anchor row of the domain, once per parameter
// version: the caller caches it, so an evaluation pass builds it once and
// no user tile relaunches it) and the pair grid, one launch per tile, whose
// blocks stage 8 anchor or query rows and 32 of the other side's in shared
// memory with 16-byte loads and give each thread a 2 x 1 tile of pairs; one
// pass over D keeps four sums per pair (both gates' sums and both dots), so
// an item row is read from device memory once per block rather than once per
// pair thread. Anchor stage: persistent blocks of 256
// threads keep W in shared memory and take one anchor at a time: the block
// gathers the H rows into shared memory (padded stride, no bank conflicts),
// computes the transfer with a 4 x 4 register tile per thread, reduces the
// unit-attention scores one warp per slot, takes the softmax in one warp and
// the weighted sum one thread per column. The pair stage gives one thread
// per pair, float4 loads along D. The backward recomputes the anchor stage
// (nothing of the forward is kept), then walks the chain rule back to
// d(pu), d(q) and the weight gradients; the weight gradients are sums over
// all pairs, so each block keeps its partial sums in registers (dW as a 4 x 4
// tile per thread, an [H, D] x [H, D] product per anchor) and writes them
// once, and a second launch adds the blocks' partials in block order. No
// atomics: every result is bit-reproducible from run to run. Elementwise
// steps use round-to-nearest intrinsics where the plain version rounds a
// product and a sum separately. Not done yet: transferring each distinct
// source row once (one [rows, D] x [D, D] product, then gathering h),
// sharing one anchor between the pairs of a training step that have it,
// tensor cores for the transfer (3xTF32 keeps float32 accuracy).
//
// B9-bf16, the 16-bit form (NATR under compute_dtype: bfloat16; float16
// through the same template): every operand and output is 16-bit (the
// source table, the history rows, pu, q, the weights, the upstream gradient;
// the logits, su, the grid's probabilities, every gradient). Values are
// widened exactly as they are staged (shared memory stays float32); each dot
// and each sum over H or D accumulates in float32 and is rounded to the
// 16-bit type where JAX's bf16 _phase2_logit has a named intermediate:
// h = hist_e @ W + b, the attention logits with the -10000 mask (-9984 in
// bf16), the softmax, su, b_s and b_p, beta, zu (per element) and the logit;
// the grid's sigmoid too. With zu rounded per element the grid cannot
// regroup its dots as the float32 form does, so its 16-bit instances walk D
// twice (the gates, then the blend). The backward is the float32 chain rule
// on those rounded values (the rounding passes gradients through
// unchanged), beta's and the softmax's slopes at their unrounded values, and every gradient
// rounded once to the operands' type: the weight gradients after the
// block-order sum. The float32 form is the same template with every
// rounding the identity.

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>
#include <stdint.h>

#include "float16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int D>
struct Shape {
  static constexpr int C4 = D / 4;           // column groups of 4
  static constexpr int RT = kThreads / C4;   // row threads of a product
  static constexpr int RPASS = 4 * RT;       // rows of one transfer pass
  static constexpr int RK = D / RT;          // rows of dW per thread
  static constexpr int JG = kThreads / D;    // slot groups of the (j, d) pass
  static constexpr int EST = D + 1;          // padded stride of the gathered rows
  static constexpr int NPART = D * D + 3 * D + 2;
};

__host__ __device__ inline int hpad(int H, int rpass) {
  return ((H > 0 ? H : 1) + rpass - 1) / rpass * rpass;
}

inline size_t smem_bytes(int D, int H) {
  const int hp = hpad(H, 4 * kThreads / (D / 4));
  const size_t floats = (size_t)D * D + (size_t)hp * (D + 1) + (size_t)hp * D +
                        3 * (size_t)hp + 4 * (size_t)D + kThreads;
  return 4 * floats + 4 * (size_t)hp + (size_t)hp;
}

struct Smem {
  float* W;    // [D, D] transfer weight
  float* E;    // [hp, D + 1] gathered history rows
  float* T;    // [hp, D] transferred rows (the backward overwrites them with dT)
  float* att;  // [hp] softmax, rounded to the operands' type
  float* s;    // [hp] scores, then the unrounded softmax, then the scores' gradient
  float* da;   // [hp] gradient of att
  float* pu;   // [D]
  float* su;   // [D]
  float* dsu;  // [D]
  float* dpu;  // [D] the pair stage's part of d(pu)
  float* red;  // [kThreads] reduction scratch
  int* hid;    // [hp] history ids
  uint8_t* msk;  // [hp] history mask
};

template <int D>
__device__ Smem carve(unsigned char* base, int hp) {
  Smem m;
  float* f = reinterpret_cast<float*>(base);
  m.W = f;   f += D * D;
  m.E = f;   f += hp * (D + 1);
  m.T = f;   f += hp * D;
  m.att = f; f += hp;
  m.s = f;   f += hp;
  m.da = f;  f += hp;
  m.pu = f;  f += D;
  m.su = f;  f += D;
  m.dsu = f; f += D;
  m.dpu = f; f += D;
  m.red = f; f += kThreads;
  m.hid = reinterpret_cast<int*>(f);
  m.msk = reinterpret_cast<uint8_t*>(m.hid + hp);
  return m;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float relu_mul(float a, float b) {
  return fmaxf(__fmul_rn(a, b), 0.f);
}

template <int D, typename T>
__device__ void stage_weight(const T* __restrict__ W, Smem& m) {
  for (int i = threadIdx.x; i < D * D; i += kThreads) m.W[i] = ld1(W + i);
}

// The anchor stage of one anchor, by the whole block: leaves m.T (the
// transferred rows), m.att (the softmax), m.su and m.pu, each rounded to T.
// Ends synchronised.
template <int D, typename T>
__device__ void anchor_stage(const T* __restrict__ src, const int* __restrict__ ids,
                             const uint8_t* __restrict__ mask, int aid, int H, int hp,
                             const T* __restrict__ pu_row, const T* __restrict__ b,
                             const T* __restrict__ w_ua, float b_ua, Smem& m) {
  using S = Shape<D>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < hp; j += kThreads) {
    const bool real = j < H;
    m.hid[j] = real ? __ldg(ids + (long long)aid * H + j) : 0;
    m.msk[j] = real ? __ldg(mask + (long long)aid * H + j) : 0;
  }
  for (int d = tid; d < D; d += kThreads) m.pu[d] = ld1(pu_row + d);
  __syncthreads();
  for (int i = tid; i < hp * D; i += kThreads) {
    const int j = i / D, k = i - j * D;
    m.E[j * S::EST + k] = j < H ? ld1(src + (long long)m.hid[j] * D + k) : 0.f;
  }
  __syncthreads();

  // T = E @ W + b: rows ty + RT r (r < 4) of each pass, columns 4 tx .. 4 tx + 3
  const int tx = tid % S::C4, ty = tid / S::C4;
  float bias[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) bias[c] = ld1(b + 4 * tx + c);
  for (int j0 = 0; j0 < hp; j0 += S::RPASS) {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    const float* e0 = m.E + (j0 + ty) * S::EST;
#pragma unroll 4
    for (int k = 0; k < D; ++k) {
      const float4 w = *reinterpret_cast<const float4*>(m.W + k * D + 4 * tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = e0[r * S::RT * S::EST + k];
        acc[r][0] = fmaf(e, w.x, acc[r][0]);
        acc[r][1] = fmaf(e, w.y, acc[r][1]);
        acc[r][2] = fmaf(e, w.z, acc[r][2]);
        acc[r][3] = fmaf(e, w.w, acc[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + ty + S::RT * r;
      *reinterpret_cast<float4*>(m.T + j * D + 4 * tx) = make_float4(
          rnd<T>(__fadd_rn(acc[r][0], bias[0])), rnd<T>(__fadd_rn(acc[r][1], bias[1])),
          rnd<T>(__fadd_rn(acc[r][2], bias[2])), rnd<T>(__fadd_rn(acc[r][3], bias[3])));
    }
  }
  __syncthreads();

  for (int j = warp; j < H; j += kWarps) {
    float acc = 0.f;
    for (int d = lane; d < D; d += 32)
      acc = fmaf(relu_mul(m.pu[d], m.T[j * D + d]), ld1(w_ua + d), acc);
    acc = warp_sum(acc);
    if (lane == 0)
      m.s[j] = rnd<T>(__fadd_rn(__fadd_rn(acc, b_ua), m.msk[j] ? 0.f : -10000.f));
  }
  __syncthreads();

  if (warp == 0) {
    float mx = -INFINITY;
    for (int j = lane; j < H; j += 32) mx = fmaxf(mx, m.s[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < H; j += 32) {
      const float e = expf(__fsub_rn(m.s[j], mx));
      m.att[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    // the weights rounded to T for the weighted sum; the unrounded ones, in
    // place of the scores, for the softmax's backward
    for (int j = lane; j < H; j += 32) {
      const float a = __fdiv_rn(m.att[j], sum);
      m.s[j] = a;
      m.att[j] = rnd<T>(a);
    }
  }
  __syncthreads();

  for (int d = tid; d < D; d += kThreads) {
    float acc = 0.f;
    for (int j = 0; j < H; ++j) acc = fmaf(m.att[j], m.T[j * D + d], acc);
    m.su[d] = rnd<T>(acc);
  }
  __syncthreads();
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
anchor_kernel(const T* __restrict__ src, const int* __restrict__ ids,
              const uint8_t* __restrict__ mask, const int* __restrict__ anchors,
              const T* __restrict__ pu, const T* __restrict__ W, const T* __restrict__ b,
              const T* __restrict__ w_ua, const T* __restrict__ b_ua, int A, int H,
              T* __restrict__ su) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hp = hpad(H, Shape<D>::RPASS);
  Smem m = carve<D>(smem, hp);
  stage_weight<D, T>(W, m);
  __syncthreads();
  const float bua = ld1(b_ua);
  for (int a = blockIdx.x; a < A; a += gridDim.x) {
    anchor_stage<D, T>(src, ids, mask, __ldg(anchors + a), H, hp, pu + (long long)a * D, b,
                       w_ua, bua, m);
    for (int d = threadIdx.x; d < D; d += kThreads) st1(su + (long long)a * D + d, m.su[d]);
    __syncthreads();
  }
}

// the pair stage of one pair: its logit, rounded to T
template <int D, typename T>
__device__ __forceinline__ float blend(const T* __restrict__ su, const T* __restrict__ pu,
                                       const T* __restrict__ q, const T* __restrict__ w,
                                       float b_da) {
  float bs = 0.f, bp = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 s = ld4(su + d), p = ld4(pu + d), x = ld4(q + d), ww = ld4(w + d);
    bs = fmaf(relu_mul(s.x, x.x), ww.x, bs);
    bs = fmaf(relu_mul(s.y, x.y), ww.y, bs);
    bs = fmaf(relu_mul(s.z, x.z), ww.z, bs);
    bs = fmaf(relu_mul(s.w, x.w), ww.w, bs);
    bp = fmaf(relu_mul(p.x, x.x), ww.x, bp);
    bp = fmaf(relu_mul(p.y, x.y), ww.y, bp);
    bp = fmaf(relu_mul(p.z, x.z), ww.z, bp);
    bp = fmaf(relu_mul(p.w, x.w), ww.w, bp);
  }
  bs = rnd<T>(__fadd_rn(bs, b_da));
  bp = rnd<T>(__fadd_rn(bp, b_da));
  const float es = expf(bs), ep = expf(bp);
  const float beta = rnd<T>(__fdiv_rn(es, __fadd_rn(es, ep)));
  const float omb = __fsub_rn(1.f, beta);
  float acc = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 s = ld4(su + d), p = ld4(pu + d), x = ld4(q + d);
    acc = fmaf(rnd<T>(__fadd_rn(__fmul_rn(beta, s.x), __fmul_rn(omb, p.x))), x.x, acc);
    acc = fmaf(rnd<T>(__fadd_rn(__fmul_rn(beta, s.y), __fmul_rn(omb, p.y))), x.y, acc);
    acc = fmaf(rnd<T>(__fadd_rn(__fmul_rn(beta, s.z), __fmul_rn(omb, p.z))), x.z, acc);
    acc = fmaf(rnd<T>(__fadd_rn(__fmul_rn(beta, s.w), __fmul_rn(omb, p.w))), x.w, acc);
  }
  return rnd<T>(acc);
}

// `n` aligned pairs (anchor i, query i) -> logits
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
pair_kernel(const T* __restrict__ su, const T* __restrict__ pu, const T* __restrict__ q,
            const T* __restrict__ w_da, const T* __restrict__ b_da, int n,
            T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  st1(out + i, blend<D, T>(su + i * D, pu + i * D, q + i * D, w_da, ld1(b_da)));
}

// ---- the full-sort grid -----------------------------------------------------

constexpr int kGridThreads = 128;
constexpr int kGridI = 2;      // output rows per thread (all of its warp's)
constexpr int kGridJ = 1;      // output columns per thread (lane, lane + 32, ...)
constexpr int kGridRows = kGridI * kGridThreads / 32;  // output rows per block
constexpr int kGridCols = 32 * kGridJ;                 // output columns per block

template <int D>
size_t grid_smem_bytes() {
  // the row side's vectors [kGridRows][D] (two of them at most), the column
  // side's [kGridCols][D + 1] (two at most), w_da
  return 4 * (2 * kGridRows * D + 2 * kGridCols * (D + 1) + D);
}

// out [R, C] = sigmoid(logit) of every (row r, column c) pair. With
// kAnchorRow the anchors (su, pu) are the rows and the queries q the
// columns, else the other way round. A block stages its rows' and columns'
// vectors in shared memory with 16-byte loads (8-byte for 16-bit operands;
// the columns at a padded stride, so the lanes' reads fall in distinct
// banks), then each thread walks D for its kGridI x kGridJ pairs. The
// float32 form walks it once, keeping four sums per pair: the gates' sum
// w.relu(su q) and w.relu(pu q), and the dots su.q and pu.q; then beta =
// exp(b_s) / (exp(b_s) + exp(b_p)), logit = beta su.q + (1 - beta) pu.q:
// the pair stage's blend, regrouped. The 16-bit form rounds zu per element,
// which does not regroup: it walks D for the gates, then again for the sum
// of zu_d q_d.
template <int D, bool kAnchorRow, typename T>
__global__ void __launch_bounds__(kGridThreads)
pair_grid_kernel(const T* __restrict__ su, const T* __restrict__ pu, const T* __restrict__ q,
                 const T* __restrict__ w_da, const T* __restrict__ b_da, int R, int C,
                 T* __restrict__ out) {
  constexpr int C4 = D / 4;
  constexpr int CST = D + 1;
  extern __shared__ __align__(16) float gsm[];
  float* row_a = gsm;                                // [kGridRows][D]: su, or q
  float* row_b = row_a + kGridRows * D;              // [kGridRows][D]: pu
  float* col_a = row_b + kGridRows * D;              // [kGridCols][CST]: q, or su
  float* col_b = col_a + kGridCols * CST;            // [kGridCols][CST]: pu
  float* w = col_b + kGridCols * CST;                // [D]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.y * kGridRows, c0 = blockIdx.x * kGridCols;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = tid; e < kGridRows * C4; e += kGridThreads) {
    const int r = e / C4, d = 4 * (e % C4);
    const bool ok = r0 + r < R;
    const long long at = (long long)(r0 + r) * D + d;
    *reinterpret_cast<float4*>(row_a + r * D + d) = ok ? ld4((kAnchorRow ? su : q) + at) : zero;
    if (kAnchorRow)
      *reinterpret_cast<float4*>(row_b + r * D + d) = ok ? ld4(pu + at) : zero;
  }
  for (int e = tid; e < kGridCols * C4; e += kGridThreads) {
    const int c = e / C4, d = 4 * (e % C4);
    const bool ok = c0 + c < C;
    const long long at = (long long)(c0 + c) * D + d;
    const float4 a = ok ? ld4((kAnchorRow ? q : su) + at) : zero;
    float* x = col_a + c * CST + d;
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    if (!kAnchorRow) {
      const float4 b = ok ? ld4(pu + at) : zero;
      float* y = col_b + c * CST + d;
      y[0] = b.x; y[1] = b.y; y[2] = b.z; y[3] = b.w;
    }
  }
  for (int d = tid; d < D; d += kGridThreads) w[d] = ld1(w_da + d);
  __syncthreads();

  float gs[kGridI][kGridJ], gp[kGridI][kGridJ], ds[kGridI][kGridJ], dp[kGridI][kGridJ];
#pragma unroll
  for (int i = 0; i < kGridI; ++i)
#pragma unroll
    for (int j = 0; j < kGridJ; ++j) gs[i][j] = gp[i][j] = ds[i][j] = dp[i][j] = 0.f;
  const float* ra = row_a + (kGridI * warp) * D;
  const float* rb = row_b + (kGridI * warp) * D;
  const float* ca = col_a + lane * CST;
  const float* cb = col_b + lane * CST;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float wd = w[d];
    float xa[kGridJ], xb[kGridJ], ya[kGridI], yb[kGridI];
#pragma unroll
    for (int j = 0; j < kGridJ; ++j) {
      xa[j] = ca[32 * j * CST + d];
      xb[j] = kAnchorRow ? 0.f : cb[32 * j * CST + d];
    }
#pragma unroll
    for (int i = 0; i < kGridI; ++i) {
      ya[i] = ra[i * D + d];
      yb[i] = kAnchorRow ? rb[i * D + d] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kGridI; ++i)
#pragma unroll
      for (int j = 0; j < kGridJ; ++j) {
        const float s = kAnchorRow ? ya[i] : xa[j];  // su
        const float p = kAnchorRow ? yb[i] : xb[j];  // pu
        const float x = kAnchorRow ? xa[j] : ya[i];  // q
        const float ms = __fmul_rn(s, x), mp = __fmul_rn(p, x);
        if constexpr (kWide<T>) {
          ds[i][j] = __fadd_rn(ds[i][j], ms);
          dp[i][j] = __fadd_rn(dp[i][j], mp);
        }
        gs[i][j] = fmaf(fmaxf(ms, 0.f), wd, gs[i][j]);
        gp[i][j] = fmaf(fmaxf(mp, 0.f), wd, gp[i][j]);
      }
  }
  const float bda = ld1(b_da);
  float beta[kGridI][kGridJ];
#pragma unroll
  for (int i = 0; i < kGridI; ++i)
#pragma unroll
    for (int j = 0; j < kGridJ; ++j) {
      const float es = expf(rnd<T>(__fadd_rn(gs[i][j], bda)));
      const float ep = expf(rnd<T>(__fadd_rn(gp[i][j], bda)));
      beta[i][j] = rnd<T>(__fdiv_rn(es, __fadd_rn(es, ep)));
    }
  if constexpr (!kWide<T>) {  // zu_d = round(beta su_d + (1 - beta) pu_d); ds holds sum zu_d q_d
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
#pragma unroll
      for (int i = 0; i < kGridI; ++i)
#pragma unroll
        for (int j = 0; j < kGridJ; ++j) {
          const float s = kAnchorRow ? ra[i * D + d] : ca[32 * j * CST + d];
          const float p = kAnchorRow ? rb[i * D + d] : cb[32 * j * CST + d];
          const float x = kAnchorRow ? ca[32 * j * CST + d] : ra[i * D + d];
          const float b = beta[i][j];
          const float z = rnd<T>(__fadd_rn(__fmul_rn(b, s), __fmul_rn(__fsub_rn(1.f, b), p)));
          ds[i][j] = fmaf(z, x, ds[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < kGridI; ++i) {
    const int r = r0 + kGridI * warp + i;
    if (r >= R) break;
#pragma unroll
    for (int j = 0; j < kGridJ; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c >= C) continue;
      float logit;
      if constexpr (kWide<T>)
        logit = __fadd_rn(__fmul_rn(beta[i][j], ds[i][j]),
                          __fmul_rn(__fsub_rn(1.f, beta[i][j]), dp[i][j]));
      else
        logit = rnd<T>(ds[i][j]);
      st1(out + (long long)r * C + c, rnd<T>(__fdiv_rn(1.f, __fadd_rn(1.f, expf(-logit)))));
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
backward_kernel(const T* __restrict__ src, const int* __restrict__ ids,
                const uint8_t* __restrict__ mask, const int* __restrict__ anchors,
                const T* __restrict__ pu, const T* __restrict__ q, const T* __restrict__ W,
                const T* __restrict__ b, const T* __restrict__ w_ua,
                const T* __restrict__ b_ua, const T* __restrict__ w_da,
                const T* __restrict__ b_da, int P, int H, const T* __restrict__ g,
                T* __restrict__ dpu, T* __restrict__ dq, float* __restrict__ partial) {
  using S = Shape<D>;
  constexpr int V = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hp = hpad(H, S::RPASS);
  Smem m = carve<D>(smem, hp);
  stage_weight<D, T>(W, m);
  __syncthreads();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % S::C4, ty = tid / S::C4;  // dW tile
  const int pd = tid % D, jg = tid / D;          // (j, d) pass
  const float bua = ld1(b_ua), bda = ld1(b_da);

  float acc_w[S::RK][4];
#pragma unroll
  for (int r = 0; r < S::RK; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_w[r][c] = 0.f;
  float acc_b = 0.f, acc_wua = 0.f, acc_bua = 0.f, acc_bda = 0.f;
  float acc_wda[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc_wda[v] = 0.f;

  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    anchor_stage<D, T>(src, ids, mask, __ldg(anchors + p), H, hp, pu + (long long)p * D, b,
                       w_ua, bua, m);

    // the pair stage's chain rule, one warp: d(su), the direct d(pu), d(q)
    if (warp == 0) {
      const float gp = ld1(g + p);
      float sv[V], pv[V], qv[V], wv[V];
      float bs = 0.f, bp = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int d = lane + 32 * v;
        sv[v] = m.su[d];
        pv[v] = m.pu[d];
        qv[v] = ld1(q + (long long)p * D + d);
        wv[v] = ld1(w_da + d);
        bs = fmaf(relu_mul(sv[v], qv[v]), wv[v], bs);
        bp = fmaf(relu_mul(pv[v], qv[v]), wv[v], bp);
      }
      bs = rnd<T>(__fadd_rn(warp_sum(bs), bda));
      bp = rnd<T>(__fadd_rn(warp_sum(bp), bda));
      const float es = expf(bs), ep = expf(bp);
      // beta's value is rounded to T, its slope taken at the unrounded quotient
      const float beta_q = __fdiv_rn(es, __fadd_rn(es, ep));
      const float beta = rnd<T>(beta_q);
      const float omb = __fsub_rn(1.f, beta);
      float dbeta = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v)
        dbeta = fmaf(__fmul_rn(gp, qv[v]), __fsub_rn(sv[v], pv[v]), dbeta);
      dbeta = warp_sum(dbeta);
      // d b_s; d b_p = -d b_s
      const float dbs = __fmul_rn(__fmul_rn(dbeta, beta_q), __fsub_rn(1.f, beta_q));
      const float dbp = -dbs;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int d = lane + 32 * v;
        const float dz = __fmul_rn(gp, qv[v]);
        const float us = __fmul_rn(sv[v], qv[v]), up = __fmul_rn(pv[v], qv[v]);
        const float gs = us > 0.f ? __fmul_rn(dbs, wv[v]) : 0.f;
        const float gq = up > 0.f ? __fmul_rn(dbp, wv[v]) : 0.f;
        m.dsu[d] = fmaf(gs, qv[v], __fmul_rn(beta, dz));
        m.dpu[d] = fmaf(gq, qv[v], __fmul_rn(omb, dz));
        const float z = rnd<T>(__fadd_rn(__fmul_rn(beta, sv[v]), __fmul_rn(omb, pv[v])));
        st1(dq + (long long)p * D + d,
            rnd<T>(fmaf(gq, pv[v], fmaf(gs, sv[v], __fmul_rn(gp, z)))));
        acc_wda[v] = fmaf(dbs, fmaxf(us, 0.f), fmaf(dbp, fmaxf(up, 0.f), acc_wda[v]));
      }
      if (lane == 0) acc_bda = __fadd_rn(acc_bda, __fadd_rn(dbs, dbp));
    }
    __syncthreads();

    // d(att_j) = d(su) . h_j, one warp per slot
    for (int j = warp; j < H; j += kWarps) {
      float acc = 0.f;
      for (int d = lane; d < D; d += 32) acc = fmaf(m.dsu[d], m.T[j * D + d], acc);
      acc = warp_sum(acc);
      if (lane == 0) m.da[j] = acc;
    }
    __syncthreads();
    // the softmax's backward at its unrounded weights (in m.s):
    // d(s_j) = att_j (d(att_j) - sum_k att_k d(att_k))
    if (warp == 0) {
      float c = 0.f;
      for (int j = lane; j < H; j += 32) c = fmaf(m.s[j], m.da[j], c);
      c = warp_sum(c);
      for (int j = lane; j < H; j += 32) m.s[j] = __fmul_rn(m.s[j], __fsub_rn(m.da[j], c));
    }
    __syncthreads();

    // (j, d) pass: d(pu) and d(w_ua) through the scores, then dT in place
    {
      const float pud = m.pu[pd], wud = ld1(w_ua + pd), dsud = m.dsu[pd];
      float dpu_part = 0.f;
      for (int j = jg; j < H; j += S::JG) {
        const float t = m.T[j * D + pd];
        const float y = __fmul_rn(pud, t);
        const float ds = m.s[j];
        const float dy = y > 0.f ? __fmul_rn(ds, wud) : 0.f;
        dpu_part = fmaf(dy, t, dpu_part);
        acc_wua = fmaf(ds, fmaxf(y, 0.f), acc_wua);
        const float dt = fmaf(m.att[j], dsud, __fmul_rn(dy, pud));
        m.T[j * D + pd] = dt;
        acc_b = __fadd_rn(acc_b, dt);
      }
      m.red[tid] = dpu_part;
    }
    if (tid == 0)
      for (int j = 0; j < H; ++j) acc_bua = __fadd_rn(acc_bua, m.s[j]);
    __syncthreads();
    if (tid < D) {
      float s = m.dpu[tid];
      for (int k = 0; k < S::JG; ++k) s = __fadd_rn(s, m.red[k * D + tid]);
      st1(dpu + (long long)p * D + tid, rnd<T>(s));
    }
    // dW += E^T dT over the real slots
    for (int j = 0; j < H; ++j) {
      const float4 dt = *reinterpret_cast<const float4*>(m.T + j * D + 4 * tx);
      const float* e = m.E + j * S::EST + ty;
#pragma unroll
      for (int r = 0; r < S::RK; ++r) {
        const float x = e[S::RT * r];
        acc_w[r][0] = fmaf(x, dt.x, acc_w[r][0]);
        acc_w[r][1] = fmaf(x, dt.y, acc_w[r][1]);
        acc_w[r][2] = fmaf(x, dt.z, acc_w[r][2]);
        acc_w[r][3] = fmaf(x, dt.w, acc_w[r][3]);
      }
    }
    __syncthreads();
  }

  // this block's partial sums: [dW | db | dw_ua | db_ua | dw_da | db_da]
  float* part = partial + (long long)blockIdx.x * S::NPART;
#pragma unroll
  for (int r = 0; r < S::RK; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[(ty + S::RT * r) * D + 4 * tx + c] = acc_w[r][c];
  m.red[tid] = acc_b;
  __syncthreads();
  if (tid < D) {
    float s = 0.f;
    for (int k = 0; k < S::JG; ++k) s = __fadd_rn(s, m.red[k * D + tid]);
    part[D * D + tid] = s;
  }
  __syncthreads();
  m.red[tid] = acc_wua;
  __syncthreads();
  if (tid < D) {
    float s = 0.f;
    for (int k = 0; k < S::JG; ++k) s = __fadd_rn(s, m.red[k * D + tid]);
    part[D * D + D + tid] = s;
  }
  if (tid == 0) {
    part[D * D + 2 * D] = acc_bua;
    part[D * D + 3 * D + 1] = acc_bda;
  }
  if (warp == 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) part[D * D + 2 * D + 1 + lane + 32 * v] = acc_wda[v];
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

// blocks of a persistent launch: every SM full, never more blocks than work
template <typename K>
int persistent_blocks(K kernel, size_t smem, int work) {
  if (work <= 0) return 0;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  const long long full = (long long)sms * (occ > 0 ? occ : 1);
  return (int)(full < work ? full : work);
}

// su [A, D] of anchors [A] with pu [A, D]: one persistent launch over every SM
template <int D, typename T>
int anchor_table(const T* src, const int* ids, const uint8_t* mask, const int* anchors,
                 const T* pu, const T* W, const T* b, const T* w_ua, const T* b_ua, int H,
                 int A, T* su, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, H);
  const int blocks = persistent_blocks(anchor_kernel<D, T>, smem, A);
  if (blocks < 0) return -blocks;
  if (blocks > 0)
    anchor_kernel<D, T><<<blocks, kThreads, smem, stream>>>(src, ids, mask, anchors, pu, W, b,
                                                              w_ua, b_ua, A, H, su);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int forward(const T* src, const int* ids, const uint8_t* mask, const int* anchors,
            const T* pu, const T* q, const T* W, const T* b, const T* w_ua, const T* b_ua,
            const T* w_da, const T* b_da, int H, int P, T* su, T* out, cudaStream_t stream) {
  const int e =
      anchor_table<D, T>(src, ids, mask, anchors, pu, W, b, w_ua, b_ua, H, P, su, stream);
  if (e != 0) return e;
  if (P > 0)
    pair_kernel<D, T><<<(unsigned)((P + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        su, pu, q, w_da, b_da, P, out);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int pair_grid(const T* su, const T* pu, const T* q, const T* w_da, const T* b_da, int A,
              int Nq, bool anchor_is_row, T* out, cudaStream_t stream) {
  const int R = anchor_is_row ? A : Nq, C = anchor_is_row ? Nq : A;
  if (R <= 0 || C <= 0) return (int)cudaGetLastError();
  const size_t smem = grid_smem_bytes<D>();
  auto kernel = anchor_is_row ? pair_grid_kernel<D, true, T> : pair_grid_kernel<D, false, T>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((C + kGridCols - 1) / kGridCols, (R + kGridRows - 1) / kGridRows);
  kernel<<<grid, kGridThreads, smem, stream>>>(su, pu, q, w_da, b_da, R, C, out);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int backward(const T* src, const int* ids, const uint8_t* mask, const int* anchors,
             const T* pu, const T* q, const T* W, const T* b, const T* w_ua, const T* b_ua,
             const T* w_da, const T* b_da, int H, int P, const T* g, T* dpu, T* dq,
             float* partial, int blocks, T* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, H);
  const int n = Shape<D>::NPART;
  if (blocks > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        backward_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    backward_kernel<D, T><<<blocks, kThreads, smem, stream>>>(
        src, ids, mask, anchors, pu, q, W, b, w_ua, b_ua, w_da, b_da, P, H, g, dpu, dq,
        partial);
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

}  // namespace

// Each entry takes the operands' type code, dtype: 0 float32, 1 bfloat16, 2
// float16 (every floating operand and output of one call has that type), and
// the width D (32, 64 or 128); the pair (D, dtype) picks the instance.
#define NATR_DISPATCH(CALL)                                           \
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
    default: return (int)cudaErrorInvalidValue;                       \
  }

#define NATR_ARGS                                                                  \
  const void *src, const void *ids, const void *mask, const void *anchors,         \
      const void *pu, const void *q, const void *W, const void *b, const void *w_ua, \
      const void *b_ua, const void *w_da, const void *b_da, int H, int D
#define NATR_PASS(T)                                                               \
  (const T*)src, (const int*)ids, (const uint8_t*)mask, (const int*)anchors,       \
      (const T*)pu, (const T*)q, (const T*)W, (const T*)b, (const T*)w_ua,         \
      (const T*)b_ua, (const T*)w_da, (const T*)b_da, H

// anchors: [P] rows of the history ids / mask [N_anchor, H]; pu, q: [P, D];
// su: [P, D] scratch; out: [P] logits
extern "C" int natr_attention_forward(NATR_ARGS, int P, void* su, void* out, int dtype,
                                      void* stream) {
#define NATR_FWD(d, T) \
  forward<d, T>(NATR_PASS(T), P, (T*)su, (T*)out, (cudaStream_t)stream)
  NATR_DISPATCH(NATR_FWD)
#undef NATR_FWD
}

// anchors: [A] rows of the history ids / mask [N_anchor, H]; pu: [A, D];
// su: [A, D] out
extern "C" int natr_anchor_table(const void* src, const void* ids, const void* mask,
                                 const void* anchors, const void* pu, const void* W,
                                 const void* b, const void* w_ua, const void* b_ua, int H, int D,
                                 int A, void* su, int dtype, void* stream) {
#define NATR_TABLE(d, T)                                                                 \
  anchor_table<d, T>((const T*)src, (const int*)ids, (const uint8_t*)mask,               \
                     (const int*)anchors, (const T*)pu, (const T*)W, (const T*)b,        \
                     (const T*)w_ua, (const T*)b_ua, H, A, (T*)su, (cudaStream_t)stream)
  NATR_DISPATCH(NATR_TABLE)
#undef NATR_TABLE
}

// su, pu: [A, D] the anchors'; q: [Nq, D]; out: [A, Nq] probabilities when
// anchor_is_row, else [Nq, A]
extern "C" int natr_pair_grid(const void* su, const void* pu, const void* q, const void* w_da,
                              const void* b_da, int A, int Nq, int D, int anchor_is_row,
                              void* out, int dtype, void* stream) {
#define NATR_GRID(d, T)                                                                  \
  pair_grid<d, T>((const T*)su, (const T*)pu, (const T*)q, (const T*)w_da,               \
                  (const T*)b_da, A, Nq, anchor_is_row != 0, (T*)out, (cudaStream_t)stream)
  NATR_DISPATCH(NATR_GRID)
#undef NATR_GRID
}

// the backward's block count for P pairs (its partial-sum scratch has one
// row per block), or minus a CUDA error code
extern "C" int natr_attention_backward_blocks(int D, int H, int P, int dtype) {
  const size_t smem = smem_bytes(D, H);
#define NATR_BLOCKS(d, T) persistent_blocks(backward_kernel<d, T>, smem, P)
  switch (dtype * 1000 + D) {
    case 32: return NATR_BLOCKS(32, float);
    case 64: return NATR_BLOCKS(64, float);
    case 128: return NATR_BLOCKS(128, float);
    case 1032: return NATR_BLOCKS(32, __nv_bfloat16);
    case 1064: return NATR_BLOCKS(64, __nv_bfloat16);
    case 1128: return NATR_BLOCKS(128, __nv_bfloat16);
    case 2032: return NATR_BLOCKS(32, __half);
    case 2064: return NATR_BLOCKS(64, __half);
    case 2128: return NATR_BLOCKS(128, __half);
    default: return -(int)cudaErrorInvalidValue;
  }
#undef NATR_BLOCKS
}

// g: [P]; dpu, dq: [P, D]; partial: float32 [max(blocks, 1), D*D + 3D + 2];
// out: the summed weight gradients [dW | db | dw_ua | db_ua | dw_da | db_da]
extern "C" int natr_attention_backward(NATR_ARGS, int P, const void* g, void* dpu, void* dq,
                                       void* partial, int blocks, void* out, int dtype,
                                       void* stream) {
#define NATR_BWD(d, T)                                                                  \
  backward<d, T>(NATR_PASS(T), P, (const T*)g, (T*)dpu, (T*)dq, (float*)partial, blocks, \
                 (T*)out, (cudaStream_t)stream)
  NATR_DISPATCH(NATR_BWD)
#undef NATR_BWD
}
