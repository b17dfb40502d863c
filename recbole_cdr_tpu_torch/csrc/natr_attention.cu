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
// backward near 3 us; a [32, ~5,000] full-sort tile near 2 us by its pairs'
// O(D) blends. This kernel is far above those bounds: it runs the transfer
// once per slot of every anchor it takes (H D^2 multiply-adds per anchor,
// ~30 flops per gathered byte, so each anchor stage is compute-heavy) and,
// in training, takes one anchor per pair. Design: su and pu depend only on
// the anchor, so the anchor stage runs once per anchor it takes (a training
// step takes one per pair; a full-sort grid one per user, or per item, of
// the tile) and the pair stage once per pair, where JAX's fallback repeats
// the whole attention for every pair. Anchor stage: persistent blocks of 256
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
// tensor cores for the transfer (3xTF32 keeps float32 accuracy), a
// shared-memory tile of the full-sort grid's queries.

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>
#include <stdint.h>

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
  float* att;  // [hp] softmax
  float* s;    // [hp] scores, then their gradient
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

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float relu_mul(float a, float b) {
  return fmaxf(__fmul_rn(a, b), 0.f);
}

template <int D>
__device__ void stage_weight(const float* __restrict__ W, Smem& m) {
  for (int i = threadIdx.x; i < D * D; i += kThreads) m.W[i] = __ldg(W + i);
}

// The anchor stage of one anchor, by the whole block: leaves m.T (the
// transferred rows), m.att (the softmax), m.su and m.pu. Ends synchronised.
template <int D>
__device__ void anchor_stage(const float* __restrict__ src, const int* __restrict__ ids,
                             const uint8_t* __restrict__ mask, int aid, int H, int hp,
                             const float* __restrict__ pu_row, const float* __restrict__ b,
                             const float* __restrict__ w_ua, float b_ua, Smem& m) {
  using S = Shape<D>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < hp; j += kThreads) {
    const bool real = j < H;
    m.hid[j] = real ? __ldg(ids + (long long)aid * H + j) : 0;
    m.msk[j] = real ? __ldg(mask + (long long)aid * H + j) : 0;
  }
  for (int d = tid; d < D; d += kThreads) m.pu[d] = __ldg(pu_row + d);
  __syncthreads();
  for (int i = tid; i < hp * D; i += kThreads) {
    const int j = i / D, k = i - j * D;
    m.E[j * S::EST + k] = j < H ? __ldg(src + (long long)m.hid[j] * D + k) : 0.f;
  }
  __syncthreads();

  // T = E @ W + b: rows ty + RT r (r < 4) of each pass, columns 4 tx .. 4 tx + 3
  const int tx = tid % S::C4, ty = tid / S::C4;
  float bias[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) bias[c] = __ldg(b + 4 * tx + c);
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
          __fadd_rn(acc[r][0], bias[0]), __fadd_rn(acc[r][1], bias[1]),
          __fadd_rn(acc[r][2], bias[2]), __fadd_rn(acc[r][3], bias[3]));
    }
  }
  __syncthreads();

  for (int j = warp; j < H; j += kWarps) {
    float acc = 0.f;
    for (int d = lane; d < D; d += 32)
      acc = fmaf(relu_mul(m.pu[d], m.T[j * D + d]), __ldg(w_ua + d), acc);
    acc = warp_sum(acc);
    if (lane == 0) m.s[j] = __fadd_rn(__fadd_rn(acc, b_ua), m.msk[j] ? 0.f : -10000.f);
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
    for (int j = lane; j < H; j += 32) m.att[j] = __fdiv_rn(m.att[j], sum);
  }
  __syncthreads();

  for (int d = tid; d < D; d += kThreads) {
    float acc = 0.f;
    for (int j = 0; j < H; ++j) acc = fmaf(m.att[j], m.T[j * D + d], acc);
    m.su[d] = acc;
  }
  __syncthreads();
}

template <int D>
__global__ void __launch_bounds__(kThreads)
anchor_kernel(const float* __restrict__ src, const int* __restrict__ ids,
              const uint8_t* __restrict__ mask, const int* __restrict__ anchors,
              const float* __restrict__ pu, const float* __restrict__ W,
              const float* __restrict__ b, const float* __restrict__ w_ua,
              const float* __restrict__ b_ua, int A, int H, float* __restrict__ su) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hp = hpad(H, Shape<D>::RPASS);
  Smem m = carve<D>(smem, hp);
  stage_weight<D>(W, m);
  __syncthreads();
  const float bua = __ldg(b_ua);
  for (int a = blockIdx.x; a < A; a += gridDim.x) {
    anchor_stage<D>(src, ids, mask, __ldg(anchors + a), H, hp, pu + (long long)a * D, b,
                    w_ua, bua, m);
    for (int d = threadIdx.x; d < D; d += kThreads) su[(long long)a * D + d] = m.su[d];
    __syncthreads();
  }
}

// the pair stage of one pair: its logit
template <int D>
__device__ __forceinline__ float blend(const float* __restrict__ su, const float* __restrict__ pu,
                                       const float* __restrict__ q, const float* __restrict__ w,
                                       float b_da) {
  float bs = 0.f, bp = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 s = ldg4(su + d), p = ldg4(pu + d), x = ldg4(q + d), ww = ldg4(w + d);
    bs = fmaf(relu_mul(s.x, x.x), ww.x, bs);
    bs = fmaf(relu_mul(s.y, x.y), ww.y, bs);
    bs = fmaf(relu_mul(s.z, x.z), ww.z, bs);
    bs = fmaf(relu_mul(s.w, x.w), ww.w, bs);
    bp = fmaf(relu_mul(p.x, x.x), ww.x, bp);
    bp = fmaf(relu_mul(p.y, x.y), ww.y, bp);
    bp = fmaf(relu_mul(p.z, x.z), ww.z, bp);
    bp = fmaf(relu_mul(p.w, x.w), ww.w, bp);
  }
  bs = __fadd_rn(bs, b_da);
  bp = __fadd_rn(bp, b_da);
  const float es = expf(bs), ep = expf(bp);
  const float beta = __fdiv_rn(es, __fadd_rn(es, ep));
  const float omb = __fsub_rn(1.f, beta);
  float acc = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 s = ldg4(su + d), p = ldg4(pu + d), x = ldg4(q + d);
    acc = fmaf(__fadd_rn(__fmul_rn(beta, s.x), __fmul_rn(omb, p.x)), x.x, acc);
    acc = fmaf(__fadd_rn(__fmul_rn(beta, s.y), __fmul_rn(omb, p.y)), x.y, acc);
    acc = fmaf(__fadd_rn(__fmul_rn(beta, s.z), __fmul_rn(omb, p.z)), x.z, acc);
    acc = fmaf(__fadd_rn(__fmul_rn(beta, s.w), __fmul_rn(omb, p.w)), x.w, acc);
  }
  return acc;
}

// mode 0: `rows` aligned pairs (anchor i, query i) -> logits; mode 1: the
// [rows, cols] grid with anchor r and query c -> probabilities; mode 2: the
// grid with anchor c and query r -> probabilities
template <int D>
__global__ void __launch_bounds__(kThreads)
pair_kernel(const float* __restrict__ su, const float* __restrict__ pu,
            const float* __restrict__ q, const float* __restrict__ w_da,
            const float* __restrict__ b_da, int rows, int cols, int mode,
            float* __restrict__ out) {
  const long long n = mode == 0 ? (long long)rows : (long long)rows * cols;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  long long a = i, c = i;
  if (mode != 0) {
    const long long r = i / cols, k = i - r * cols;
    a = mode == 1 ? r : k;
    c = mode == 1 ? k : r;
  }
  float x = blend<D>(su + a * D, pu + a * D, q + c * D, w_da, __ldg(b_da));
  if (mode != 0) x = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
  out[i] = x;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
backward_kernel(const float* __restrict__ src, const int* __restrict__ ids,
                const uint8_t* __restrict__ mask, const int* __restrict__ anchors,
                const float* __restrict__ pu, const float* __restrict__ q,
                const float* __restrict__ W, const float* __restrict__ b,
                const float* __restrict__ w_ua, const float* __restrict__ b_ua,
                const float* __restrict__ w_da, const float* __restrict__ b_da,
                int P, int H, const float* __restrict__ g, float* __restrict__ dpu,
                float* __restrict__ dq, float* __restrict__ partial) {
  using S = Shape<D>;
  constexpr int V = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hp = hpad(H, S::RPASS);
  Smem m = carve<D>(smem, hp);
  stage_weight<D>(W, m);
  __syncthreads();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % S::C4, ty = tid / S::C4;  // dW tile
  const int pd = tid % D, jg = tid / D;          // (j, d) pass
  const float bua = __ldg(b_ua), bda = __ldg(b_da);

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
    anchor_stage<D>(src, ids, mask, __ldg(anchors + p), H, hp, pu + (long long)p * D, b, w_ua,
                    bua, m);

    // the pair stage's chain rule, one warp: d(su), the direct d(pu), d(q)
    if (warp == 0) {
      const float gp = __ldg(g + p);
      float sv[V], pv[V], qv[V], wv[V];
      float bs = 0.f, bp = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int d = lane + 32 * v;
        sv[v] = m.su[d];
        pv[v] = m.pu[d];
        qv[v] = __ldg(q + (long long)p * D + d);
        wv[v] = __ldg(w_da + d);
        bs = fmaf(relu_mul(sv[v], qv[v]), wv[v], bs);
        bp = fmaf(relu_mul(pv[v], qv[v]), wv[v], bp);
      }
      bs = __fadd_rn(warp_sum(bs), bda);
      bp = __fadd_rn(warp_sum(bp), bda);
      const float es = expf(bs), ep = expf(bp);
      const float beta = __fdiv_rn(es, __fadd_rn(es, ep));
      const float omb = __fsub_rn(1.f, beta);
      float dbeta = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v)
        dbeta = fmaf(__fmul_rn(gp, qv[v]), __fsub_rn(sv[v], pv[v]), dbeta);
      dbeta = warp_sum(dbeta);
      const float dbs = __fmul_rn(__fmul_rn(dbeta, beta), omb);  // d b_s; d b_p = -d b_s
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
        const float z = __fadd_rn(__fmul_rn(beta, sv[v]), __fmul_rn(omb, pv[v]));
        dq[(long long)p * D + d] = fmaf(gq, pv[v], fmaf(gs, sv[v], __fmul_rn(gp, z)));
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
    // the softmax's backward: d(s_j) = att_j (d(att_j) - sum_k att_k d(att_k))
    if (warp == 0) {
      float c = 0.f;
      for (int j = lane; j < H; j += 32) c = fmaf(m.att[j], m.da[j], c);
      c = warp_sum(c);
      for (int j = lane; j < H; j += 32) m.s[j] = __fmul_rn(m.att[j], __fsub_rn(m.da[j], c));
    }
    __syncthreads();

    // (j, d) pass: d(pu) and d(w_ua) through the scores, then dT in place
    {
      const float pud = m.pu[pd], wud = __ldg(w_ua + pd), dsud = m.dsu[pd];
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
      dpu[(long long)p * D + tid] = s;
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

// out[i] = sum over blocks k, in order, of partial[k, i]
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ partial, int blocks, int n, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < blocks; ++k) s = __fadd_rn(s, partial[(long long)k * n + i]);
  out[i] = s;
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

template <int D>
int forward(const float* src, const int* ids, const uint8_t* mask, const int* anchors,
            const float* pu, const float* q, const float* W, const float* b,
            const float* w_ua, const float* b_ua, const float* w_da, const float* b_da,
            int H, int A, int rows, int cols, int mode, float* su, float* out,
            cudaStream_t stream) {
  const size_t smem = smem_bytes(D, H);
  const int blocks = persistent_blocks(anchor_kernel<D>, smem, A);
  if (blocks < 0) return -blocks;
  if (blocks > 0)
    anchor_kernel<D><<<blocks, kThreads, smem, stream>>>(src, ids, mask, anchors, pu, W, b,
                                                           w_ua, b_ua, A, H, su);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = mode == 0 ? (long long)rows : (long long)rows * cols;
  if (n > 0)
    pair_kernel<D><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        su, pu, q, w_da, b_da, rows, cols, mode, out);
  return (int)cudaGetLastError();
}

template <int D>
int backward(const float* src, const int* ids, const uint8_t* mask, const int* anchors,
             const float* pu, const float* q, const float* W, const float* b,
             const float* w_ua, const float* b_ua, const float* w_da, const float* b_da,
             int H, int P, const float* g, float* dpu, float* dq, float* partial, int blocks,
             float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, H);
  const int n = Shape<D>::NPART;
  if (blocks > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        backward_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    backward_kernel<D><<<blocks, kThreads, smem, stream>>>(
        src, ids, mask, anchors, pu, q, W, b, w_ua, b_ua, w_da, b_da, P, H, g, dpu, dq,
        partial);
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

}  // namespace

#define NATR_ARGS                                                                  \
  const void *src, const void *ids, const void *mask, const void *anchors,         \
      const void *pu, const void *q, const void *W, const void *b, const void *w_ua, \
      const void *b_ua, const void *w_da, const void *b_da, int H, int D
#define NATR_PASS                                                                  \
  (const float*)src, (const int*)ids, (const uint8_t*)mask, (const int*)anchors,   \
      (const float*)pu, (const float*)q, (const float*)W, (const float*)b,         \
      (const float*)w_ua, (const float*)b_ua, (const float*)w_da, (const float*)b_da, H

// anchors: [A] rows of the history ids / mask [N_anchor, H]; pu: [A, D];
// su: [A, D] scratch; out: [rows] logits (mode 0) or [rows, cols]
// probabilities (modes 1, 2)
extern "C" int natr_attention_forward(NATR_ARGS, int A, int rows, int cols, int mode,
                                      void* su, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* s = (float*)su;
  float* o = (float*)out;
  switch (D) {
    case 32: return forward<32>(NATR_PASS, A, rows, cols, mode, s, o, st);
    case 64: return forward<64>(NATR_PASS, A, rows, cols, mode, s, o, st);
    case 128: return forward<128>(NATR_PASS, A, rows, cols, mode, s, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the backward's block count for P pairs (its partial-sum scratch has one
// row per block), or minus a CUDA error code
extern "C" int natr_attention_backward_blocks(int D, int H, int P) {
  const size_t smem = smem_bytes(D, H);
  switch (D) {
    case 32: return persistent_blocks(backward_kernel<32>, smem, P);
    case 64: return persistent_blocks(backward_kernel<64>, smem, P);
    case 128: return persistent_blocks(backward_kernel<128>, smem, P);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// g: [P]; dpu, dq: [P, D]; partial: [max(blocks, 1), D*D + 3D + 2]; out: the
// summed weight gradients [dW | db | dw_ua | db_ua | dw_da | db_da]
extern "C" int natr_attention_backward(NATR_ARGS, int P, const void* g, void* dpu, void* dq,
                                       void* partial, int blocks, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* gg = (const float*)g;
  float *a = (float*)dpu, *c = (float*)dq, *pa = (float*)partial, *o = (float*)out;
  switch (D) {
    case 32: return backward<32>(NATR_PASS, P, gg, a, c, pa, blocks, o, st);
    case 64: return backward<64>(NATR_PASS, P, gg, a, c, pa, blocks, o, st);
    case 128: return backward<128>(NATR_PASS, P, gg, a, c, pa, blocks, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
