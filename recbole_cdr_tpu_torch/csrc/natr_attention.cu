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
// pu_d q_d serve both the gates and the dots).
//
// Training (natr_attention_forward / _backward). The op takes the anchor
// side's table [N, D] and each pair's anchor id, as JAX's _phase2_logit
// gathers pu inside, and reads the plan of the step's anchors over the
// table's rows (ops/row_groups.py::group_rows, csrc/row_groups.cuh): one
// head per distinct anchor with its pairs' positions in ascending order.
//   forward: (1) the transfer of the whole source table, T = src @ W + b,
//     each row once (4 x 4 register tiles, W in shared memory). Per step
//     the distinct rows the histories name are ~4,000 of NATR's ~8k-13k
//     source rows, but finding them takes a plan of the ~105,000 history
//     slots, which costs more than the whole table's transfer at these
//     sizes (probe_row_groups.py); (2) persistent blocks take one head at a
//     time: its H transferred rows into shared memory, the scores one warp a
//     slot, the softmax in one warp, su one thread a column, then the pair
//     stage one thread a pair of the head. The forward keeps T, and per head
//     su and the softmax (rounded and unrounded), for the backward.
//   backward: the rows the step's anchors name counted per span of 1,024
//     rows (the span's other gradient rows written 0); persistent blocks take
//     equal shares of those rows in ascending row order (block b the ranks
//     [b T / G, (b + 1) T / G)), so the work is even and every sum runs in an
//     order the ids alone fix (a block per chunk of rows, the first cut, left
//     the busiest block twice the mean). A head's row: the pair stage's
//     chain rule one warp a pair, kWarps pairs at a time, their d(su), d(pu)
//     and d(w_da) terms added in position order; then the anchor stage's
//     chain rule once, from the summed d(su): d(att), the softmax's slope,
//     d(pu) through the scores, dT in place and dW += E^T dT; the row's
//     gradient, the pairs' d(pu) plus the anchor stage's, written once. Each
//     block keeps its weight gradients' partial sums in registers and writes
//     them once; a second launch adds the blocks' partials in block order.
//     No float atomic: the results repeat bit for bit.
// Elementwise steps use round-to-nearest intrinsics where the plain version
// rounds a product and a sum separately. Not done: the transfer on the
// tensor cores (at ~67 MFLOP a step it takes a few microseconds on the CUDA
// cores); more than one head at a time per block (a head's chain of
// dependent loads and barriers, not its arithmetic, sets the time).
//
// Full-sort scoring splits in two launches: the anchor table (the anchor
// stage of every anchor row of the domain, once per parameter version: the
// caller caches it, so an evaluation pass builds it once and no user tile
// relaunches it; persistent blocks of 256 threads keep W in shared memory
// and take one anchor at a time, gathering its H rows and transferring them
// with a 4 x 4 register tile per thread) and the pair grid, one launch per
// tile, whose blocks stage 8 anchor or query rows and 32 of the other side's
// in shared memory with 16-byte loads and give each thread a 2 x 1 tile of
// pairs; one pass over D keeps four sums per pair (both gates' sums and both
// dots), so an item row is read from device memory once per block rather
// than once per pair thread.

// B9-bf16, the 16-bit form (NATR under compute_dtype: bfloat16; float16
// through the same template): every operand and output is 16-bit (the
// source table, the history rows, pu, q, the weights, the upstream gradient;
// the logits, su, the grid's probabilities, every gradient). Values are
// widened exactly as they are staged (shared memory stays float32); each dot
// and each sum over H or D accumulates in float32 and is rounded to the
// 16-bit type where JAX's bf16 _phase2_logit has a named intermediate:
// h = hist_e @ W + b (rounded once per source row by the training
// transfer, as once per slot before: sharing a row changes no value), the
// attention logits with the -10000 mask (-9984 in
// bf16), the softmax, su, b_s and b_p, beta, zu (per element) and the logit;
// the grid's sigmoid too. With zu rounded per element the grid cannot
// regroup its dots as the float32 form does, so its 16-bit instances walk D
// twice (the gates, then the blend). The backward is the float32 chain rule
// on those rounded values (the rounding passes gradients through
// unchanged), beta's and the softmax's slopes at their unrounded values, and
// every gradient rounded once to the operands' type: the weight gradients
// after the block-order sum, a table row's after its pairs' and its anchor
// stage's float32 terms are added. The float32 form is the same template with every
// rounding the identity.

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>
#include <stdint.h>

#include "float16.cuh"
#include "row_groups.cuh"

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

// the anchor table's kernel's shared memory (Smem)
inline size_t smem_bytes(int D, int H) {
  const int hp = hpad(H, 4 * kThreads / (D / 4));
  const size_t floats = (size_t)D * D + (size_t)hp * (D + 1) + (size_t)hp * D +
                        2 * (size_t)hp + 2 * (size_t)D;
  return 4 * floats + 4 * (size_t)hp + (size_t)hp;
}

struct Smem {
  float* W;    // [D, D] transfer weight
  float* E;    // [hp, D + 1] gathered history rows
  float* T;    // [hp, D] transferred rows
  float* att;  // [hp] softmax, rounded to the operands' type
  float* s;    // [hp] scores, then the unrounded softmax
  float* pu;   // [D]
  float* su;   // [D]
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
  m.pu = f;  f += D;
  m.su = f;  f += D;
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

// the pair stage of one pair: its logit, rounded to T, from the anchor's su
// and pu (float32 values of T in shared memory, 16-byte aligned) and the
// pair's query q
template <int D, typename T>
__device__ __forceinline__ float blend(const float* su, const float* pu,
                                       const T* __restrict__ q, const T* __restrict__ w,
                                       float b_da) {
  float bs = 0.f, bp = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 s = *reinterpret_cast<const float4*>(su + d);
    const float4 p = *reinterpret_cast<const float4*>(pu + d);
    const float4 x = ld4(q + d), ww = ld4(w + d);
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
    const float4 s = *reinterpret_cast<const float4*>(su + d);
    const float4 p = *reinterpret_cast<const float4*>(pu + d);
    const float4 x = ld4(q + d);
    acc = fmaf(rnd<T>(__fadd_rn(__fmul_rn(beta, s.x), __fmul_rn(omb, p.x))), x.x, acc);
    acc = fmaf(rnd<T>(__fadd_rn(__fmul_rn(beta, s.y), __fmul_rn(omb, p.y))), x.y, acc);
    acc = fmaf(rnd<T>(__fadd_rn(__fmul_rn(beta, s.z), __fmul_rn(omb, p.z))), x.z, acc);
    acc = fmaf(rnd<T>(__fadd_rn(__fmul_rn(beta, s.w), __fmul_rn(omb, p.w))), x.w, acc);
  }
  return rnd<T>(acc);
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

// ---- training: the whole-table transfer and one anchor stage per head ------

// T [Ns, D] float32 = src @ W + b, each value rounded to T: RPASS rows a
// block, the sums as the anchor stage's transfer makes them
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
transfer_kernel(const T* __restrict__ src, int Ns, const T* __restrict__ W,
                const T* __restrict__ b, float* __restrict__ out) {
  using S = Shape<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ws = reinterpret_cast<float*>(smem);  // [D, D]
  float* E = Ws + D * D;                       // [RPASS, EST]
  const int tid = threadIdx.x, r0 = blockIdx.x * S::RPASS;
  for (int i = tid; i < D * D; i += kThreads) Ws[i] = ld1(W + i);
  for (int i = tid; i < S::RPASS * D; i += kThreads) {
    const int j = i / D, k = i - j * D;
    E[j * S::EST + k] = r0 + j < Ns ? ld1(src + (long long)(r0 + j) * D + k) : 0.f;
  }
  __syncthreads();
  const int tx = tid % S::C4, ty = tid / S::C4;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  const float* e0 = E + ty * S::EST;
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    const float4 w = *reinterpret_cast<const float4*>(Ws + k * D + 4 * tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = e0[r * S::RT * S::EST + k];
      acc[r][0] = fmaf(e, w.x, acc[r][0]);
      acc[r][1] = fmaf(e, w.y, acc[r][1]);
      acc[r][2] = fmaf(e, w.z, acc[r][2]);
      acc[r][3] = fmaf(e, w.w, acc[r][3]);
    }
  }
  float bias[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) bias[c] = ld1(b + 4 * tx + c);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = r0 + ty + S::RT * r;
    if (j < Ns)
      *reinterpret_cast<float4*>(out + (long long)j * D + 4 * tx) = make_float4(
          rnd<T>(__fadd_rn(acc[r][0], bias[0])), rnd<T>(__fadd_rn(acc[r][1], bias[1])),
          rnd<T>(__fadd_rn(acc[r][2], bias[2])), rnd<T>(__fadd_rn(acc[r][3], bias[3])));
  }
}

inline size_t transfer_smem_bytes(int D) {
  const int rpass = 4 * (kThreads / (D / 4));
  return 4 * ((size_t)D * D + (size_t)rpass * (D + 1));
}

// What the forward keeps per head for the backward (float32 values of T):
// su [heads, D], the softmax rounded to T and unrounded [heads, H].
struct Keep {
  float* su;
  float* att;
  float* attq;
};

// the training kernels' shared memory, float32 words then ints (the
// backward's include a span's rows and a scan's scratch)
inline size_t head_smem_bytes(int D, int H, bool backward) {
  size_t f = 2 * (size_t)D + (size_t)H * D + 2 * (size_t)H, n = H;
  if (backward) {
    f += 2 * (size_t)D + (size_t)H * D + (size_t)H + kThreads + 3 * (size_t)kWarps * D + kWarps;
    n += 4 * kThreads + kWarps + 2;
  }
  return 4 * (f + n);
}

// one anchor's H transferred rows into Ts [H, D] (its ids into hid)
template <int D>
__device__ __forceinline__ void stage_rows(const float* __restrict__ Tall,
                                           const int* __restrict__ ids, int a, int H, int* hid,
                                           float* Ts) {
  for (int j = threadIdx.x; j < H; j += kThreads) hid[j] = __ldg(ids + (long long)a * H + j);
  __syncthreads();
  for (int i = threadIdx.x; i < H * (D / 4); i += kThreads) {
    const int j = i / (D / 4), c = 4 * (i % (D / 4));
    *reinterpret_cast<float4*>(Ts + j * D + c) =
        __ldg(reinterpret_cast<const float4*>(Tall + (long long)hid[j] * D + c));
  }
}

// Persistent blocks, one head at a time: the anchor stage from the
// transferred rows, kept for the backward, then the pair stage of each of the
// head's pairs (one thread a pair): logits [P].
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
forward_kernel(const float* __restrict__ Tall, const int* __restrict__ ids,
               const uint8_t* __restrict__ mask, int H, const T* __restrict__ table,
               const T* __restrict__ q, const T* __restrict__ w_ua,
               const T* __restrict__ b_ua, const T* __restrict__ w_da,
               const T* __restrict__ b_da, GroupsView g, Keep keep, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* pu = reinterpret_cast<float*>(smem);  // [D]
  float* su = pu + D;                          // [D]
  float* Ts = su + D;                          // [H, D]
  float* s = Ts + H * D;                       // [H] scores, then the unrounded softmax
  float* att = s + H;                          // [H]
  int* hid = reinterpret_cast<int*>(att + H);  // [H]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float bua = ld1(b_ua), bda = ld1(b_da);
  const int heads = __ldg(g.meta + 1);
  for (int h = blockIdx.x; h < heads; h += gridDim.x) {
    const int a = __ldg(g.head_row + h);
    for (int d = tid; d < D; d += kThreads) pu[d] = ld1(table + (long long)a * D + d);
    stage_rows<D>(Tall, ids, a, H, hid, Ts);
    __syncthreads();
    for (int j = warp; j < H; j += kWarps) {
      float acc = 0.f;
      for (int d = lane; d < D; d += 32) acc = fmaf(relu_mul(pu[d], Ts[j * D + d]), ld1(w_ua + d), acc);
      acc = warp_sum(acc);
      if (lane == 0)
        s[j] = rnd<T>(__fadd_rn(__fadd_rn(acc, bua),
                                __ldg(mask + (long long)a * H + j) ? 0.f : -10000.f));
    }
    __syncthreads();
    if (warp == 0) {
      float mx = -INFINITY;
      for (int j = lane; j < H; j += 32) mx = fmaxf(mx, s[j]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < H; j += 32) {
        const float e = expf(__fsub_rn(s[j], mx));
        att[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < H; j += 32) {
        const float x = __fdiv_rn(att[j], sum);
        att[j] = rnd<T>(x);
        keep.attq[(long long)h * H + j] = x;
        keep.att[(long long)h * H + j] = att[j];
      }
    }
    __syncthreads();
    for (int d = tid; d < D; d += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < H; ++j) acc = fmaf(att[j], Ts[j * D + d], acc);
      su[d] = rnd<T>(acc);
      keep.su[(long long)h * D + d] = su[d];
    }
    __syncthreads();
    const int st = __ldg(g.head_start + h), n = __ldg(g.head_len + h);
    for (int k = tid; k < n; k += kThreads) {
      const int p = __ldg(g.pos + st + k);
      st1(out + p, blend<D, T>(su, pu, q + (long long)p * D, w_da, bda));
    }
    __syncthreads();  // the next head rewrites the shared arrays
  }
}

// rows of the table a span covers, four a thread: the backward counts the
// rows a pair's anchor names per span, then each block finds its rows
constexpr int kSpan = 4 * kThreads;

// block-wide exclusive scan of v over kThreads threads, its total in *total
__device__ __forceinline__ int block_excl_scan(int v, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_tot[w];
    if (w < warp) before += t;
    all += t;
  }
  __syncthreads();  // warp_tot is rewritten by the next scan
  *total = all;
  return before + x - v;
}

// counts[s] = the rows of span s that a pair's anchor names (a head's
// row); the span's other rows of d(table) [N, D] are written 0 (the heads'
// rows are written once by the backward)
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) span_count_kernel(GroupsView g, int N,
                                                             int* __restrict__ counts,
                                                             T* __restrict__ dtable) {
  __shared__ int warp_tot[kWarps];
  __shared__ unsigned char named[kSpan];
  const long long s0 = (long long)blockIdx.x * kSpan, r0 = s0 + 4 * threadIdx.x;
  int n = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool h = r0 + k < N && head_of(g, (int)(r0 + k)) >= 0;
    named[4 * threadIdx.x + k] = h;
    n += h;
  }
  int total;
  block_excl_scan(n, warp_tot, &total);  // its barriers publish named
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
  const long long rows = N - s0 < kSpan ? N - s0 : kSpan;
  for (long long i = threadIdx.x; i < rows * D; i += kThreads)
    if (!named[i / D]) st1(dtable + s0 * D + i, 0.f);
}

// The backward over the heads in their rows' order: block b takes the heads
// of ranks [b T / G, (b + 1) T / G) among the T rows a pair's anchor names,
// in ascending row order (found from the spans' counts), so the blocks' work
// is even and every sum runs in an order the ids alone fix. Per head: d(table)
// of its row (span_count_kernel zeroed the others), dq of its pairs, and this
// block's partial weight gradients [dW | db | dw_ua | db_ua | dw_da | db_da].
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 3 : 1)
backward_kernel(const T* __restrict__ src, const float* __restrict__ Tall,
                const int* __restrict__ ids, int H, const T* __restrict__ table, int N,
                const T* __restrict__ q, const T* __restrict__ w_ua,
                const T* __restrict__ w_da, const T* __restrict__ b_da, GroupsView g,
                const int* __restrict__ counts, Keep keep, const T* __restrict__ gz,
                T* __restrict__ dtable, T* __restrict__ dq, float* __restrict__ partial) {
  using S = Shape<D>;
  constexpr int V = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* pu = reinterpret_cast<float*>(smem);  // [D]
  float* su = pu + D;                          // [D]
  float* Ts = su + D;                          // [H, D], then dT
  float* s = Ts + H * D;                       // [H] unrounded softmax, then d(scores)
  float* att = s + H;                          // [H] rounded softmax
  float* dsu = att + H;                        // [D] the head's d(su)
  float* dpu = dsu + D;                        // [D] its pairs' d(pu)
  float* E = dpu + D;                          // [H, D] the source rows
  float* da = E + H * D;                       // [H]
  float* red = da + H;                         // [kThreads]
  float* slot_su = red + kThreads;             // [kWarps, D] a pair's d(su)
  float* slot_pu = slot_su + kWarps * D;       // [kWarps, D] its d(pu)
  float* slot_wda = slot_pu + kWarps * D;      // [kWarps, D] its d(w_da)
  float* slot_bda = slot_wda + kWarps * D;     // [kWarps]
  int* hid = reinterpret_cast<int*>(slot_bda + kWarps);  // [H]
  int* mine = hid + H;                                   // [kSpan] this span's rows
  int* scan = mine + kSpan;                              // [kWarps + 2]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % S::C4, ty = tid / S::C4;  // dW tile
  const int pd = tid % D, jg = tid / D;          // (j, d) pass
  const float bda = ld1(b_da);

  float acc_w[S::RK][4];
#pragma unroll
  for (int r = 0; r < S::RK; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_w[r][c] = 0.f;
  float acc_b = 0.f, acc_wua = 0.f, acc_bua = 0.f, acc_bda = 0.f, acc_wda = 0.f;

  const int heads = __ldg(g.meta + 1), n_spans = (N + kSpan - 1) / kSpan;
  const int lo = (int)((long long)heads * blockIdx.x / gridDim.x);
  const int hi = (int)((long long)heads * (blockIdx.x + 1) / gridDim.x);
  // the span holding rank lo, and the ranks before it
  int span = n_spans, base = 0;
  for (int s0 = 0, before = 0; lo < hi && s0 < n_spans; s0 += kThreads) {
    const int c = s0 + tid < n_spans ? __ldg(counts + s0 + tid) : 0;
    int total;
    const int x = block_excl_scan(c, scan, &total);
    if (s0 + tid < n_spans && before + x <= lo && lo < before + x + c) {
      scan[kWarps] = s0 + tid;
      scan[kWarps + 1] = before + x;
    }
    __syncthreads();
    if (before + total > lo) {
      span = scan[kWarps];
      base = scan[kWarps + 1];
      break;
    }
    before += total;
  }
  for (; span < n_spans && base < hi; ++span) {
    // this span's rows a pair names, with their ranks; this block's in order
    const long long r4 = (long long)span * kSpan + 4 * tid;
    int h4[4], n = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h4[k] = r4 + k < N ? head_of(g, (int)(r4 + k)) : -1;
      n += h4[k] >= 0;
    }
    int total;
    int rank = base + block_excl_scan(n, scan, &total);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (h4[k] < 0) continue;
      if (rank >= lo && rank < hi) mine[rank - (base > lo ? base : lo)] = (int)(r4 + k);
      ++rank;
    }
    __syncthreads();
    const int first = base > lo ? base : lo;
    const int last = base + total < hi ? base + total : hi;
    base += total;
    for (int c = 0; c < last - first; ++c) {
      const long long r = mine[c];
      const int h = head_of(g, (int)r);
      for (int d = tid; d < D; d += kThreads) {
        pu[d] = ld1(table + r * D + d);
        su[d] = keep.su[(long long)h * D + d];
      }
      for (int j = tid; j < H; j += kThreads) {
        s[j] = keep.attq[(long long)h * H + j];
        att[j] = keep.att[(long long)h * H + j];
      }
      stage_rows<D>(Tall, ids, (int)r, H, hid, Ts);
      for (int i = tid; i < H * D; i += kThreads) {
        const int j = i / D, k = i - j * D;
        E[i] = ld1(src + (long long)hid[j] * D + k);
      }
      __syncthreads();

      // the pair stage's chain rule, a warp a pair, kWarps pairs at a time;
      // their terms added in position order
      const int st = __ldg(g.head_start + h), n = __ldg(g.head_len + h);
      for (int k0 = 0; k0 < n; k0 += kWarps) {
        const int m = n - k0 < kWarps ? n - k0 : kWarps;
        if (warp < m) {
          const int p = __ldg(g.pos + st + k0 + warp);
          const float gp = ld1(gz + p);
          float sv[V], pv[V], qv[V], wv[V];
          float bs = 0.f, bp = 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int d = lane + 32 * v;
            sv[v] = su[d];
            pv[v] = pu[d];
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
            slot_su[warp * D + d] = fmaf(gs, qv[v], __fmul_rn(beta, dz));
            slot_pu[warp * D + d] = fmaf(gq, qv[v], __fmul_rn(omb, dz));
            const float z = rnd<T>(__fadd_rn(__fmul_rn(beta, sv[v]), __fmul_rn(omb, pv[v])));
            st1(dq + (long long)p * D + d,
                rnd<T>(fmaf(gq, pv[v], fmaf(gs, sv[v], __fmul_rn(gp, z)))));
            slot_wda[warp * D + d] = fmaf(dbs, fmaxf(us, 0.f), __fmul_rn(dbp, fmaxf(up, 0.f)));
          }
          if (lane == 0) slot_bda[warp] = __fadd_rn(dbs, dbp);
        }
        __syncthreads();
        if (tid < D) {
          float xs = k0 ? dsu[tid] : 0.f, xp = k0 ? dpu[tid] : 0.f;
          for (int w = 0; w < m; ++w) {
            xs = __fadd_rn(xs, slot_su[w * D + tid]);
            xp = __fadd_rn(xp, slot_pu[w * D + tid]);
            acc_wda = __fadd_rn(acc_wda, slot_wda[w * D + tid]);
          }
          dsu[tid] = xs;
          dpu[tid] = xp;
        }
        if (tid == 0)
          for (int w = 0; w < m; ++w) acc_bda = __fadd_rn(acc_bda, slot_bda[w]);
        __syncthreads();
      }

      // the anchor stage's chain rule, once: d(att_j) = d(su) . h_j, a warp a slot
      for (int j = warp; j < H; j += kWarps) {
        float acc = 0.f;
        for (int d = lane; d < D; d += 32) acc = fmaf(dsu[d], Ts[j * D + d], acc);
        acc = warp_sum(acc);
        if (lane == 0) da[j] = acc;
      }
      __syncthreads();
      // the softmax's backward at its unrounded weights (in s):
      // d(s_j) = att_j (d(att_j) - sum_k att_k d(att_k))
      if (warp == 0) {
        float cc = 0.f;
        for (int j = lane; j < H; j += 32) cc = fmaf(s[j], da[j], cc);
        cc = warp_sum(cc);
        for (int j = lane; j < H; j += 32) s[j] = __fmul_rn(s[j], __fsub_rn(da[j], cc));
      }
      __syncthreads();
      // (j, d) pass: d(pu) and d(w_ua) through the scores, then dT in place
      {
        const float pud = pu[pd], wud = ld1(w_ua + pd), dsud = dsu[pd];
        float dpu_part = 0.f;
        for (int j = jg; j < H; j += S::JG) {
          const float t = Ts[j * D + pd];
          const float y = __fmul_rn(pud, t);
          const float ds = s[j];
          const float dy = y > 0.f ? __fmul_rn(ds, wud) : 0.f;
          dpu_part = fmaf(dy, t, dpu_part);
          acc_wua = fmaf(ds, fmaxf(y, 0.f), acc_wua);
          const float dt = fmaf(att[j], dsud, __fmul_rn(dy, pud));
          Ts[j * D + pd] = dt;
          acc_b = __fadd_rn(acc_b, dt);
        }
        red[tid] = dpu_part;
      }
      if (tid == 0)
        for (int j = 0; j < H; ++j) acc_bua = __fadd_rn(acc_bua, s[j]);
      __syncthreads();
      // the row's gradient: its pairs' d(pu) in position order, then the
      // anchor stage's
      if (tid < D) {
        float x = dpu[tid];
        for (int k = 0; k < S::JG; ++k) x = __fadd_rn(x, red[k * D + tid]);
        st1(dtable + r * D + tid, rnd<T>(x));
      }
      // dW += E^T dT
      for (int j = 0; j < H; ++j) {
        const float4 dt = *reinterpret_cast<const float4*>(Ts + j * D + 4 * tx);
        const float* e = E + j * D + ty;
#pragma unroll
        for (int rr = 0; rr < S::RK; ++rr) {
          const float x = e[S::RT * rr];
          acc_w[rr][0] = fmaf(x, dt.x, acc_w[rr][0]);
          acc_w[rr][1] = fmaf(x, dt.y, acc_w[rr][1]);
          acc_w[rr][2] = fmaf(x, dt.z, acc_w[rr][2]);
          acc_w[rr][3] = fmaf(x, dt.w, acc_w[rr][3]);
        }
      }
      __syncthreads();
    }
    __syncthreads();  // mine is rewritten by the next span
  }

  // this block's partial sums: [dW | db | dw_ua | db_ua | dw_da | db_da]
  float* part = partial + (long long)blockIdx.x * S::NPART;
#pragma unroll
  for (int r = 0; r < S::RK; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[(ty + S::RT * r) * D + 4 * tx + c] = acc_w[r][c];
  red[tid] = acc_b;
  __syncthreads();
  if (tid < D) {
    float x = 0.f;
    for (int k = 0; k < S::JG; ++k) x = __fadd_rn(x, red[k * D + tid]);
    part[D * D + tid] = x;
  }
  __syncthreads();
  red[tid] = acc_wua;
  __syncthreads();
  if (tid < D) {
    float x = 0.f;
    for (int k = 0; k < S::JG; ++k) x = __fadd_rn(x, red[k * D + tid]);
    part[D * D + D + tid] = x;
    part[D * D + 2 * D + 1 + tid] = acc_wda;
  }
  if (tid == 0) {
    part[D * D + 2 * D] = acc_bua;
    part[D * D + 3 * D + 1] = acc_bda;
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

// blocks of a persistent launch: every SM full, never more blocks than work.
// The SM count and each (kernel, shared memory) pair's occupancy are asked
// once per process and device, and the kernel's shared-memory attribute set
// then to the most it has needed, so a call asks the runtime nothing; every
// launch of these kernels takes its block count from here first.
template <typename K>
int persistent_blocks(K kernel, size_t smem, int work) {
  if (work <= 0) return 0;
  struct Seen {
    const void* kernel;
    size_t smem;
    int dev, full;
  };
  static Seen seen[64];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].kernel == (const void*)kernel && seen[i].smem == smem && seen[i].dev == dev)
      return seen[i].full < work ? seen[i].full : work;
  // the kernel's attribute only ever rises, so every earlier answer holds
  size_t most = smem;
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].kernel == (const void*)kernel && seen[i].dev == dev && seen[i].smem > most)
      most = seen[i].smem;
  int sms = 0, occ = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  const int full = sms * (occ > 0 ? occ : 1);
  if (n_seen < 64) seen[n_seen++] = {(const void*)kernel, smem, dev, full};
  return full < work ? full : work;
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
int pair_grid(const T* su, const T* pu, const T* q, const T* w_da, const T* b_da, int A,
              int Nq, bool anchor_is_row, T* out, cudaStream_t stream) {
  const int R = anchor_is_row ? A : Nq, C = anchor_is_row ? Nq : A;
  if (R <= 0 || C <= 0) return (int)cudaGetLastError();
  const size_t smem = grid_smem_bytes<D>();
  auto kernel = anchor_is_row ? pair_grid_kernel<D, true, T> : pair_grid_kernel<D, false, T>;
  // each instance's fixed shared memory, allowed once per process
  static const cudaError_t rows =
      cudaFuncSetAttribute(pair_grid_kernel<D, true, T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  static const cudaError_t cols =
      cudaFuncSetAttribute(pair_grid_kernel<D, false, T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const cudaError_t e = anchor_is_row ? rows : cols;
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((C + kGridCols - 1) / kGridCols, (R + kGridRows - 1) / kGridRows);
  kernel<<<grid, kGridThreads, smem, stream>>>(su, pu, q, w_da, b_da, R, C, out);
  return (int)cudaGetLastError();
}

// the training forward: the transfer, then the heads (su kept); Tall [Ns, D]
// and keep are the caller's scratch
template <int D, typename T>
int forward(const T* src, int Ns, const int* ids, const uint8_t* mask, int H, const T* table,
            const T* q, const T* W, const T* b, const T* w_ua, const T* b_ua, const T* w_da,
            const T* b_da, const GroupsView& g, int P, float* Tall, Keep keep, T* out,
            cudaStream_t stream) {
  const size_t tsmem = transfer_smem_bytes(D);
  // the instance's fixed shared memory, allowed once per process
  static const cudaError_t allowed = cudaFuncSetAttribute(
      transfer_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tsmem);
  cudaError_t e = allowed;
  if (e != cudaSuccess) return (int)e;
  const int rpass = Shape<D>::RPASS;
  if (Ns > 0)
    transfer_kernel<D, T><<<(Ns + rpass - 1) / rpass, kThreads, tsmem, stream>>>(src, Ns, W, b,
                                                                                  Tall);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = head_smem_bytes(D, H, false);
  const int blocks = persistent_blocks(forward_kernel<D, T>, smem, P);
  if (blocks < 0) return -blocks;
  if (blocks > 0)
    forward_kernel<D, T><<<blocks, kThreads, smem, stream>>>(Tall, ids, mask, H, table, q, w_ua,
                                                             b_ua, w_da, b_da, g, keep, out);
  return (int)cudaGetLastError();
}

// the training backward: the spans' counts (and d(table)'s rows no anchor
// names, zeroed), the heads' kernel, then the block-order sum of its
// partials into out [dW | db | dw_ua | db_ua | dw_da | db_da]
template <int D, typename T>
int backward(const T* src, const float* Tall, const int* ids, int H, const T* table, int N,
             const T* q, const T* w_ua, const T* w_da, const T* b_da, const GroupsView& g,
             Keep keep, const T* gz, T* dtable, T* dq, float* partial, int* counts, int blocks,
             T* out, cudaStream_t stream) {
  const size_t smem = head_smem_bytes(D, H, true);
  const int n = Shape<D>::NPART;
  if (blocks > 0) {
    span_count_kernel<D, T><<<(N + kSpan - 1) / kSpan, kThreads, 0, stream>>>(g, N, counts,
                                                                              dtable);
    backward_kernel<D, T><<<blocks, kThreads, smem, stream>>>(
        src, Tall, ids, H, table, N, q, w_ua, w_da, b_da, g, counts, keep, gz, dtable, dq,
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

// The training forward. src [Ns, D] the source table; ids, mask [>= N, H]
// the anchors' histories; table [N, D] the anchor side's table; q [P, D] the
// pairs' queries; plan: the seven addresses of the grouping of the pairs'
// anchor ids [P] over the table's rows (ops/row_groups.py::Groups); Tall
// float32 [Ns, D], su [P, D], att and attq [P, H] scratch the backward reads;
// out [P] logits.
extern "C" int natr_attention_forward(const void* src, int Ns, const void* ids,
                                      const void* mask, int H, int D, const void* table,
                                      const void* q, const void* W, const void* b,
                                      const void* w_ua, const void* b_ua, const void* w_da,
                                      const void* b_da, const void* const* plan, int P,
                                      void* Tall, void* su, void* att, void* attq, void* out,
                                      int dtype, void* stream) {
  const GroupsView g = groups_view(plan);
  const Keep keep{(float*)su, (float*)att, (float*)attq};
#define NATR_FWD(d, T)                                                                     \
  forward<d, T>((const T*)src, Ns, (const int*)ids, (const uint8_t*)mask, H, (const T*)table, \
                (const T*)q, (const T*)W, (const T*)b, (const T*)w_ua, (const T*)b_ua,       \
                (const T*)w_da, (const T*)b_da, g, P, (float*)Tall, keep, (T*)out,           \
                (cudaStream_t)stream)
  NATR_DISPATCH(NATR_FWD)
#undef NATR_FWD
}

// the backward's block count for a table of N rows (its partial-sum scratch
// has one row per block), or minus a CUDA error code
extern "C" int natr_attention_backward_blocks(int D, int H, int N, int dtype) {
  const size_t smem = head_smem_bytes(D, H, true);
#define NATR_BLOCKS(d, T) persistent_blocks(backward_kernel<d, T>, smem, N)
  NATR_DISPATCH(NATR_BLOCKS)
#undef NATR_BLOCKS
}

// The training backward, from the forward's plan and scratch (Tall, su, att,
// attq) and g [P]: dtable [N, D] (every row written: 0 where no pair's
// anchor), dq [P, D]; partial float32 [max(blocks, 1), D*D + 3D + 2] and
// counts int32 [ceil(N / 1024)] scratch; out the summed weight gradients
// [dW | db | dw_ua | db_ua | dw_da | db_da].
extern "C" int natr_attention_backward(const void* src, const void* ids, int H, int D,
                                       const void* table, int N, const void* q,
                                       const void* w_ua, const void* w_da, const void* b_da,
                                       const void* const* plan, const void* Tall,
                                       const void* su, const void* att, const void* attq,
                                       const void* g, void* dtable, void* dq, void* partial,
                                       void* counts, int blocks, void* out, int dtype,
                                       void* stream) {
  const GroupsView gv = groups_view(plan);
  const Keep keep{(float*)su, (float*)att, (float*)attq};
#define NATR_BWD(d, T)                                                                      \
  backward<d, T>((const T*)src, (const float*)Tall, (const int*)ids, H, (const T*)table, N,  \
                 (const T*)q, (const T*)w_ua, (const T*)w_da, (const T*)b_da, gv, keep,      \
                 (const T*)g, (T*)dtable, (T*)dq, (float*)partial, (int*)counts, blocks,     \
                 (T*)out,                                                                   \
                 (cudaStream_t)stream)
  NATR_DISPATCH(NATR_BWD)
#undef NATR_BWD
}
