// B15: CoNet's full-sort tower.
//
// Replaces recbole_cdr_tpu/models/conet.py:150-169 CoNet.full_sort_fn, where
// XLA materialises the [B, I, H0] first hidden of a tile of users against
// every target item (2.6 GB in float32 at the dense evaluator's [2,048,
// 4,980] tile) and runs the rest of the target tower on it. Inputs: the user
// half hu [B, H0] (u @ W_u), the item half hi [I, H0] (i @ W_i, built once
// per parameter version by the caller) and the first layer's bias b0 [H0].
// For every (user b, item i) of the tile:
//
//   h = relu((hu[b] + hi[i]) + b0);  h = relu(h @ W_l + b_l) for each later l;
//   out[b, i] = sigmoid(h . w_out + b_out)
//
// Bound on an H100: operations. A pair costs 3 H0 + 3 scalar operations
// (the first layer's adds and relu, the sigmoid) and 2 sum(d_in d_out) +
// 2 d_last product flops: 5,392 at the published tower (64 -> 32 -> 16 ->
// 8 -> 1), so a [2,048, 4,980] tile is ~55 GFLOP of products against 40.8
// MB of output (12 us of bytes). In 3xTF32 on the tensor cores (495
// TFLOP/s) that is 0.36 ms; in bf16 (989 TFLOP/s) 0.085 ms.
//
// Design: the products run on the tensor cores, the hidden stays in
// registers. A warp owns a tile of 16 items x 16 users: it copies the 16
// item rows of hi into shared memory once (rows padded so that the first
// layer's reads hit 32 banks), and for each user the 16 pairs (one item a
// row) are its rows of every product. The warp forms the first layer
// straight into its registers in the accumulator layout (a thread holds
// rows g and g + 8, columns 8 j + 2 t and + 1 of every 8-column tile j, g =
// lane / 4, t = lane % 4); each product's accumulators take bias, relu and
// (16-bit form) the rounding and are the next product's A operand as they
// stand: in 16 bits two neighbouring n-tiles are one k16 tile; in TF32 the
// k order inside each k8 tile is permuted (logical column t is column 2 t,
// t + 4 is 2 t + 1) and B is staged in the same order, so no shuffle moves
// an activation. The 8-wide output dot sums each thread's columns and the
// quad's four threads, and the sigmoid runs on the CUDA cores; only the
// [B, I] probabilities are written. The weights and biases are staged once
// per block in shared memory, and a persistent grid walks the tiles.
//
// Two paths, chosen by the tower's widths:
// - the published tower (CoNet's mlp_hidden_size [64, 32, 16, 8]) has its
//   widths compiled in (Fixed) and runs its products on wgmma (m64nNk16 in
//   16 bits, m64nNk8 TF32), A from registers: the block's four warps are
//   one warpgroup over 64 items x 16 users (the section "the published
//   tower on wgmma" below). On an H100 80GB HBM3 at 700 W, at the dense
//   tile ([2,048, 4,980]), it takes 0.84 ms in float32 and 0.28 ms in
//   bf16, where the run-time-width path below takes 2.11 and 1.01
//   (probe_kernel_split.py).
// - any other tower reads its widths from shared memory at run time, each
//   product's loops cut short by them, on mma.sync (m16n8k8 TF32,
//   m16n8k16), from B fragments staged once per block (read from the
//   weights in device memory instead when they do not fit).
// The wrapper pads every product's input width to 16 and the last width to
// 8 with zero weights (a padded unit's relu is 0). The 16-bit forms step two
// users at once on the published tower, each B operand serving both.
//
// float32: 3xTF32 (x = hi + lo, each product hi hi + hi lo + lo hi, the small
// terms first), which keeps float32 accuracy. B15-bf16, the 16-bit form
// (CoNet under compute_dtype: bfloat16; float16 through the same
// template): hu, hi, the weights and the probabilities are 16-bit, as JAX's
// bf16 full_sort returns them; the first layer adds packed pairs (__hadd2
// rounds exactly as a float32 add then a rounding to T does), the products
// have float32 accumulators, and each sum is rounded to T
// where JAX's value has a name: hu + hi, then its sum with b0 (JAX's order),
// each later layer's h @ W + b, the logit and the sigmoid.

#include <cmath>
#include <cuda_runtime.h>
#include <stdint.h>

#include "float16.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;        // items of a warp tile: the M of the products
constexpr int kUsers = 16;        // users of a warp tile
constexpr int kMaxLayers = 5;     // products after the first layer
constexpr int kMaxWidth = 128;
constexpr size_t kSmemLimit = 232448;

// the tower's padded widths: w[0] = H0, w[l + 1] the output of product l
struct Tower {
  int n;
  int w[kMaxLayers + 1];
};

template <typename T>
constexpr int kK = kWide<T> ? 8 : 16;  // k of one product: m16n8k8 tf32, m16n8k16
template <typename T>
constexpr int kWords = kWide<T> ? 4 : 2;  // B fragment words a lane: tf32 hi, hi, lo, lo

// element offset of W_l in the packed weights (each W_l followed by b_l;
// after the last, w_out and b_out)
__host__ __device__ inline int w_offset(const Tower& t, int l) {
  int off = 0;
  for (int i = 0; i < l; ++i) off += t.w[i] * t.w[i + 1] + t.w[i + 1];
  return off;
}

template <typename T>
__host__ __device__ inline int frag_words(const Tower& t, int l) {
  return t.w[l] / kK<T> * (t.w[l + 1] / 8) * 32 * kWords<T>;
}

template <typename T>
__host__ __device__ inline int all_frag_words(const Tower& t) {
  int n = 0;
  for (int l = 0; l < t.n; ++l) n += frag_words<T>(t, l);
  return n;
}

// the floats staged beside the fragments: b0, each b_l, w_out, b_out
__host__ __device__ inline int float_count(const Tower& t) {
  int n = t.w[0] + t.w[t.n] + 1;
  for (int l = 0; l < t.n; ++l) n += t.w[l + 1];
  return n;
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

// two 16-bit values as one word: x rounded to T in the low half, y in the high
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const __nv_bfloat162 r = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&r);
  } else {
    const __half2 r = __floats2half2_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&r);
  }
}

// relu((u + v) + c) of packed pairs, each add rounded to T
template <typename T>
__device__ __forceinline__ uint32_t first2(uint32_t u, uint32_t v, uint32_t c) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    using V = __nv_bfloat162;
    const V s = __hadd2(__hadd2(*reinterpret_cast<const V*>(&u), *reinterpret_cast<const V*>(&v)),
                        *reinterpret_cast<const V*>(&c));
    const V r = __hmax2(s, __float2bfloat162_rn(0.f));
    return *reinterpret_cast<const uint32_t*>(&r);
  } else {
    using V = __half2;
    const V s = __hadd2(__hadd2(*reinterpret_cast<const V*>(&u), *reinterpret_cast<const V*>(&v)),
                        *reinterpret_cast<const V*>(&c));
    const V r = __hmax2(s, __float2half2_rn(0.f));
    return *reinterpret_cast<const uint32_t*>(&r);
  }
}

// relu of both halves of a packed pair
template <typename T>
__device__ __forceinline__ uint32_t relu2(uint32_t x) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const __nv_bfloat162 r =
        __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&x), __float2bfloat162_rn(0.f));
    return *reinterpret_cast<const uint32_t*>(&r);
  } else {
    const __half2 r = __hmax2(*reinterpret_cast<const __half2*>(&x), __float2half2_rn(0.f));
    return *reinterpret_cast<const uint32_t*>(&r);
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);  // bit-equal in the quad's 4 lanes
}

__device__ __forceinline__ uint32_t bits16(const void* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}

// Lane `lane`'s B fragment of W [d_in, d_out] (device memory, row-major)
// for k-tile kc and n-tile j, column n = 8 j + g. tf32: the rows 8 kc + 2 t
// and + 1 (the permuted k order), each split, as (hi, hi, lo, lo); 16 bits:
// rows 16 kc + 2 t, + 1 and 16 kc + 2 t + 8, + 9 as two packed words.
template <typename T>
__device__ __forceinline__ void fragment_of(const T* __restrict__ W, int d_out, int kc, int j,
                                            int lane, uint32_t (&b)[kWords<T>]) {
  const int n = 8 * j + (lane >> 2), t = lane & 3;
  if constexpr (kWide<T>) {
    const int k = 8 * kc + 2 * t;
    split(__ldg(W + k * d_out + n), b[0], b[2]);
    split(__ldg(W + (k + 1) * d_out + n), b[1], b[3]);
  } else {
    const int k = 16 * kc + 2 * t;
    b[0] = bits16(W + k * d_out + n) | bits16(W + (k + 1) * d_out + n) << 16;
    b[1] = bits16(W + (k + 8) * d_out + n) | bits16(W + (k + 9) * d_out + n) << 16;
  }
}

// the widths of a tower known when the kernel is compiled: W[0] = H0, W[l +
// 1] the output of product l (the published tower, 64 -> 32 -> 16 -> 8)
template <int... W>
struct Fixed {
  static constexpr int kW[sizeof...(W)] = {W...};
  static constexpr int kN = (int)sizeof...(W) - 1;
};

// a layer's shape (k-tiles, n-tiles), where its B fragments (words) and
// bias (floats) sit in shared memory, and W_l's element offset in the
// packed weights; layer n (past the last product) gives w_out's offset as
// its bias
struct LayerGeo {
  int n_kt, ntl, frag, bias, w;
};

template <typename S>
__host__ __device__ constexpr int fixed_w(int l) {
  return S::kW[l];
}

// where b_l (l < n) or, for l = n, w_out sits among a Fixed tower's staged
// floats
template <typename S>
__host__ __device__ constexpr int fixed_bias(int l) {
  int bias = S::kW[0];
  for (int i = 0; i < l; ++i) bias += S::kW[i + 1];
  return bias;
}

// One product h @ W_l + b_l of M users' 16 pairs each: A from the
// activations (x in float32, the packed pairs a in 16 bits), B from the
// fragments (shared memory when resident, else W_l in device memory; each
// B fragment serves the M users), the sums given bias, the rounding to T
// and relu in place. Inlined with a layer's shape known, every guard folds
// away.
template <int KMAX, typename T, int M>
__device__ __forceinline__ void product(float (&x)[M][KMAX / 8][4],
                                        uint32_t (&a)[M][KMAX / 8][2], int n_kt, int ntl,
                                        const uint32_t* __restrict__ frag,
                                        const float* __restrict__ bias, bool resident,
                                        const T* __restrict__ W, int lane) {
  constexpr int NT = KMAX / 8;
  constexpr bool F32 = kWide<T>;
  const int t = lane & 3;
  float acc[M][NT][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KMAX / kK<T>; ++kc) {
    if (kc >= n_kt) break;
    uint32_t ah[M][4], al[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if constexpr (F32) {
        split(x[m][kc][0], ah[m][0], al[m][0]);
        split(x[m][kc][2], ah[m][1], al[m][1]);
        split(x[m][kc][1], ah[m][2], al[m][2]);
        split(x[m][kc][3], ah[m][3], al[m][3]);
      } else {
        ah[m][0] = a[m][2 * kc][0], ah[m][1] = a[m][2 * kc][1];
        ah[m][2] = a[m][2 * kc + 1][0], ah[m][3] = a[m][2 * kc + 1][1];
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= ntl) break;
      uint32_t b[kWords<T>];
      if (resident) {
        const uint32_t* p = frag + ((kc * ntl + j) * 32 + lane) * kWords<T>;
        if constexpr (F32) {
          const uint4 v = *reinterpret_cast<const uint4*>(p);
          b[0] = v.x, b[1] = v.y, b[2] = v.z, b[3] = v.w;
        } else {
          const uint2 v = *reinterpret_cast<const uint2*>(p);
          b[0] = v.x, b[1] = v.y;
        }
      } else {
        fragment_of<T>(W, 8 * ntl, kc, j, lane, b);
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if constexpr (F32) {
          mma_tf32(acc[m][j], al[m], b[0], b[1]);  // the small terms first
          mma_tf32(acc[m][j], ah[m], b[2], b[3]);
          mma_tf32(acc[m][j], ah[m], b[0], b[1]);
        } else {
          mma_16<T>(acc[m][j], ah[m], b[0], b[1]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= ntl) break;
    const float2 z = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if constexpr (F32) {
        x[m][j][0] = fmaxf(__fadd_rn(acc[m][j][0], z.x), 0.f);
        x[m][j][1] = fmaxf(__fadd_rn(acc[m][j][1], z.y), 0.f);
        x[m][j][2] = fmaxf(__fadd_rn(acc[m][j][2], z.x), 0.f);
        x[m][j][3] = fmaxf(__fadd_rn(acc[m][j][3], z.y), 0.f);
      } else {
        a[m][j][0] = relu2<T>(pack2<T>(__fadd_rn(acc[m][j][0], z.x), __fadd_rn(acc[m][j][1], z.y)));
        a[m][j][1] = relu2<T>(pack2<T>(__fadd_rn(acc[m][j][2], z.x), __fadd_rn(acc[m][j][3], z.y)));
      }
    }
  }
}

// ---- the published tower on wgmma -------------------------------------------
//
// The block's four warps are one warpgroup and share a tile of 64 items x
// 16 users, warp w the items 16 w .. 16 w + 15 (its rows of the products'
// M = 64). The A operand stays in registers in the layout above (wgmma's
// register A is mma.sync's A in each warp's 16 rows, its accumulators the
// same n8 tiles, so the chain of layers and tf32's permuted k order are
// unchanged); each W_l is staged once per block as W_l^T in K-major rows
// of 128 bytes in the 128-byte swizzle (B13's layout; in float32 its TF32
// high and low words as two copies, k permuted as the A fragments), which
// the products read through descriptors.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the descriptor of a K-major operand in 128-byte swizzled rows (8-row atoms
// of 1,024 bytes, 1,024-byte aligned), advanced by kstep depth steps of 32
// bytes (16 16-bit values, 8 TF32)
__device__ __forceinline__ uint64_t sw128_desc(const void* p, int kstep) {
  const uint32_t a = smem_u32(p) + 32 * kstep;
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the operand list of a wgmma of N / 2 accumulators: the accumulators, A's
// four words, B's descriptor and the accumulate predicate
#define TOWER_WG_D4(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
#define TOWER_WG_D8(d) TOWER_WG_D4(d), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define TOWER_WG_D16(d)                                                                     \
  TOWER_WG_D8(d), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define TOWER_WG_IN(a, b, acc) \
  "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc)
#define TOWER_WG_N8(op, tail) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n" op " {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p" tail
#define TOWER_WG_N16(op, tail)                                                               \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n" op " {%0, %1, %2, %3, %4, %5, %6, %7}, "      \
  "{%8, %9, %10, %11}, %12, p" tail
#define TOWER_WG_N32(op, tail)                                                               \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" op " {%0, %1, %2, %3, %4, %5, %6, %7, %8, "   \
  "%9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p" tail
#define TOWER_WG_16(N, TY) \
  "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY
#define TOWER_WG_TF32(N) "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32"

// D[64 x N] (+)= A[64 x K] (registers) B[N x K]^T (descriptor), float32
// sums: K = 16 of 16-bit values for T 16-bit, K = 8 of TF32 for float32;
// N = 8, 16 or 32
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  constexpr bool kBf = std::is_same_v<T, __nv_bfloat16>, kTf = kWide<T>;
  if constexpr (N == 8 && kTf)
    asm volatile(TOWER_WG_N8(TOWER_WG_TF32(8), ", 1, 1;\n}\n") : TOWER_WG_D4(d)
                 : TOWER_WG_IN(a, b, acc));
  else if constexpr (N == 8 && kBf)
    asm volatile(TOWER_WG_N8(TOWER_WG_16(8, "bf16"), ", 1, 1, 0;\n}\n") : TOWER_WG_D4(d)
                 : TOWER_WG_IN(a, b, acc));
  else if constexpr (N == 8)
    asm volatile(TOWER_WG_N8(TOWER_WG_16(8, "f16"), ", 1, 1, 0;\n}\n") : TOWER_WG_D4(d)
                 : TOWER_WG_IN(a, b, acc));
  else if constexpr (N == 16 && kTf)
    asm volatile(TOWER_WG_N16(TOWER_WG_TF32(16), ", 1, 1;\n}\n") : TOWER_WG_D8(d)
                 : TOWER_WG_IN(a, b, acc));
  else if constexpr (N == 16 && kBf)
    asm volatile(TOWER_WG_N16(TOWER_WG_16(16, "bf16"), ", 1, 1, 0;\n}\n") : TOWER_WG_D8(d)
                 : TOWER_WG_IN(a, b, acc));
  else if constexpr (N == 16)
    asm volatile(TOWER_WG_N16(TOWER_WG_16(16, "f16"), ", 1, 1, 0;\n}\n") : TOWER_WG_D8(d)
                 : TOWER_WG_IN(a, b, acc));
  else if constexpr (N == 32 && kTf)
    asm volatile(TOWER_WG_N32(TOWER_WG_TF32(32), ", 1, 1;\n}\n") : TOWER_WG_D16(d)
                 : TOWER_WG_IN(a, b, acc));
  else if constexpr (N == 32 && kBf)
    asm volatile(TOWER_WG_N32(TOWER_WG_16(32, "bf16"), ", 1, 1, 0;\n}\n") : TOWER_WG_D16(d)
                 : TOWER_WG_IN(a, b, acc));
  else if constexpr (N == 32)
    asm volatile(TOWER_WG_N32(TOWER_WG_16(32, "f16"), ", 1, 1, 0;\n}\n") : TOWER_WG_D16(d)
                 : TOWER_WG_IN(a, b, acc));
  else
    static_assert(N == 8 || N == 16 || N == 32, "no wgmma of this width");
}

// the bytes of one 128-byte-row chunk of a staged W^T of N outputs, and of
// one copy of it: its K values cut into rows of 128 bytes
template <typename T>
__host__ __device__ constexpr int wg_chunk(int N) {
  return 128 * N;
}
template <typename T>
__host__ __device__ constexpr int wg_copy(int K, int N) {
  return wg_chunk<T>(N) * ((K * (int)sizeof(T) + 127) / 128);
}

// byte offset of the staged W_l^T of a Fixed tower (float32: its high
// words, then its low words)
template <typename T, typename S>
__host__ __device__ constexpr int wg_offset(int l) {
  int off = 0;
  for (int i = 0; i < l; ++i) off += (kWide<T> ? 2 : 1) * wg_copy<T>(S::kW[i], S::kW[i + 1]);
  return off;
}

// W^T [N rows] x [K values] from W [K, N] row-major in device memory, in
// the 128-byte swizzle, rows of 128 bytes, zeros past K in the last; in
// float32 each value split into its TF32 high word (the first copy) and
// low word (the second), the k order permuted inside each k8 step as the A
// fragments' (position p < 4 holds k 2 p, p >= 4 holds k 2 (p - 4) + 1)
template <typename T>
__device__ void stage_wg(unsigned char* dst, const T* __restrict__ W, int K, int N) {
  constexpr int kPer = 128 / (int)sizeof(T);  // values a row of 128 bytes
  const int chunks = (K + kPer - 1) / kPer, copy = 128 * N * chunks;
  for (int e = threadIdx.x; e < N * chunks * kPer; e += kThreads) {
    const int n = e / (chunks * kPer), q = e % (chunks * kPer);
    const int c = q / kPer, r = q % kPer;  // chunk, value in the 128-byte row
    const int at = c * 128 * N + (n >> 3) * 1024 + (n & 7) * 128 +
                   ((((int)sizeof(T) * r >> 4) ^ (n & 7)) << 4) + (((int)sizeof(T) * r) & 15);
    if constexpr (kWide<T>) {
      const int p = q & 7, k = (q & ~7) + (p < 4 ? 2 * p : 2 * (p - 4) + 1);
      uint32_t hi = 0, lo = 0;
      if (k < K) split(__ldg(W + k * N + n), hi, lo);
      *reinterpret_cast<uint32_t*>(dst + at) = hi;
      *reinterpret_cast<uint32_t*>(dst + copy + at) = lo;
    } else {
      *reinterpret_cast<unsigned short*>(dst + at) =
          q < K ? __ldg(reinterpret_cast<const unsigned short*>(W + q * N + n)) : 0;
    }
  }
}

// every W_l^T of a Fixed tower, layer L on, staged (stage_wg)
template <typename T, typename S, int L = 0>
__device__ __forceinline__ void stage_all_wg(unsigned char* wsm, const T* __restrict__ weights,
                                             const Tower& tw) {
  if constexpr (L < S::kN) {
    constexpr int K = S::kW[L], N = S::kW[L + 1], kOff = wg_offset<T, S>(L);
    stage_wg<T>(wsm + kOff, weights + w_offset(tw, L), K, N);
    stage_all_wg<T, S, L + 1>(wsm, weights, tw);
  }
}

// the products of a Fixed tower for M users on wgmma, layer L on: the M
// users' products issued as one group (3xTF32 in float32, the small terms
// first), then the sums given bias, the rounding to T and relu in place
template <typename T, int M, typename S, int L = 0>
__device__ __forceinline__ void wg_products(float (&x)[M][8][4], uint32_t (&a)[M][8][2],
                                            const unsigned char* wsm, const float* fl) {
  if constexpr (L < S::kN) {
    constexpr bool F32 = kWide<T>;
    constexpr int K = S::kW[L], N = S::kW[L + 1], KT = K / kK<T>;
    static_assert(K % 16 == 0 && (N == 8 || N == 16 || N == 32), "a wgmma layer's widths");
    constexpr int kOff = wg_offset<T, S>(L), kCopy = wg_copy<T>(K, N), kChunk = wg_chunk<T>(N);
    constexpr int kBias = fixed_bias<S>(L);
    const unsigned char* w = wsm + kOff;
    float acc[M][N / 2];
    // the A words: float32's TF32 splits, all made before the group is
    // issued (a register written between its products would serialise them)
    uint32_t ah[M][KT][4], al[M][KT][4];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int kc = 0; kc < KT; ++kc) {
        if constexpr (F32) {
          split(x[m][kc][0], ah[m][kc][0], al[m][kc][0]);
          split(x[m][kc][2], ah[m][kc][1], al[m][kc][1]);
          split(x[m][kc][1], ah[m][kc][2], al[m][kc][2]);
          split(x[m][kc][3], ah[m][kc][3], al[m][kc][3]);
        } else {
          ah[m][kc][0] = a[m][2 * kc][0], ah[m][kc][1] = a[m][2 * kc][1];
          ah[m][kc][2] = a[m][2 * kc + 1][0], ah[m][kc][3] = a[m][2 * kc + 1][1];
        }
      }
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int kc = 0; kc < KT; ++kc) {
        const uint64_t bh = sw128_desc(w + kc / 4 * kChunk, kc % 4);
        if constexpr (F32) {
          const uint64_t bl = sw128_desc(w + kCopy + kc / 4 * kChunk, kc % 4);
          wgmma_rs<T, N>(acc[m], al[m][kc], bh, kc > 0);
          wgmma_rs<T, N>(acc[m], ah[m][kc], bl, 1);
          wgmma_rs<T, N>(acc[m], ah[m][kc], bh, 1);
        } else {
          wgmma_rs<T, N>(acc[m], ah[m][kc], bh, kc > 0);
        }
      }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[m][i])::"memory");
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float2 z = *reinterpret_cast<const float2*>(fl + kBias + 8 * j + 2 * t);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float* c = acc[m] + 4 * j;
        if constexpr (F32) {
          x[m][j][0] = fmaxf(__fadd_rn(c[0], z.x), 0.f);
          x[m][j][1] = fmaxf(__fadd_rn(c[1], z.y), 0.f);
          x[m][j][2] = fmaxf(__fadd_rn(c[2], z.x), 0.f);
          x[m][j][3] = fmaxf(__fadd_rn(c[3], z.y), 0.f);
        } else {
          a[m][j][0] = relu2<T>(pack2<T>(__fadd_rn(c[0], z.x), __fadd_rn(c[1], z.y)));
          a[m][j][1] = relu2<T>(pack2<T>(__fadd_rn(c[2], z.x), __fadd_rn(c[3], z.y)));
        }
      }
    }
    wg_products<T, M, S, L + 1>(x, a, wsm, fl);
  }
}

// smem words before the floats: the staged W_l^T with a 1,024-byte
// alignment's slack (wgmma), the B fragments (resident), or none
template <typename T, typename S>
__host__ __device__ inline int frag_region_words(const Tower& t, bool resident) {
  if constexpr (!std::is_void_v<S>) {
    constexpr int kBytes = wg_offset<T, S>(S::kN);
    return (kBytes + 1024) / 4;
  } else
    return resident ? all_frag_words<T>(t) : 0;
}

// smem words a row of a warp's item tile takes: H0 values and a pad that
// keeps the first layer's reads free of bank conflicts (float2 reads of 8
// rows x 4 lanes in float32, word reads in 16 bits)
template <typename T>
__host__ __device__ inline int row_words(int H0) {
  const int w = kWide<T> ? H0 : H0 / 2, pad = kWide<T> ? 8 : 4;
  return w + ((pad - w) % 32 + 32) % 32;
}

// S: Fixed<...> (the widths compiled in; products on wgmma) or void (the
// widths of tw, read from shared memory; products on mma.sync)
template <int KMAX, typename T, typename S>
__global__ void __launch_bounds__(kThreads)
tower_kernel(const T* __restrict__ hu, const T* __restrict__ hi, const T* __restrict__ b0,
             int B, int I, const T* __restrict__ weights, Tower tw, int resident,
             T* __restrict__ out) {
  constexpr int NT = KMAX / 8;  // n-tiles of the widest layer
  constexpr bool F32 = kWide<T>;
  constexpr bool kFixed = !std::is_void_v<S>;
  // users a step: two share each B fragment in the published tower's 16-bit
  // form; float32's 3xTF32 operands, and the widths read at run time, leave
  // registers for one
  constexpr int M = F32 || !kFixed ? 1 : 2;
  // warps that share a tile's users, each its own 16 items (the warpgroup's
  // M = 64 rows on wgmma)
  constexpr int kSpan = kFixed ? kWarps : 1;
  extern __shared__ __align__(16) uint32_t sm[];
  __shared__ LayerGeo geos[kMaxLayers + 1];  // the runtime tower's layers, then w_out
  __shared__ int n_layers, d_last;
  if (threadIdx.x == 0) {
    int frag = 0, bias = tw.w[0], w = 0;
    for (int l = 0; l <= tw.n; ++l) {
      geos[l] = {tw.w[l] / kK<T>, l < tw.n ? tw.w[l + 1] / 8 : 0, frag, bias, w};
      if (l == tw.n) break;
      frag += frag_words<T>(tw, l);
      bias += tw.w[l + 1];
      w += tw.w[l] * tw.w[l + 1] + tw.w[l + 1];
    }
    n_layers = tw.n, d_last = tw.w[tw.n];
  }
  const int n_frag = frag_region_words<T, S>(tw, resident);
  float* fl = reinterpret_cast<float*>(sm + n_frag);
  // the staged W_l^T, 1,024-byte aligned (wgmma)
  unsigned char* wsm =
      reinterpret_cast<unsigned char*>(sm) + ((1024 - (smem_u32(sm) & 1023)) & 1023);
  const int H0 = tw.w[0], SW = row_words<T>(H0);
  uint32_t* tiles = sm + n_frag + ((float_count(tw) + 3) & ~3);

  // ---- stage: W_l^T (wgmma) or the B fragments (resident), b0, the
  // biases, w_out and b_out
  {
    if constexpr (kFixed) {
      stage_all_wg<T, S>(wsm, weights, tw);
      fence_proxy_async();  // the generic stores, then wgmma's reads
    }
    int off = 0;
    for (int l = 0; l < tw.n && resident && !kFixed; ++l) {
      const int ntl = tw.w[l + 1] / 8, n_kt = tw.w[l] / kK<T>;
      const T* W = weights + w_offset(tw, l);
      for (int e = threadIdx.x; e < n_kt * ntl * 32; e += kThreads) {
        uint32_t b[kWords<T>];
        fragment_of<T>(W, tw.w[l + 1], e / 32 / ntl, e / 32 % ntl, e % 32, b);
#pragma unroll
        for (int q = 0; q < kWords<T>; ++q) sm[off + e * kWords<T> + q] = b[q];
      }
      off += frag_words<T>(tw, l);
    }
    int f = 0;
    for (int e = threadIdx.x; e < tw.w[0]; e += kThreads) fl[e] = ld1(b0 + e);
    f += tw.w[0];
    for (int l = 0; l < tw.n; ++l) {
      const T* b = weights + w_offset(tw, l) + tw.w[l] * tw.w[l + 1];
      for (int e = threadIdx.x; e < tw.w[l + 1]; e += kThreads) fl[f + e] = ld1(b + e);
      f += tw.w[l + 1];
    }
    const T* wo = weights + w_offset(tw, tw.n);
    for (int e = threadIdx.x; e <= tw.w[tw.n]; e += kThreads) fl[f + e] = ld1(wo + e);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int nt0 = H0 / 8, dl = d_last, wo_at = geos[n_layers].bias;
  if constexpr (kFixed) {
    constexpr int kNt0 = fixed_w<S>(0) / 8, kDl = fixed_w<S>(S::kN);
    constexpr int kWo = fixed_bias<S>(S::kN);
    nt0 = kNt0, dl = kDl, wo_at = kWo;
  }
  const int warp = threadIdx.x >> 5;
  uint32_t* tile_rows = tiles + warp * kItems * SW;  // this warp's item rows
  const int n_ib = (I + kItems * kSpan - 1) / (kItems * kSpan);
  const long long tiles_n = (long long)n_ib * ((B + kUsers - 1) / kUsers);
  for (long long tile = ((long long)blockIdx.x * kWarps + warp) / kSpan; tile < tiles_n;
       tile += (long long)gridDim.x * kWarps / kSpan) {
    const int u0 = (int)(tile / n_ib) * kUsers;
    const int i0 = (int)(tile % n_ib) * kItems * kSpan + (kFixed ? warp * kItems : 0);
    // the tile's 16 item rows into shared memory, once for its 16 users
    const int chunks = H0 * (int)sizeof(T) / 16;  // 16-byte pieces of a row
    __syncwarp();
    for (int e = lane; e < kItems * chunks; e += 32) {
      const int r = e / chunks, c = e % chunks;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (i0 + r < I) v = __ldg(reinterpret_cast<const uint4*>(hi + (long long)(i0 + r) * H0) + c);
      *reinterpret_cast<uint4*>(tile_rows + r * SW + 4 * c) = v;
    }
    __syncwarp();
    const uint32_t* row_lo = tile_rows + g * SW;
    const uint32_t* row_hi = tile_rows + (g + 8) * SW;
    const int u_end = min(B, u0 + kUsers);
    for (int b0u = u0; b0u < u_end; b0u += M) {
      // activations in the accumulator layout, user b0u + m: float32 values
      // (x[m][j][0..3]: row g cols 8 j + 2 t, + 1, then row g + 8), or
      // 16-bit pairs (a[m][j][0] row g, a[m][j][1] row g + 8); a user past
      // the tile's last repeats it, unwritten
      float x[M][NT][4];
      uint32_t a[M][NT][2];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const T* urow = hu + (long long)min(b0u + m, u_end - 1) * H0 + 2 * t;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j >= nt0) break;
          if constexpr (F32) {
            const float2 u = __ldg(reinterpret_cast<const float2*>(urow + 8 * j));
            const float2 p = *reinterpret_cast<const float2*>(row_lo + 8 * j + 2 * t);
            const float2 q = *reinterpret_cast<const float2*>(row_hi + 8 * j + 2 * t);
            const float2 z = *reinterpret_cast<const float2*>(fl + 8 * j + 2 * t);
            x[m][j][0] = fmaxf(__fadd_rn(__fadd_rn(u.x, p.x), z.x), 0.f);
            x[m][j][1] = fmaxf(__fadd_rn(__fadd_rn(u.y, p.y), z.y), 0.f);
            x[m][j][2] = fmaxf(__fadd_rn(__fadd_rn(u.x, q.x), z.x), 0.f);
            x[m][j][3] = fmaxf(__fadd_rn(__fadd_rn(u.y, q.y), z.y), 0.f);
          } else {
            const uint32_t u = __ldg(reinterpret_cast<const unsigned*>(urow + 8 * j));
            const float2 zf = *reinterpret_cast<const float2*>(fl + 8 * j + 2 * t);
            const uint32_t z = pack2<T>(zf.x, zf.y);  // exact: b0's own 16-bit values
            a[m][j][0] = first2<T>(u, row_lo[4 * j + t], z);
            a[m][j][1] = first2<T>(u, row_hi[4 * j + t], z);
          }
        }
      }
      // the later layers
      if constexpr (kFixed) {
        wg_products<T, M, S>(x, a, wsm, fl);
      } else {
        for (int l = 0; l < n_layers; ++l) {
          const LayerGeo geo = geos[l];
          product<KMAX, T, M>(x, a, geo.n_kt, geo.ntl, sm + geo.frag, fl + geo.bias, resident,
                              weights + geo.w, lane);
        }
      }
      // the output layer on the CUDA cores: a thread's columns, then its quad
      const float* wo = fl + wo_at;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j >= dl / 8) break;
          const float2 z = *reinterpret_cast<const float2*>(wo + 8 * j + 2 * t);
          float v[4];
          if constexpr (F32) {
            v[0] = x[m][j][0], v[1] = x[m][j][1], v[2] = x[m][j][2], v[3] = x[m][j][3];
          } else {
            v[0] = from_bits<T>(a[m][j][0] & 0xFFFFu), v[1] = from_bits<T>(a[m][j][0] >> 16);
            v[2] = from_bits<T>(a[m][j][1] & 0xFFFFu), v[3] = from_bits<T>(a[m][j][1] >> 16);
          }
          s_lo = fmaf(v[1], z.y, fmaf(v[0], z.x, s_lo));
          s_hi = fmaf(v[3], z.y, fmaf(v[2], z.x, s_hi));
        }
        s_lo = quad_sum(s_lo);
        s_hi = quad_sum(s_hi);
        const int i = i0 + g + (t & 1 ? 8 : 0), b = b0u + m;
        const float logit = rnd<T>(__fadd_rn(t & 1 ? s_hi : s_lo, wo[dl]));
        const float p = rnd<T>(__fdiv_rn(1.f, __fadd_rn(1.f, expf(-logit))));
        if (t < 2 && i < I && b < u_end) st1(out + (long long)b * I + i, p);
      }
    }
  }
}

template <typename T, typename S = void>
size_t smem_bytes(const Tower& t, bool resident) {
  return 4 * ((size_t)frag_region_words<T, S>(t, resident) + (((size_t)float_count(t) + 3) & ~3) +
              (size_t)kWarps * kItems * row_words<T>(t.w[0]));
}

template <int KMAX, typename T, typename S>
int launch(const void* hu, const void* hi, const void* b0, int B, int I, const void* weights,
           const Tower& tw, bool resident, void* out, cudaStream_t stream) {
  int dev = 0, sms = 0, occ = 0;
  constexpr int kSpan = std::is_void_v<S> ? 1 : kWarps;
  const size_t smem = smem_bytes<T, S>(tw, resident);
  const long long tiles = (long long)((B + kUsers - 1) / kUsers) *
                          ((I + kItems * kSpan - 1) / (kItems * kSpan)) * kSpan;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(tower_kernel<KMAX, T, S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, tower_kernel<KMAX, T, S>, kThreads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  const long long full = (long long)sms * (occ > 0 ? occ : 1);
  const long long need = (tiles + kWarps - 1) / kWarps;
  const int blocks = (int)(full < need ? full : need);
  tower_kernel<KMAX, T, S><<<blocks, kThreads, smem, stream>>>(
      (const T*)hu, (const T*)hi, (const T*)b0, B, I, (const T*)weights, tw, resident ? 1 : 0,
      (T*)out);
  return (int)cudaGetLastError();
}

// the published tower (CoNet's mlp_hidden_size [64, 32, 16, 8]) compiled in
using Published = Fixed<64, 32, 16, 8>;

template <typename T>
int launch_widths(const void* hu, const void* hi, const void* b0, int B, int I,
                  const void* weights, const Tower& tw, void* out, cudaStream_t stream) {
  bool published = tw.n == Published::kN;
  for (int l = 0; published && l <= tw.n; ++l) published = tw.w[l] == Published::kW[l];
  if (published)
    return launch<64, T, Published>(hu, hi, b0, B, I, weights, tw, true, out, stream);
  const bool resident = smem_bytes<T>(tw, true) <= kSmemLimit;
  if (!resident && smem_bytes<T>(tw, false) > kSmemLimit) return (int)cudaErrorInvalidValue;
  int widest = 0;
  for (int l = 0; l <= tw.n; ++l) widest = tw.w[l] > widest ? tw.w[l] : widest;
  if (widest <= 64)
    return launch<64, T, void>(hu, hi, b0, B, I, weights, tw, resident, out, stream);
  return launch<kMaxWidth, T, void>(hu, hi, b0, B, I, weights, tw, resident, out, stream);
}

}  // namespace

// hu [B, w0], hi [I, w0], b0 [w0]; weights: per product l, W_l [w_l, w_{l+1}]
// then b_l [w_{l+1}], then w_out [w_n] and b_out [1] (w_0 .. w_{n-1} multiples
// of 16, w_n of 8, padded with zeros); out [B, I] sigmoid probabilities;
// every one of them of the type dtype: 0 float32, 1 bfloat16, 2 float16
extern "C" int conet_tower(const void* hu, const void* hi, const void* b0, int B, int I,
                           const void* weights, int n, int w0, int w1, int w2, int w3,
                           int w4, int w5, void* out, int dtype, void* stream) {
  Tower tw{};
  tw.n = n;
  const int ws[kMaxLayers + 1] = {w0, w1, w2, w3, w4, w5};
  if (n < 0 || n > kMaxLayers) return (int)cudaErrorInvalidValue;
  for (int l = 0; l <= n; ++l) {
    if (ws[l] <= 0 || ws[l] > kMaxWidth || ws[l] % (l < n ? 16 : 8))
      return (int)cudaErrorInvalidValue;
    tw.w[l] = ws[l];
  }
  if (B <= 0 || I <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_widths<float>(hu, hi, b0, B, I, weights, tw, out, st);
    case 1: return launch_widths<__nv_bfloat16>(hu, hi, b0, B, I, weights, tw, out, st);
    case 2: return launch_widths<__half>(hu, hi, b0, B, I, weights, tw, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
