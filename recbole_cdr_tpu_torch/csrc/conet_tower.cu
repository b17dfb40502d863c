// B15: CoNet's full-sort tower.
//
// Replaces recbole_cdr_tpu/models/conet.py:150-169 CoNet.full_sort_fn, where
// XLA materialises the [B, I, H0] first hidden of a tile of users against
// every target item (2.6 GB in float32 at the dense evaluator's [2,048,
// 4,980] tile) and runs the rest of the target tower on it. Inputs: the user
// half hu [B, H0] (u @ W_u + b0) and the item half hi [I, H0] (i @ W_i,
// built once per parameter version by the caller). For every (user b, item
// i) of the tile:
//
//   h = relu(hu[b] + hi[i]);  h = relu(h @ W_l + b_l) for each later layer l;
//   out[b, i] = sigmoid(h . w_out + b_out)
//
// Bound on an H100: operations. A pair costs H0 adds and relus and
// 2 sum(d_in d_out) + 2 d_last flops: about 5.6 k at the published tower
// (64 -> 32 -> 16 -> 8 -> 1), so a [2,048, 4,980] tile is ~57 GFLOP (0.85
// ms at 67 TFLOP/s on the CUDA cores) against 40.8 MB of output (12 us of
// bytes).
//
// Design: persistent blocks of 256 threads walk tiles of 4 users x 32
// items (128 pairs); the tower's weights are staged in shared memory once
// per block when they fit (the published tower's ~2.7 k floats), else layer
// by layer into one slot. A tile's hidden lives in shared memory only,
// transposed ([width][pair], stride 132), ping-ponging between two buffers:
// the first layer adds the 4 user rows to the 32 item rows and takes the
// relu as it stages them (16-byte loads of hi; an item row is read once per
// 4 users), then each later layer is a [128, d_in] x [d_in, d_out] product
// in which a thread owns 4 pairs x 4 outputs (one 16-byte load of the
// hidden and one of the weights, broadcast to the warp, per 16
// multiply-adds), and the output layer gives one thread a pair. No [B, I,
// H0] tensor exists in device memory; only the [B, I] probabilities are
// written. The wrapper pads every width to a multiple of 4 with zero
// weights (a padded unit's relu is 0). Not done yet: the later layers on
// the tensor cores (3xTF32 keeps float32 accuracy) and a register-resident
// hidden.

#include <cmath>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUsers = 4;                 // users of a tile
constexpr int kItems = 32;                // items of a tile
constexpr int kPairs = kUsers * kItems;   // pairs of a tile
constexpr int kGroups = kPairs / 4;       // pair groups of 4
constexpr int HS = kPairs + 4;            // row stride of the transposed hidden
constexpr int kMaxLayers = 5;             // products after the first layer
constexpr int kMaxWidth = 128;
constexpr size_t kSmemLimit = 232448;

// the tower's padded widths: w[0] = H0, w[l + 1] the output of product l
struct Tower {
  int n;                         // products after the first layer
  int w[kMaxLayers + 1];
};

__host__ __device__ inline int layer_floats(const Tower& t, int l) {
  return t.w[l] * t.w[l + 1] + t.w[l + 1];
}

__host__ __device__ inline int out_offset(const Tower& t) {
  int off = 0;
  for (int l = 0; l < t.n; ++l) off += layer_floats(t, l);
  return off;
}

__host__ __device__ inline int max_width(const Tower& t) {
  int m = 0;
  for (int l = 0; l <= t.n; ++l) m = t.w[l] > m ? t.w[l] : m;
  return m;
}

// the weights' floats in shared memory: every layer (resident), or the
// largest layer's slot, each followed by the output layer (w_out, b_out
// padded to 4)
__host__ __device__ inline int weight_floats(const Tower& t, bool resident) {
  int slot = 0;
  for (int l = 0; l < t.n; ++l) slot = layer_floats(t, l) > slot ? layer_floats(t, l) : slot;
  return (resident ? out_offset(t) : slot) + t.w[t.n] + 4;
}

inline size_t smem_bytes(const Tower& t, bool resident) {
  return 4 * ((size_t)weight_floats(t, resident) + 2 * (size_t)max_width(t) * HS);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ void stage(float* dst, const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = __ldg(src + i);
}

__global__ void __launch_bounds__(kThreads)
tower_kernel(const float* __restrict__ hu, const float* __restrict__ hi, int B, int I,
             const float* __restrict__ weights, Tower tw, int resident,
             float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  const int n_out = out_offset(tw);
  const int wf = weight_floats(tw, resident);
  float* wsm = sm;
  float* wout = wsm + wf - tw.w[tw.n] - 4;  // w_out, then b_out
  float* buf[2] = {sm + wf, sm + wf + max_width(tw) * HS};
  if (resident) stage(wsm, weights, wf);
  else stage(wout, weights + n_out, tw.w[tw.n] + 4);

  const int tid = threadIdx.x;
  const int H0 = tw.w[0];
  const long long n_ib = (I + kItems - 1) / kItems;
  const long long tiles = (long long)((B + kUsers - 1) / kUsers) * n_ib;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b0 = (int)(t / n_ib) * kUsers, i0 = (int)(t % n_ib) * kItems;
    // the first layer: h[k][p] = relu(hu[b][k] + hi[i][k]), pair p = (user
    // p / kItems, item p % kItems)
    for (int e = tid; e < kPairs * (H0 / 4); e += kThreads) {
      const int p = e % kPairs, k = 4 * (e / kPairs);
      const int b = b0 + p / kItems, i = i0 + p % kItems;
      float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
      if (b < B && i < I) {
        const float4 u = ldg4(hu + (long long)b * H0 + k), v = ldg4(hi + (long long)i * H0 + k);
        h = make_float4(fmaxf(__fadd_rn(u.x, v.x), 0.f), fmaxf(__fadd_rn(u.y, v.y), 0.f),
                        fmaxf(__fadd_rn(u.z, v.z), 0.f), fmaxf(__fadd_rn(u.w, v.w), 0.f));
      }
      float* dst = buf[0] + k * HS + p;
      dst[0] = h.x;
      dst[HS] = h.y;
      dst[2 * HS] = h.z;
      dst[3 * HS] = h.w;
    }
    __syncthreads();

    int cur = 0, off = 0;
    for (int l = 0; l < tw.n; ++l) {
      const int d_in = tw.w[l], d_out = tw.w[l + 1];
      const float* W = wsm + (resident ? off : 0);
      if (!resident) {
        stage(wsm, weights + off, layer_floats(tw, l));
        __syncthreads();
      }
      const float* bias = W + d_in * d_out;
      const float* in = buf[cur];
      float* dst = buf[cur ^ 1];
      // a thread's tile: pairs 4 pg .. 4 pg + 3, outputs 4 cg .. 4 cg + 3
      for (int tile = tid; tile < kGroups * (d_out / 4); tile += kThreads) {
        const int pg = tile % kGroups, cg = tile / kGroups;
        float acc[4][4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[p][c] = 0.f;
#pragma unroll 4
        for (int k = 0; k < d_in; ++k) {
          const float4 h = *reinterpret_cast<const float4*>(in + k * HS + 4 * pg);
          const float4 w = *reinterpret_cast<const float4*>(W + k * d_out + 4 * cg);
          const float hv[4] = {h.x, h.y, h.z, h.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[p][c] = fmaf(hv[p], wv[c], acc[p][c]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float bc = bias[4 * cg + c];
          *reinterpret_cast<float4*>(dst + (4 * cg + c) * HS + 4 * pg) =
              make_float4(fmaxf(__fadd_rn(acc[0][c], bc), 0.f),
                          fmaxf(__fadd_rn(acc[1][c], bc), 0.f),
                          fmaxf(__fadd_rn(acc[2][c], bc), 0.f),
                          fmaxf(__fadd_rn(acc[3][c], bc), 0.f));
        }
      }
      __syncthreads();
      cur ^= 1;
      off += layer_floats(tw, l);
    }

    // the output layer and the sigmoid, one thread a pair
    if (tid < kPairs) {
      const int b = b0 + tid / kItems, i = i0 + tid % kItems;
      const int d_last = tw.w[tw.n];
      const float* h = buf[cur] + tid;
      float acc = 0.f;
      for (int k = 0; k < d_last; ++k) acc = fmaf(h[k * HS], wout[k], acc);
      const float logit = __fadd_rn(acc, wout[d_last]);
      if (b < B && i < I)
        out[(long long)b * I + i] = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-logit)));
    }
    __syncthreads();
  }
}

}  // namespace

// hu [B, w0], hi [I, w0]; weights: per product l, W_l [w_l, w_{l+1}] then
// b_l [w_{l+1}], then w_out [w_n] and b_out padded to 4 (every width a
// multiple of 4, padded with zeros); out [B, I] sigmoid probabilities
extern "C" int conet_tower(const void* hu, const void* hi, int B, int I, const void* weights,
                           int n, int w0, int w1, int w2, int w3, int w4, int w5, void* out,
                           void* stream) {
  Tower tw{};
  tw.n = n;
  const int ws[kMaxLayers + 1] = {w0, w1, w2, w3, w4, w5};
  if (n < 0 || n > kMaxLayers) return (int)cudaErrorInvalidValue;
  for (int l = 0; l <= n; ++l) {
    if (ws[l] <= 0 || ws[l] > kMaxWidth || ws[l] % 4) return (int)cudaErrorInvalidValue;
    tw.w[l] = ws[l];
  }
  const long long tiles =
      (long long)((B + kUsers - 1) / kUsers) * ((I + kItems - 1) / kItems);
  if (tiles <= 0) return (int)cudaGetLastError();
  const bool resident = smem_bytes(tw, true) <= kSmemLimit;
  const size_t smem = smem_bytes(tw, resident);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(tower_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, tower_kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long full = (long long)sms * (occ > 0 ? occ : 1);
  const int blocks = (int)(full < tiles ? full : tiles);
  tower_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)hu, (const float*)hi, B, I, (const float*)weights, tw, resident ? 1 : 0,
      (float*)out);
  return (int)cudaGetLastError();
}
