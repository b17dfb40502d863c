// B3: one epoch stream of the device loop in one launch: the swap-or-not
// shuffle of a domain's interactions (or of the overlapped ids) and the
// gathers of its permuted rows.
//
// Replaces recbole_cdr_tpu/trainer/device_loop.py:483-518 (domain_stream up
// to the negatives) and :560-570 (the OVERLAP stream), which XLA fuses into
// one program around :63-88 _swap_or_not. Slot t of steps [step_lo, step_lo
// + n_steps) of dstep slots is slot (step_lo + t / dstep) * dstep + t % dstep
// of one permutation, or, when the source cycles in a BOTH phase (per_cycle
// > 0 batches a cycle), slot ((step_lo + t / dstep) % per_cycle) * dstep + t
// % dstep of cycle (step_lo + t / dstep) / per_cycle's own permutation (key
// row). It is valid below n; an invalid slot stands in as slot 0. The keyed
// bijection on [0, n) maps it to a row (0 for n <= 1): round r pairs x with
// partner = (K_r - x) mod n and swaps iff the low bit of the murmur3
// finalizer of max(x, partner) ^ salt_r is set. The launch writes the
// table's row at that row, column by column (one column, or two: a domain's
// users and items side by side, so that one 8-byte load reads both), and
// the float32 weight (1 where valid). JAX's
// `% max(n, 1)` of the substituted slot changes nothing: a valid slot is
// below n, an invalid one is 0.
//
// Bound on an H100: integer instructions. A slot reads 4-8 bytes at a random
// row and writes 8-12, but takes 64 rounds of about a dozen dependent
// 32-bit integer instructions, most of them on the SMs' integer pipe (64
// lanes an SM a clock), the rest on the FMA pipe (as many lanes). Design:
// one slot a thread, the grid sized from the SM count so that every SM
// holds the same number of slots (blocks of 128 w threads, w warps a
// scheduler, as many blocks on every SM); a block stages the 64 keys and
// salts of the key rows its slots span once in shared memory; all slot
// arithmetic in 32 bits. The round is trimmed by algebra: the partner is the
// unsigned min of key - x and key + n - x (key + n staged; the compiler
// fuses the sub and the min), the finalizer's first shift of the salt is
// folded into the staged salt (salt ^ salt >> 16), and its last shift and
// mask into the second multiplier (bit 0 of m ^ m >> 16 is bit 16 of m *
// 0x10001). At the main path's streams (probe_stream_merge.py) the value's
// shifts as high halves of products (on the FMA pipe), the partner's wrap
// by a sign mask and the swap's select by a predicated move were no
// faster; 2, 4 or 8 slots a thread as independent chains (fewer warps), an
// earlier form of this kernel, were slower.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kRounds = 64;
//: key rows a block stages
constexpr int kStageRows = 16;
constexpr uint32_t kMul1 = 0x85EBCA6Bu;
//: the second multiplier of the finalizer times 0x10001: bit 16 of the
//: product is bit 0 of the finalizer's output
constexpr uint32_t kMul2 = 0xC2B2AE35u * 0x10001u;

struct Stream {
  const int* tab;  // [>= max(n, 1), cols]
  int cols;        // 1 or 2
  int* out0;       // [T]
  int* out1;       // [T] with two columns
  float* weight;   // [T]
  int T, step_lo, dstep, n, per_cycle;
  const int* keys;  // [K, 64]
  const uint32_t* salts;
};

// ks: (key, key + n, salt ^ salt >> 16) as bit patterns; v, key < n < 2^31
__device__ __forceinline__ int swap_round(int v, int4 ks) {
  const uint32_t p = min((uint32_t)(ks.x - v), (uint32_t)ks.y - (uint32_t)v);
  const uint32_t x = max((uint32_t)v, p);
  uint32_t m = (x ^ (x >> 16) ^ (uint32_t)ks.z) * kMul1;
  m = (m ^ (m >> 13)) * kMul2;
  return (m & 0x10000u) ? (int)p : v;
}

// slots [span blockIdx.x, + span) of the stream, one a thread (span <=
// blockDim.x)
__global__ void __launch_bounds__(1024) stream_kernel(Stream a, int span) {
  __shared__ int4 sk[kStageRows * kRounds];  // (key, key + n, salt ^ salt >> 16, 0)
  const int b0 = blockIdx.x * span;
  const int bn = min(span, a.T - b0);
  if (bn <= 0) return;  // uniform across the block
  int c_lo = 0, n_rows = 1;
  if (a.per_cycle > 0) {
    c_lo = (a.step_lo + b0 / a.dstep) / a.per_cycle;
    n_rows = (a.step_lo + (b0 + bn - 1) / a.dstep) / a.per_cycle - c_lo + 1;
  }
  for (int q = threadIdx.x; q < n_rows * kRounds; q += blockDim.x) {
    const int k = a.keys[c_lo * kRounds + q];
    const uint32_t s = a.salts[c_lo * kRounds + q];
    sk[q] = make_int4(k, (int)((uint32_t)k + (uint32_t)a.n), (int)(s ^ (s >> 16)), 0);
  }
  const int t = b0 + min((int)threadIdx.x, bn - 1);
  const int i = t / a.dstep;
  int step = a.step_lo + i, kr = 0;
  if (a.per_cycle > 0) {
    const int cyc = step / a.per_cycle;
    step -= cyc * a.per_cycle;
    kr = (cyc - c_lo) * kRounds;
  }
  const int slot = step * a.dstep + (t - i * a.dstep);
  const bool valid = slot < a.n;
  int v = valid ? slot : 0;
  __syncthreads();
  if ((int)threadIdx.x >= bn) return;
  if (a.n > 1) {
    const int4* keys = sk + kr;
#pragma unroll 16
    for (int r = 0; r < kRounds; ++r) v = swap_round(v, keys[r]);
  } else {
    v = 0;
  }
  if (a.cols == 2) {
    const int2 row = __ldg((const int2*)a.tab + v);
    a.out0[t] = row.x;
    a.out1[t] = row.y;
  } else {
    a.out0[t] = __ldg(a.tab + v);
  }
  a.weight[t] = valid ? 1.0f : 0.0f;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return n;
}

// the most key rows a block of `span` slots can span
long long rows_spanned(long long span, int dstep, int per_cycle) {
  if (per_cycle <= 0) return 1;
  const long long steps = (span - 1) / dstep + 2;
  return (steps - 1) / per_cycle + 2;
}

}  // namespace

// One stream of [n_steps, dstep] slots (see above): out0 (and out1) =
// column 0 (and 1) of tab ([>= max(n, 1), cols] int32, 8-byte aligned with
// two columns) at each slot's permuted row, weight its validity; keys /
// salts: [n_keys, 64] int32 (salts as bit patterns), one row, or one per
// source cycle when per_cycle > 0
extern "C" int swap_or_not(const void* tab, int cols, void* out0, void* out1, void* weight,
                           int step_lo, int n_steps, int dstep, int n, int per_cycle,
                           const void* keys, const void* salts, int n_keys, void* stream) {
  const long long T = (long long)n_steps * dstep;
  if (n_steps < 0 || dstep <= 0 || step_lo < 0 || n < 0 || per_cycle < 0 || n_keys <= 0 ||
      T > INT_MAX || (long long)step_lo + n_steps > INT_MAX ||
      (long long)(per_cycle > 0 ? per_cycle : step_lo + n_steps) * dstep > INT_MAX ||
      (per_cycle > 0 && (step_lo + n_steps - 1) / per_cycle >= n_keys) ||
      (cols != 1 && cols != 2) || (cols == 2 && out1 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (cols == 2 && ((uintptr_t)tab & 7)) return (int)cudaErrorMisalignedAddress;
  if (T == 0) return (int)cudaGetLastError();
  const int n_sm = sm_count();
  if (n_sm <= 0) return (int)cudaErrorInvalidDevice;
  // w warps a scheduler in bps blocks an SM, one slot a thread
  const long long per_lane = (T + 128LL * n_sm - 1) / (128LL * n_sm);
  const long long bps = (per_lane + 7) / 8;
  const int threads = (int)(128 * ((per_lane + bps - 1) / bps));
  long long grid = n_sm * bps;
  long long span = (T + grid - 1) / grid;
  while (rows_spanned(span, dstep, per_cycle) > kStageRows && span > 1) {
    grid *= 2;
    span = (T + grid - 1) / grid;
  }
  grid = (T + span - 1) / span;
  Stream a{(const int*)tab, cols, (int*)out0, (int*)out1, (float*)weight, (int)T, step_lo,
           dstep, n, per_cycle, (const int*)keys, (const uint32_t*)salts};
  stream_kernel<<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(a, (int)span);
  return (int)cudaGetLastError();
}
