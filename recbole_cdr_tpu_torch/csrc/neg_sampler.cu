// K2: rejection-sampled uniform negatives against a padded history matrix.
//
// Replaces recbole_cdr_tpu/trainer/device_loop.py:205-325 _sample_negatives
// (uniform branch over a candidate list of at most two contiguous id runs,
// with _ranges_to_ids at :191): one uint32 base per slot, remixed by the
// murmur3 finalizer into R candidate ranks, ranks mapped to item ids by
// arithmetic, a dense compare against the user's history row, and the first
// round whose candidate is not in the history wins (round R-1 when none is
// clean). The heavy-user override stays in plain torch beside the call.
//
// Bound on an H100: integer compares. A slot compares its R = 16 candidates
// with every entry of its user's history row: R * H compares per slot against
// 4 * H bytes of the row, while the history matrix itself (the bytes the
// function must move) is read from L2 many times over. Design: one thread per
// slot holds its R candidates in registers and walks its row once, 16 bytes
// per load where the row width allows, folding each entry into an R-bit
// collision mask; the first clean round is one find-first-set on that mask.
//
// B2a, the popularity form (neg_sampling: {popularity: N}), replaces the alias
// branch of the same function (device_loop.py:250-268, buffers :378-387): a
// second uint32 stream per slot (JAX's fold_in(rng, 1)) is remixed by the
// same murmur3 finaliser; in round r the column rank = x_r % n is accepted if
// u01 = (y_r >> 8) * 2^-24 < prob[rank] (float32) or alias[rank] < 0, else
// alias[rank] is taken, and the candidate is values[chosen]. The history
// rejection is B2's. Given the same two base streams it is bit-exact with JAX
// and the plain version. Bound: bytes, as B2's; the three alias arrays (12
// bytes a distinct item) are read R times a slot, from L1 and L2 at the
// catalog sizes (a few MB), by three dependent gathers per round.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRounds = 16;
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t fmix32(uint32_t m) {
  m ^= m >> 16;
  m *= 0x85EBCA6Bu;
  m ^= m >> 13;
  m *= 0xC2B2AE35u;
  m ^= m >> 16;
  return m;
}

__device__ __forceinline__ uint32_t collide(int v, const int (&cand)[kRounds]) {
  uint32_t hit = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) hit |= (uint32_t)(v == cand[r]) << r;
  return hit;
}

// the popularity form's alias table: values [n] item ids, prob [n] float32
// acceptance, alias [n] (-1: always accept)
struct Alias {
  const uint32_t* accept;  // [total] the second base stream
  const int* values;
  const float* prob;
  const int* alias;
};

// base: [total] uint32 bits; uids: [B] (slot t belongs to uids[t % B]);
// hist: [U, H]; uniform (kAlias false): candidate ranks map to s0 + r
// (r < l0) else s1 + (r - l0); popularity: the alias draw over n_cand columns
template <bool kAlias>
__global__ void neg_sampler_kernel(const uint32_t* __restrict__ base,
                                   const int* __restrict__ uids, int B,
                                   const int* __restrict__ hist, int H,
                                   long long total, uint32_t n_cand, int s0,
                                   int l0, int s1, Alias al, int* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const uint32_t b = base[t];
  const uint32_t b2 = kAlias ? al.accept[t] : 0u;
  int cand[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int rank = (int)(fmix32(b + (uint32_t)r * 0x9E3779B9u) % n_cand);
    if (kAlias) {
      const uint32_t y = fmix32(b2 + (uint32_t)r * 0x9E3779B9u);
      const float u01 = (float)(y >> 8) * 5.9604644775390625e-08f;  // 2^-24, exact
      const int ali = __ldg(al.alias + rank);
      const bool take = u01 < __ldg(al.prob + rank) || ali < 0;
      cand[r] = __ldg(al.values + (take ? rank : ali));
    } else {
      cand[r] = rank < l0 ? s0 + rank : s1 + (rank - l0);
    }
  }
  const int* row = hist + (long long)uids[t % B] * H;
  uint32_t coll = 0;
  int h = 0;
  if ((H & 3) == 0 && ((uintptr_t)hist & 15) == 0) {
    const int4* row4 = reinterpret_cast<const int4*>(row);
    for (; h < H; h += 4) {
      const int4 q = row4[h >> 2];
      coll |= collide(q.x, cand) | collide(q.y, cand) | collide(q.z, cand) |
              collide(q.w, cand);
    }
  }
  for (; h < H; ++h) coll |= collide(row[h], cand);
  const uint32_t clean = ~coll & ((1u << kRounds) - 1u);
  const int pick = clean ? __ffs(clean) - 1 : kRounds - 1;
  int neg = cand[kRounds - 1];
#pragma unroll
  for (int r = kRounds - 2; r >= 0; --r)
    if (r == pick) neg = cand[r];
  out[t] = neg;
}

}  // namespace

extern "C" int neg_sampler(const void* base, const void* uids, int B,
                           const void* hist, int H, long long total,
                           unsigned n_cand, int s0, int l0, int s1, void* out,
                           void* stream) {
  if (total > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    neg_sampler_kernel<false><<<(unsigned)blocks, kThreads, 0,
                                (cudaStream_t)stream>>>(
        (const uint32_t*)base, (const int*)uids, B, (const int*)hist, H, total,
        n_cand, s0, l0, s1, Alias{}, (int*)out);
  }
  return (int)cudaGetLastError();
}

// B2a: base and accept [total] uint32 streams; values / prob / alias [n_cand]
extern "C" int neg_sampler_popularity(const void* base, const void* accept, const void* uids,
                                      int B, const void* hist, int H, long long total,
                                      const void* values, const void* prob, const void* alias,
                                      unsigned n_cand, void* out, void* stream) {
  if (total > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    const Alias al{(const uint32_t*)accept, (const int*)values, (const float*)prob,
                   (const int*)alias};
    neg_sampler_kernel<true><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)base, (const int*)uids, B, (const int*)hist, H, total, n_cand, 0, 0,
        0, al, (int*)out);
  }
  return (int)cudaGetLastError();
}
