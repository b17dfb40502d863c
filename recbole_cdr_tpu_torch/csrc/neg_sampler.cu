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
// Bound on an H100: integer compares. A slot compares its candidates with
// the live entries of its user's history row, while the history (the bytes
// the function must move) is read from L2 many times over. Each row's live
// entries are its first lens[u] (the rest is padding that never equals a
// candidate, or junk), so the walk stops there. Design: one thread per slot
// draws one round at a time and walks the live row once a round; the first
// clean round wins, so a slot whose first round is clean (nearly every
// slot: histories are short beside the candidate list; 1.001-1.015 rounds a
// slot at chip_smoke.py's streams) draws and compares one round, not R, and
// under popularity gathers one round's alias entries (probe_neg_sampler.py
// times this beside drawing 2, 4 or 16 rounds at once). A slot whose user's
// live history is at most kLaneWalk entries walks it alone, 16 bytes per
// load where the row width allows; the longer rows of a warp's slots are
// walked one at a time by the whole warp, each lane a stride of the row
// against the slot's candidate (broadcast by a shuffle), the lanes'
// collisions ORed by __reduce_or_sync, so the heaviest users' slots do not set
// the kernel's tail. The result is the first clean round of R (round R-1
// when none is clean), as before.
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
// the longest live history a slot walks alone; a longer one the warp walks
constexpr int kLaneWalk = 32;
constexpr unsigned kAll = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t fmix32(uint32_t m) {
  m ^= m >> 16;
  m *= 0x85EBCA6Bu;
  m ^= m >> 13;
  m *= 0xC2B2AE35u;
  m ^= m >> 16;
  return m;
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
// hist: [U, H]; lens: [U] the live entries of each row (nullptr: all H);
// uniform (kAlias false): candidate ranks map to s0 + r (r < l0) else s1 +
// (r - l0); popularity: the alias draw over n_cand columns. Every lane of a
// warp stays to the end: the long rows are walked by the whole warp.
template <bool kAlias>
__global__ void neg_sampler_kernel(const uint32_t* __restrict__ base,
                                   const int* __restrict__ uids, int B,
                                   const int* __restrict__ hist, int H,
                                   const int* __restrict__ lens, long long total,
                                   uint32_t n_cand, int s0, int l0, int s1, Alias al,
                                   int* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = t < total;
  const uint32_t b = live ? base[t] : 0u;
  const uint32_t b2 = kAlias && live ? al.accept[t] : 0u;
  const int user = live ? __ldg(uids + t % B) : 0;
  const int len = !live ? 0 : lens ? min(max(__ldg(lens + user), 0), H) : H;
  const int* row = hist + (long long)user * H;
  const bool vec = (H & 3) == 0 && ((uintptr_t)hist & 15) == 0;
  const int lane = threadIdx.x & 31;
  int neg = 0;
  bool done = !live;
  for (int r = 0; r < kRounds; ++r) {
    int cand = 0;
    bool coll = false;
    if (!done) {
      const int rank = (int)(fmix32(b + (uint32_t)r * 0x9E3779B9u) % n_cand);
      if (kAlias) {
        const uint32_t y = fmix32(b2 + (uint32_t)r * 0x9E3779B9u);
        const float u01 = (float)(y >> 8) * 5.9604644775390625e-08f;  // 2^-24, exact
        const int ali = __ldg(al.alias + rank);
        const bool take = u01 < __ldg(al.prob + rank) || ali < 0;
        cand = __ldg(al.values + (take ? rank : ali));
      } else {
        cand = rank < l0 ? s0 + rank : s1 + (rank - l0);
      }
      if (len <= kLaneWalk) {
        int h = 0;
        if (vec) {
          const int4* row4 = reinterpret_cast<const int4*>(row);
#pragma unroll 4
          for (; h + 4 <= len; h += 4) {
            const int4 q = __ldg(row4 + (h >> 2));
            coll |= q.x == cand || q.y == cand || q.z == cand || q.w == cand;
          }
        }
        for (; h < len; ++h) coll |= __ldg(row + h) == cand;
      }
    }
    for (unsigned wide = __ballot_sync(kAll, !done && len > kLaneWalk); wide;
         wide &= wide - 1) {
      const int owner = __ffs(wide) - 1;
      const int n = __shfl_sync(kAll, len, owner);
      const int* w = hist + (long long)__shfl_sync(kAll, user, owner) * H;
      const int c = __shfl_sync(kAll, cand, owner);
      unsigned m = 0;
      for (int h = lane; h < n; h += 32) m |= __ldg(w + h) == c;
      m = __reduce_or_sync(kAll, m);
      if (lane == owner) coll = m;
    }
    if (!done && (!coll || r == kRounds - 1)) {
      neg = cand;
      done = true;
    }
    if (!__any_sync(kAll, !done)) break;
  }
  if (live) out[t] = neg;
}

}  // namespace

// lens: int32 [U] live entries a row, or nullptr (every entry is live)
extern "C" int neg_sampler(const void* base, const void* uids, int B,
                           const void* hist, int H, const void* lens, long long total,
                           unsigned n_cand, int s0, int l0, int s1, void* out,
                           void* stream) {
  if (total > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    neg_sampler_kernel<false><<<(unsigned)blocks, kThreads, 0,
                                (cudaStream_t)stream>>>(
        (const uint32_t*)base, (const int*)uids, B, (const int*)hist, H, (const int*)lens,
        total, n_cand, s0, l0, s1, Alias{}, (int*)out);
  }
  return (int)cudaGetLastError();
}

// B2a: base and accept [total] uint32 streams; values / prob / alias [n_cand]
extern "C" int neg_sampler_popularity(const void* base, const void* accept, const void* uids,
                                      int B, const void* hist, int H, const void* lens,
                                      long long total, const void* values, const void* prob,
                                      const void* alias, unsigned n_cand, void* out,
                                      void* stream) {
  if (total > 0) {
    const long long blocks = (total + kThreads - 1) / kThreads;
    const Alias al{(const uint32_t*)accept, (const int*)values, (const float*)prob,
                   (const int*)alias};
    neg_sampler_kernel<true><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)base, (const int*)uids, B, (const int*)hist, H, (const int*)lens,
        total, n_cand, 0, 0, 0, al, (int*)out);
  }
  return (int)cudaGetLastError();
}
