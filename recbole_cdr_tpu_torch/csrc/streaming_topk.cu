// B5: streaming full-sort top-k with history masking, score product included.
//
// Replaces recbole_cdr_tpu/ops/topk.py:72-205 (streaming_topk_scores,
// _stream_topk_hist_local, _stream_topk_hist_pairs,
// streaming_topk_with_history and the merge of _merge_tile_topk, :48-69):
// for a user block U [B, D] against the item table T [I, D], the k best items
// of each row of U T^T, where column 0 (PAD) and each row's history items
// score finfo(float32).min and ties go to the lowest item id. The [B, I]
// score matrix is never written: at I = 1.1M and B = 2048 it would be 9 GB.
//
// Bound on an H100: tensor-core operations. The JAX reference scores in
// float32, so each product runs as 3xTF32: both operands split into a TF32
// high part (the top 19 bits) and the exact float32 rest, of which the tensor
// core reads the TF32 part, and hi*hi + hi*lo + lo*hi accumulate in float32
// (the dropped lo*lo term and the rest's cut are ~2^-21 of each product).
// That is 3 TF32 products per score, 3 x 2 B I D flops over 495 TFLOP/s:
// 1.75 ms for a [2048 x 64] tile against 1.1M items, where the table's bytes
// take 0.08 ms. mma.sync, used here, issues below that peak (wgmma fed by
// TMA is the full rate, not done yet). Integer-valued factors of small
// magnitude are exact in TF32 (zero rest), so they still score exactly and
// their ids match exactly.
//
// Design, three launches:
//   1. hash: the block's CSR history goes into an open-addressing set of
//      (row, item) keys in device memory (load factor <= 1/2), so a
//      candidate is tested for masking in O(1).
//   2. tile: grid (user-row block of kRows, item range); the ranges are few
//      and long, so the grid fills the SMs about once. The block splits its
//      user rows into TF32 hi/lo once, then walks its item range in tiles of
//      kCols items, each staged in kDepth-wide slices of D through a ring of
//      shared-memory stages filled by 16-byte cp.async (4-byte where D is not
//      a multiple of 4), so the next slice's copy overlaps this slice's MMAs.
//      D is zero-padded to the MMA depth (8) in shared memory. Eight warps
//      each own a 32 x 32 block of scores as mma.sync m16n8k8 tf32
//      accumulators, their fragments loaded by ldmatrix, the item side split
//      in registers by one logic op and one subtraction. At a tile's end each
//      thread tests its 32 scores straight from the registers against its
//      row's threshold (the row's current k-th best): a score that does not
//      beat it is dropped after one compare. Survivors go to a per-row buffer
//      of kCap entries in shared memory; when a buffer fills, one warp tests
//      its entries for PAD and the history set (one lane each; a masked one
//      scores finfo.min) and merges them with the row's exact top-k (k
//      entries, by k rounds of a warp argmax), and the threshold rises. The
//      test sits in the merge and not in the tile's epilogue because there a
//      probe of device memory held every warp of the block at its barrier
//      once per tile. At the range's end each row's top-k is the range's
//      candidates, written to cand [n_splits, B, k].
//   3. merge: one warp per row merges the n_splits * k candidates by the same
//      order (score desc, id asc) into ids [B, k] and their scores.
// A range with fewer than k items pads its candidates with (-inf, INT_MAX),
// which lose to every real column; k <= I makes them unreachable.
//
// B13, the bf16 form (eval_score_dtype or compute_dtype bfloat16; float16
// through the same template), in its Hopper design. Replaces the
// same JAX functions on bf16 factors, whose tile product is _score_dot
// (recbole_cdr_tpu/ops/topk.py:37-46) with preferred_element_type float32,
// as cast in evaluator/evaluator.py:511-531 and :593-595. bf16 x bf16
// products are exact in float32, so the card and JAX differ only in the
// order of the float32 sums. Bound: one tensor-core product per score, 2 B I
// D flops over the dense bf16 rate of 989 TFLOP/s (0.29 ms for [2048 x 64]
// against 1.1M items); the table's bytes take 0.04 ms.
// The first 16-bit form was B5's tile kernel on 16-bit values: mma.sync m16n8k16 with
// A reloaded by ldmatrix every k-step, 64 user rows a block (the table read
// 32 times from L2, 4.5 GB), and B5's selection, whose per-row buffers were
// shared by the 4 warp columns of a block: shared-memory atomics and two
// block barriers every 128 items. 3.88 ms, 13.3x its bound, the selection
// setting the pace. The tile kernel here (b13::tile16_kernel):
//   - warp specialisation: one producer warp keeps TMA loads
//     (cp.async.bulk.tensor, [64 items x 64 values] boxes, 128-byte swizzle)
//     in flight through a ring of 4-8 stages with full and empty mbarriers;
//     2 or 4 consumer warpgroups (launch plan) each issue wgmma.mma_async
//     m64n64k16 (float32 sums) on the stages that have arrived, their 64
//     user rows staged once per work item by TMA in the swizzled layout
//     wgmma reads, never reloaded. setmaxnreg moves registers from the
//     producer warpgroup to the consumers. Four consumer warpgroups (16
//     warps) hide more of the selection's latency than two, and make every
//     item tile fetched serve 256 users: the table crosses from L2 to the
//     SMs 8 times (1.13 GB) at B = 2048.
//   - the selection stays with the warp: in wgmma's accumulator layout each
//     of the 64 rows lies in one quad of lanes of one warp, so a row's
//     threshold (its current k-th best score and id) lives in registers and
//     its buffer (32 slots) in the warp's own rows of shared memory. A tile's
//     test is one max per row over the lane's 16 scores and one compare;
//     only where it reaches the threshold the exact (score desc, id asc)
//     test runs, survivors take slots by their quad's prefix sum, and a full
//     buffer is merged by the warp (k rounds of a redux.sync argmax), which
//     tests PAD and the history set there, as B5's merge does. No block
//     barrier runs inside the selection; while one warpgroup selects, the
//     tensor cores serve the others' products.
//   - a persistent grid of one block per SM walks (row block, item range)
//     work items, the row block fastest, so the blocks reading one item
//     range run together; one long range per block where the row blocks
//     allow, since a row's threshold rises over its range and the fewer
//     ranges, the fewer survivors.
// Widths whose rows TMA cannot address (D % 8 != 0) stage the boxes
// element-wise in the same kernel (the kTma template flag), and D is
// zero-filled to the k16 depth; a range with fewer than k items pads with
// (-inf, INT_MAX).

// B14, the local stage and merge of the mesh-sharded streaming top-k.
// Replaces recbole_cdr_tpu/ops/topk.py:208-269 (make_sharded_streaming_topk),
// whose local stage is _stream_topk_hist_local (:107-147) on a shard of the
// item table at the shard's column offset, and whose merge of the m gathered
// [B, k] lists is the top_k of :253-258. Local stage: the tile kernel above
// (either type) with the ids of its columns shifted by col_offset, so that
// PAD is global column 0, a row's CSR history is matched by global id, and
// the candidates carry global ids; the caller hands it only the shard's rows
// below the total item count, so the pad rows of the last shard never enter
// (a shard with fewer than k such rows pads its list with (-inf, INT_MAX), as
// a short range does). Between the stages the lists travel by an all_gather
// over the model group, outside the kernels. On 16-bit factors the local
// stage is B13's tile kernel at the same offset. Merge (rank_merge_kernel):
// the k best of the [m, B, k] lists, each sorted by (score desc, id asc) as
// the local stage writes it, in shard order, whose ids ascend with the shard.
// The stable order of the lists concatenated in shard order (JAX's top_k,
// and ties to the lowest global id, as in one top-k over the whole row) puts
// candidate (l, r, s), rank r of list l, at
//   r + sum over l' < l of #{s' >= s in l'} + sum over l' > l of #{s' > s in l'},
// each count one binary search of the sorted list l'. One thread places one
// candidate: no step waits on another, and a candidate whose place is below
// k is written there (the places of sorted lists are a permutation of [0, m
// k)). Bound: bytes, the lists read once and [B, k] written once; the
// kernel's time is its launch and one dependent round trip to memory. A
// block stages its rows' lists once in shared memory, as integer keys of the
// scores' order, so that a search step is one compare.

#include <cfloat>
#include <climits>
#include <cmath>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpsM = 2;                 // warp rows of a block, 32 user rows each
constexpr int kWarpsN = kWarps / kWarpsM;  // warp columns
constexpr int kNT = 4;                     // 8-item MMA fragments per warp and tile
constexpr int kRows = 32 * kWarpsM;        // user rows per block
constexpr int kCols = kWarpsN * 8 * kNT;   // items per tile
constexpr int kCap = 32;                   // survivor buffer per row
constexpr int kMaxSmem = 227 * 1024;
constexpr unsigned long long kEmpty = ~0ull;

// the factors' type: B5 scores float32 factors in 3xTF32, B13 bf16 (and
// float16) factors in one 16-bit product
enum : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

// B5's layout in floats. A ring stage holds 128 bytes of D per item (32
// floats) at a row stride of 144 bytes (36 words, 4 mod 8: conflict-free
// ldmatrix rows); the user rows pad D to the MMA depth plus 16 bytes, the
// same property
struct Layout {
  static constexpr int kBytes = 4;
  static constexpr int kVals16 = 4;              // values per 16 bytes
  static constexpr int kMmaK = 8;                // MMA depth (tf32)
  static constexpr int kDepth = 32;              // values of D per ring stage
  static constexpr int kTStride = kDepth + kVals16;  // stage row stride
  static constexpr int kUserArrays = 2;          // TF32 hi and lo
  __host__ __device__ static int pad(int D) { return (D + kMmaK - 1) / kMmaK * kMmaK; }
  __host__ __device__ static int ust(int D) { return pad(D) + kVals16; }
};

size_t tile_smem_bytes(int D, int k, int stages) {
  using L = Layout;
  return (size_t)L::kBytes * ((size_t)L::kUserArrays * kRows * L::ust(D) +
                              (size_t)stages * kCols * L::kTStride) +
         8 * ((size_t)kRows * k + (size_t)kRows * kCap) + 12 * (size_t)kRows;
}

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// ---- the history set ------------------------------------------------------

__device__ __forceinline__ unsigned slot_of(unsigned long long key, int bits) {
  return (unsigned)((key * 0x9E3779B97F4A7C15ull) >> (64 - bits));
}

__device__ __forceinline__ unsigned long long hist_key(int row, int item) {
  return ((unsigned long long)(unsigned)row << 32) | (unsigned)item;
}

__global__ void __launch_bounds__(kThreads)
hash_build_kernel(const int* __restrict__ row_ptr, const int* __restrict__ items, int B,
                  unsigned long long* __restrict__ table, int bits) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;
  const unsigned mask = (1u << bits) - 1;
  const int p_end = row_ptr[row + 1];
  for (int p = row_ptr[row] + lane; p < p_end; p += 32) {
    const unsigned long long key = hist_key(row, items[p]);
    for (unsigned s = slot_of(key, bits);; s = (s + 1) & mask) {
      const unsigned long long old = atomicCAS(table + s, kEmpty, key);
      if (old == kEmpty || old == key) break;
    }
  }
}

__device__ __forceinline__ bool in_history(const unsigned long long* __restrict__ table,
                                           int bits, int row, int item) {
  const unsigned long long key = hist_key(row, item);
  const unsigned mask = (1u << bits) - 1;
  for (unsigned s = slot_of(key, bits);; s = (s + 1) & mask) {
    const unsigned long long v = __ldg(table + s);
    if (v == key) return true;
    if (v == kEmpty) return false;
  }
}

// ---- copies and tensor-core products --------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo exactly: hi is x cut to TF32 (its top 19 bits, one logic op,
// where cvt.rna.tf32 runs at a fraction of the ALU rate), lo the exact float32
// rest, of which the tensor core reads the TF32 part: hi + lo as the MMA
// sees it is x within 2^-21 |x|
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// four 8 x 4 fragments of 32-bit words from shared memory, one row address
// per lane (lanes 8 j .. 8 j + 7 give matrix j's rows)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- per-row top-k in shared memory ----------------------------------------

struct Lists {
  float* ls;     // [kRows][k] each row's top-k, best first
  int* li;
  float* bs;     // [kRows][kCap] survivors not merged yet
  int* bi;
  float* thr_s;  // [kRows] the row's k-th best: the bar to enter
  int* thr_i;
  int* cnt;      // [kRows] survivors buffered (may pass kCap: the rest wait)
};

// One warp per row whose buffer is full (or, with ``force``, not empty):
// the buffered survivors test PAD and the history set (one lane each; a
// masked one scores finfo.min), then the row's k best of its list and its
// buffer by k rounds of a warp argmax.
__device__ void merge_rows(const Lists& L, int k, bool force,
                           const unsigned long long* __restrict__ table, int bits, int r0) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kRows; r += kWarps) {
    const int c = L.cnt[r];
    if (force ? c == 0 : c < kCap) continue;  // uniform across the warp
    const int n = min(c, kCap);
    float v[3];
    int id[3];
    v[0] = lane < k ? L.ls[r * k + lane] : -INFINITY;
    id[0] = lane < k ? L.li[r * k + lane] : INT_MAX;
    v[1] = lane + 32 < k ? L.ls[r * k + lane + 32] : -INFINITY;
    id[1] = lane + 32 < k ? L.li[r * k + lane + 32] : INT_MAX;
    v[2] = lane < n ? L.bs[r * kCap + lane] : -INFINITY;
    id[2] = lane < n ? L.bi[r * kCap + lane] : INT_MAX;
    if (lane < n && (id[2] == 0 || in_history(table, bits, r0 + r, id[2]))) v[2] = -FLT_MAX;
    __syncwarp();
    for (int q = 0; q < k; ++q) {
      float bv = v[0];
      int bid = id[0];
#pragma unroll
      for (int e = 1; e < 3; ++e)
        if (better(v[e], id[e], bv, bid)) {
          bv = v[e];
          bid = id[e];
        }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bid, off);
        if (better(ov, oi, bv, bid)) {
          bv = ov;
          bid = oi;
        }
      }
      if (lane == 0) {
        L.ls[r * k + q] = bv;
        L.li[r * k + q] = bid;
      }
#pragma unroll
      for (int e = 0; e < 3; ++e)  // ids are unique but for the padding
        if (id[e] == bid && v[e] == bv) {
          v[e] = -INFINITY;
          id[e] = INT_MAX;
        }
    }
    if (lane == 0) {
      L.thr_s[r] = L.ls[r * k + k - 1];
      L.thr_i[r] = L.li[r * k + k - 1];
      L.cnt[r] = 0;
    }
    __syncwarp();
  }
}

template <bool kVec, int kStages>
__global__ void __launch_bounds__(kThreads, 2)
tile_topk_kernel(const float* __restrict__ U, const float* __restrict__ T, int B, int I, int D,
                 int span, int k, const unsigned long long* __restrict__ table, int bits,
                 int col_offset, float* __restrict__ cand_s, int* __restrict__ cand_i) {
  using Lay = Layout;
  using Val = float;
  constexpr int kDepth = Lay::kDepth, kTStride = Lay::kTStride, kV16 = Lay::kVals16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = Lay::pad(D), ust = Lay::ust(D);
  // [kRows][ust] TF32 high parts, then residuals
  uint32_t* uh = reinterpret_cast<uint32_t*>(smem);
  uint32_t* ul = uh + kRows * ust;
  Val* ring = reinterpret_cast<Val*>(ul + kRows * ust);  // [kStages][kCols][kTStride]
  Lists L;
  L.ls = reinterpret_cast<float*>(ring + kStages * kCols * kTStride);
  L.li = reinterpret_cast<int*>(L.ls + kRows * k);
  L.bs = reinterpret_cast<float*>(L.li + kRows * k);
  L.bi = reinterpret_cast<int*>(L.bs + kRows * kCap);
  L.thr_s = reinterpret_cast<float*>(L.bi + kRows * kCap);
  L.thr_i = reinterpret_cast<int*>(L.thr_s + kRows);
  L.cnt = L.thr_i + kRows;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // fragment row / column group
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;  // its 32 x 8 kNT block of a tile
  const int r0 = blockIdx.x * kRows;
  const int lo = blockIdx.y * span;
  const int hi = min(I, lo + span);

  // ---- the user rows, split once; empty lists -----------------------------
  for (int r = warp; r < kRows; r += kWarps)
    for (int d = lane; d < Dp; d += 32) {
      const bool in = r0 + r < B && d < D;
      split(in ? __ldg(U + (long long)(r0 + r) * D + d) : 0.f, uh[r * ust + d],
            ul[r * ust + d]);
    }
  for (int e = tid; e < kRows * k; e += kThreads) {
    L.ls[e] = -INFINITY;
    L.li[e] = INT_MAX;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    L.thr_s[r] = -INFINITY;
    L.thr_i[r] = INT_MAX;
    L.cnt[r] = 0;
  }

  const int n_tiles = hi > lo ? (hi - lo + kCols - 1) / kCols : 0;
  const int nk = (Dp + kDepth - 1) / kDepth;  // ring stages per tile
  const int total = n_tiles * nk;

  // stage (tile, slice) of the walk into ring buffer ``buf``; items past the
  // range and columns past D are zero-filled
  int is_tile = 0, is_kc = 0;
  auto issue = [&](int buf) {
    Val* dst = ring + buf * kCols * kTStride;
    const int item0 = lo + is_tile * kCols, c0 = is_kc * kDepth;
    if (kVec) {
      constexpr int kPieces = kDepth / kV16;  // 16-byte pieces of a staged row
      const int q = tid % kPieces, col = c0 + kV16 * q;
      for (int r = tid / kPieces; r < kCols; r += kThreads / kPieces) {
        const bool ok = item0 + r < hi && col < D;
        cp_async16(dst + r * kTStride + kV16 * q, ok ? T + (long long)(item0 + r) * D + col : T,
                   ok ? 16 : 0);
      }
    } else {
      for (int r = warp; r < kCols; r += kWarps)
        for (int cc = lane; cc < kDepth; cc += 32) {
          const bool ok = item0 + r < hi && c0 + cc < D;
          cp_async4(dst + r * kTStride + cc,
                    ok ? T + (long long)(item0 + r) * D + c0 + cc : T, ok ? 4 : 0);
        }
    }
    if (++is_kc == nk) {
      is_kc = 0;
      ++is_tile;
    }
  };

  // per-lane ldmatrix offsets: A rows (g, g + 8) x columns (0-3, 4-7) of a
  // 16-row slab; B, two 8-item fragments of kt 0-3 and 4-7 per x4 load
  const int a_off = (wm * 32 + (lane & 7) + ((lane >> 3) & 1) * 8) * ust + (lane >> 4) * kV16;
  const int b_off =
      (wn * 8 * kNT + (lane & 7) + (lane >> 4) * 8) * kTStride + ((lane >> 3) & 1) * kV16;

  float acc[2][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) issue(s);
    cp_commit();
  }
  int tile = 0, kc = 0;
  for (int it = 0; it < total; ++it) {
    cp_wait<kStages - 2>();
    __syncthreads();  // stage ``it`` landed; every thread is done with stage it - 1
    if (it + kStages - 1 < total) issue((it + kStages - 1) % kStages);
    cp_commit();

    const Val* tb = ring + (it % kStages) * kCols * kTStride;
    const int c0 = kc * kDepth;
    constexpr int kK = Lay::kMmaK;
    const int steps = min(kDepth, Dp - c0) / kK;
#pragma unroll
    for (int ks = 0; ks < kDepth / kK; ++ks) {
      if (ks >= steps) break;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldsm4(ah[mt], uh + a_off + mt * 16 * ust + c0 + 8 * ks);
        ldsm4(al[mt], ul + a_off + mt * 16 * ust + c0 + 8 * ks);
      }
      uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t raw[4];
        ldsm4(raw, tb + b_off + np * 16 * kTStride + 8 * ks);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(__uint_as_float(raw[e]), bh[2 * np + (e >> 1)][e & 1],
                bl[2 * np + (e >> 1)][e & 1]);
      }
      // small terms first; each pass runs 2 kNT independent MMAs, so a
      // tile's three products never wait on each other back to back
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma(acc[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma(acc[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma(acc[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
    }
    if (++kc < nk) continue;

    // ---- the tile's scores are complete: select from the registers --------
    kc = 0;
    const int item0 = lo + tile * kCols + wn * 8 * kNT + 2 * t;  // this thread's first column
    ++tile;
    float ts[4];
    int ti[4];
    auto load_thresholds = [&]() {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rl = wm * 32 + (q >> 1) * 16 + g + 8 * (q & 1);
        ts[q] = L.thr_s[rl];
        ti[q] = L.thr_i[rl];
      }
    };
    load_thresholds();
    // bit (mt, nt, e): that score still wants a buffer slot
    unsigned long long pend = 0;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = mt * 2 + (e >> 1);
          const int row = r0 + wm * 32 + mt * 16 + g + 8 * (e >> 1);
          const int id = item0 + nt * 8 + (e & 1);
          if (row < B && id < hi && better(acc[mt][nt][e], col_offset + id, ts[q], ti[q]))
            pend |= 1ull << ((mt * kNT + nt) * 4 + e);
        }
    while (true) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const unsigned long long bit = 1ull << ((mt * kNT + nt) * 4 + e);
            if (!(pend & bit)) continue;
            const int q = mt * 2 + (e >> 1);
            const int rl = wm * 32 + mt * 16 + g + 8 * (e >> 1);
            const int id = col_offset + item0 + nt * 8 + (e & 1);  // global id
            const float s = acc[mt][nt][e];
            if (!better(s, id, ts[q], ti[q])) {  // the bar rose meanwhile
              pend &= ~bit;
              continue;
            }
            const int pos = atomicAdd(L.cnt + rl, 1);
            if (pos < kCap) {
              L.bs[rl * kCap + pos] = s;
              L.bi[rl * kCap + pos] = id;
              pend &= ~bit;
            }
          }
      if (!__syncthreads_or(pend != 0)) break;
      merge_rows(L, k, false, table, bits, r0);  // full buffers: raise those thresholds
      __syncthreads();
      load_thresholds();
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }
  cp_wait<0>();
  __syncthreads();
  merge_rows(L, k, true, table, bits, r0);
  __syncthreads();
  for (int r = warp; r < kRows; r += kWarps) {
    if (r0 + r >= B) break;
    const long long at = ((long long)blockIdx.y * B + r0 + r) * k;
    for (int q = lane; q < k; q += 32) {
      cand_s[at + q] = L.ls[r * k + q];
      cand_i[at + q] = L.li[r * k + q];
    }
  }
}

// ---- the merge of the ranges' candidates ----------------------------------

template <int K>
__device__ __forceinline__ void insert(float (&vals)[K], int (&idxs)[K], float v, int i) {
  if (!better(v, i, vals[K - 1], idxs[K - 1])) return;
  vals[K - 1] = v;
  idxs[K - 1] = i;
#pragma unroll
  for (int q = K - 1; q > 0; --q) {
    if (better(vals[q], idxs[q], vals[q - 1], idxs[q - 1])) {
      const float tv = vals[q];
      vals[q] = vals[q - 1];
      vals[q - 1] = tv;
      const int tix = idxs[q];
      idxs[q] = idxs[q - 1];
      idxs[q - 1] = tix;
    }
  }
}

template <int K>
__device__ __forceinline__ void pop_front(float (&vals)[K], int (&idxs)[K]) {
#pragma unroll
  for (int q = 0; q < K - 1; ++q) {
    vals[q] = vals[q + 1];
    idxs[q] = idxs[q + 1];
  }
  vals[K - 1] = -INFINITY;
  idxs[K - 1] = INT_MAX;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ cand_s, const int* __restrict__ cand_i, int B,
             int n_splits, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;  // uniform across the warp
  float vals[K];
  int idxs[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    vals[q] = -INFINITY;
    idxs[q] = INT_MAX;
  }
  for (int s = 0; s < n_splits; ++s) {
    const long long at = ((long long)s * B + row) * k;
    for (int q = lane; q < k; q += 32) insert<K>(vals, idxs, cand_s[at + q], cand_i[at + q]);
  }
  for (int r = 0; r < k; ++r) {
    float bv = vals[0];
    int bi = idxs[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      out_s[(long long)row * k + r] = bv;
      out_i[(long long)row * k + r] = bi;
    }
    if (idxs[0] == bi) pop_front<K>(vals, idxs);
  }
}

// ---- B14's merge: every candidate placed by its rank ------------------

constexpr int kMergeThreads = 256;

// a float's order as a signed int (x < y iff key(x) < key(y); -0 as +0)
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x + 0.0f);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

// block (k, lists, rows): thread (r, l, rb) holds rank r of list l of row
// row0 + rb (lists beyond blockDim.y wrap) and adds to r, for each of the m
// - 1 other lists, how many of its leading entries come before it: s' >= s
// from an earlier list (ties to the earlier list), s' > s from a later one,
// that is key(s') > key(s) - 1 or key(s') > key(s). Each count is a binary
// search by steps of 2^kLog down to 1 (2^kLog <= k < 2^(kLog + 1)) over the
// lists' keys staged in shared memory, padded to 2^(kLog + 1) entries with
// INT_MIN, free of branches so that a warp's lanes never diverge
template <int kLog>
__global__ void __launch_bounds__(1024)
rank_merge_kernel(const float* __restrict__ cand_s, const int* __restrict__ cand_i, int B, int m,
                  int k, float* __restrict__ out_s, int* __restrict__ out_i) {
  constexpr int kPad = 2 << kLog;
  extern __shared__ int merge_keys[];  // [m][rows][kPad]
  const int rows = blockDim.z, r = threadIdx.x, rb = threadIdx.z;
  const int row = blockIdx.x * rows + rb;
  float v0 = 0.0f;  // the thread's first candidate, kept from staging
  int id0 = 0;
  for (int l = threadIdx.y; l < m && row < B; l += blockDim.y) {
    const long long at = ((long long)l * B + row) * k + r;
    const float s = cand_s[at];
    if (l == (int)threadIdx.y) {
      v0 = s;
      id0 = cand_i[at];
    }
    int* list = merge_keys + (l * rows + rb) * kPad;
    list[r] = order_key(s);
    if (k + r < kPad) list[k + r] = INT_MIN;
  }
  __syncthreads();
  for (int l = threadIdx.y; l < m && row < B; l += blockDim.y) {
    const long long at = ((long long)l * B + row) * k + r;
    const bool first = l == (int)threadIdx.y;
    const float v = first ? v0 : cand_s[at];
    const int key = order_key(v);
    int place = r;
    for (int j = 0; j < m - 1; ++j) {  // the same trips in every lane
      const int l2 = j + (j >= l);       // skips list l
      const int* other = merge_keys + (l2 * rows + rb) * kPad;
      const int above = l2 < l ? key - 1 : key;
      int lo = 0;
#pragma unroll
      for (int step = 1 << kLog; step > 0; step >>= 1) lo += other[lo + step - 1] > above ? step : 0;
      place += lo;
    }
    if (place < k) {
      out_s[(long long)row * k + place] = v;
      out_i[(long long)row * k + place] = first ? id0 : cand_i[at];
    }
  }
}

int rank_merge_launch(const float* cs, const int* ci, int B, int m, int k, float* os, int* oi,
                      cudaStream_t st) {
  int lg = 0;
  while ((2 << lg) <= k) ++lg;  // 2^lg <= k < 2^(lg + 1)
  const int lists = min(m, 1024 / k);
  const int rows = max(1, min(kMergeThreads / (m * k), 64));
  const size_t smem = (size_t)rows * m * (2 << lg) * 4;
  const dim3 grid((B + rows - 1) / rows), block(k, lists, rows);
  switch (lg) {
#define B14_MERGE(L)                                                            \
  case L:                                                                       \
    rank_merge_kernel<L><<<grid, block, smem, st>>>(cs, ci, B, m, k, os, oi); \
    break;
    B14_MERGE(0)
    B14_MERGE(1)
    B14_MERGE(2)
    B14_MERGE(3)
    B14_MERGE(4)
    B14_MERGE(5)
    B14_MERGE(6)
#undef B14_MERGE
  }
  return (int)cudaGetLastError();
}

// ---- B13: the 16-bit tile kernel on wgmma fed by TMA -------------------

namespace b13 {

constexpr int kN = 64;                // items of a tile: the wgmma N
constexpr int kAcc = kN / 2;          // float32 sums per thread of an m64 tile
constexpr int kBoxVals = 64;          // values of D in one 128-byte swizzled row
constexpr int kBoxBytes = kN * 128;   // one item box of a ring stage
constexpr int kCap16 = 32;            // survivor slots of a row's buffer

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one TMA load of a 2-D box at (x, y) into shared memory, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// the wgmma descriptor of a K-major operand in 128-byte swizzled rows (8-row
// atoms of 1,024 bytes, the atom 1,024-byte aligned), advanced by ``kstep``
// depth steps of 32 bytes
__device__ __forceinline__ uint64_t sw128_desc(const void* p, int kstep) {
  const uint32_t a = smem_u32(p) + 32 * kstep;
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// D[64 x kN] (+)= A[64 x 16] B[kN x 16]^T, 16-bit operands, float32 sums
template <int kType>
__device__ __forceinline__ void wgmma_tile(float (&d)[kAcc], uint64_t a, uint64_t b,
                                           int accumulate) {
  if constexpr (kType == kBF16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of accumulators across the
// asynchronous product that writes them
__device__ __forceinline__ void fence_acc(float (&acc)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The element-wise staging of a box (widths whose rows TMA cannot address):
// rows [row0, row0 + nrows) x values [col0, col0 + 64) of ``src`` [limit, D]
// into ``dst`` in the 128-byte swizzle TMA writes, zeros outside; one warp
__device__ void stage_box(unsigned char* dst, const uint16_t* __restrict__ src, int row0,
                          int nrows, int limit, int col0, int D) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < nrows * kBoxVals; e += 32) {
    const int r = e / kBoxVals, c = e % kBoxVals;
    const bool ok = row0 + r < limit && col0 + c < D;
    const uint16_t v = ok ? __ldg(src + (long long)(row0 + r) * D + col0 + c) : (uint16_t)0;
    *reinterpret_cast<uint16_t*>(dst + r * 128 + ((((2 * c) >> 4) ^ (r & 7)) << 4) +
                                 ((2 * c) & 15)) = v;
  }
}

// an unsigned key in the order of the floats (-0 and +0 equal)
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// One warp merges one row as merge_rows does (PAD and the history set
// tested in the buffer of n <= 64 survivors, then k rounds), each round's
// argmax one max and one min reduction (redux.sync) in place of ten shuffles
__device__ void merge_row16(float* ls, int* li, const float* bs, const int* bi, int n, int k,
                            const unsigned long long* __restrict__ table, int bits, int row,
                            float& ks, int& ki) {
  const int lane = threadIdx.x & 31;
  float v[4];
  int id[4];
  v[0] = lane < k ? ls[lane] : -INFINITY;
  id[0] = lane < k ? li[lane] : INT_MAX;
  v[1] = lane + 32 < k ? ls[lane + 32] : -INFINITY;
  id[1] = lane + 32 < k ? li[lane + 32] : INT_MAX;
#pragma unroll
  for (int e = 2; e < 4; ++e) {
    const int j = lane + 32 * (e - 2);
    v[e] = j < n ? bs[j] : -INFINITY;
    id[e] = j < n ? bi[j] : INT_MAX;
    if (j < n && (id[e] == 0 || in_history(table, bits, row, id[e]))) v[e] = -FLT_MAX;
  }
  __syncwarp();
  for (int q = 0; q < k; ++q) {
    float bv = v[0];
    int bid = id[0];
#pragma unroll
    for (int e = 1; e < 4; ++e)
      if (better(v[e], id[e], bv, bid)) {
        bv = v[e];
        bid = id[e];
      }
    const unsigned key = order_key(bv);
    const unsigned m = __reduce_max_sync(0xffffffffu, key);
    const int wid = (int)__reduce_min_sync(0xffffffffu, key == m ? (unsigned)bid : 0xffffffffu);
    const unsigned at = __ballot_sync(0xffffffffu, key == m && bid == wid);
    bv = __shfl_sync(0xffffffffu, bv, __ffs(at) - 1);
    bid = wid;
    if (lane == 0) {
      ls[q] = bv;
      li[q] = bid;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)  // ids are unique but for the padding
      if (id[e] == bid && v[e] == bv) {
        v[e] = -INFINITY;
        id[e] = INT_MAX;
      }
    ks = bv;
    ki = bid;
  }
  __syncwarp();
}

// what a consumer warp's selection reads: its rows' lists and buffers
// (shared memory), the history set, the call's shape
struct Sel {
  float* ls;  // [rows][k], best first
  int* li;
  float* bs;  // [rows][kCap16 + 1]: an odd row stride, so the quads' rows take other banks
  int* bi;
  const unsigned long long* table;
  int bits, k, r0, hi, off;
  int row_base;  // the block row of the warp's first row: its 16-row slab
};

// the block row of this lane's row r (rows g and g + 8 of the warp's slab)
__device__ __forceinline__ int sel_row(const Sel& S, int r, int g) {
  return S.row_base + r * 8 + g;
}

// One tile's products: for every box of D a full stage, four k16 steps of
// wgmma per m-tile (A: the warpgroup's user rows, B: the stage's items)
template <int kType, int kWG>
__device__ __forceinline__ void issue_tile(float (&acc)[kAcc], const unsigned char* users,
                                           const unsigned char* ring, uint64_t* full, int nb,
                                           int D, int stages, int& s, uint32_t& ph) {
  wgmma_fence();
  for (int b = 0; b < nb; ++b) {
    mbar_wait(full + s, ph);
    const unsigned char* box = ring + (size_t)s * kBoxBytes;
    const unsigned char* ub = users + (size_t)b * 64 * kWG * 128;  // [rows][128 B] per box
    const int ksteps = min(4, (D - b * kBoxVals + 15) / 16);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk >= ksteps) break;
      wgmma_tile<kType>(acc, sw128_desc(ub, kk), sw128_desc(box, kk), (b | kk) != 0);
    }
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
  }
  wgmma_commit();
}

// this lane's score jb (tile column 8 (jb >> 1) + 2 q + (jb & 1)) of row r
__device__ __forceinline__ float score_of(const float (&acc)[kAcc], int r, int jb) {
  return acc[4 * (jb >> 1) + 2 * (r & 1) + (jb & 1)];
}

// bit jb: this lane's score jb of row r beats the row's threshold (score
// desc, id asc): a greater score, or an equal one of a lower id; ``edge``:
// the tile passes the range's end, whose columns never compete
__device__ __forceinline__ uint32_t survivors(const float (&acc)[kAcc], int r, int c0,
                                              int hi, int off, float ts, int ti, bool edge) {
  uint32_t gt = 0, eq = 0;
#pragma unroll
  for (int jb = 0; jb < kN / 4; ++jb) {
    const float v = score_of(acc, r, jb);
    gt |= (uint32_t)(v > ts) << jb;
    eq |= (uint32_t)(v == ts) << jb;
  }
  for (; eq; eq &= eq - 1) {  // ties with the threshold: rare
    const int jb = __ffs(eq) - 1;
    if (off + c0 + 8 * (jb >> 1) + (jb & 1) < ti) gt |= 1u << jb;
  }
  if (edge)
#pragma unroll
    for (int jb = 0; jb < kN / 4; ++jb)
      if (c0 + 8 * (jb >> 1) + (jb & 1) >= hi) gt &= ~(1u << jb);
  return gt;
}

// The warp merges each of its rows whose buffer is full (with ``force``: not
// empty); the quad that holds the row takes its new threshold. cnt: the
// quad's buffer count of each of its rows, in registers
__device__ __forceinline__ void merge_full(const Sel& S, float (&ts)[2], int (&ti)[2],
                                           int (&cnt)[2], bool force) {
  const int g = (threadIdx.x & 31) >> 2;
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r)
    for (int gq = 0; gq < 8; ++gq) {
      const int c = __shfl_sync(0xffffffffu, cnt[r], 4 * gq);
      if (force ? c == 0 : c < kCap16) continue;  // uniform across the warp
      const int lr = sel_row(S, r, gq);
      float ks;
      int ki;
      merge_row16(S.ls + lr * S.k, S.li + lr * S.k, S.bs + lr * (kCap16 + 1),
                  S.bi + lr * (kCap16 + 1), c, S.k, S.table, S.bits, S.r0 + lr, ks, ki);
      if (g == gq) {
        cnt[r] = 0;
        ts[r] = ks;
        ti[r] = ki;
      }
    }
}

// Row r's survivors ``pend`` of this lane into the row's buffer: slots by
// the quad's prefix (two shuffles), stores from the registers; the ones past
// the buffer's end stay in ``pend``. Returns whether the buffer overflowed
__device__ __forceinline__ bool push_row(const float (&acc)[kAcc], const Sel& S, int r,
                                         int c0, uint32_t& pend, int& cnt) {
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int n = __popc(pend);
  int incl = n;
#pragma unroll
  for (int d = 1; d < 4; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d, 4);
    if (q >= d) incl += o;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 3, 4);
  const int lr = sel_row(S, r, lane >> 2);
  float* bs = S.bs + lr * (kCap16 + 1);
  int* bi = S.bi + lr * (kCap16 + 1);
  int slot = cnt + incl - n;  // this lane's survivors take slots in column order
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const uint32_t two = (pend >> (2 * j)) & 3u;
    if (!two) continue;  // most pairs: one test
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if ((two >> e) & 1u) {
        if (slot < kCap16) {
          bs[slot] = acc[4 * j + 2 * (r & 1) + e];
          bi[slot] = S.off + c0 + 8 * j + e;
          pend &= ~(1u << (2 * j + e));
        }
        ++slot;
      }
  }
  const bool over = cnt + total > kCap16;
  cnt = min(kCap16, cnt + total);
  return over;
}

// The selection of one tile from the accumulators, warp-private: one max
// per row and lane over the lane's 16 scores and one compare against the
// row's threshold (registers); only where a max reaches it the exact (score
// desc, id asc) test, survivors compacted into the row's buffer; full
// buffers merged by the warp (__syncwarp only), the survivors still waiting
// tested again against the risen thresholds. No block barrier.
__device__ __forceinline__ void select_tile(const float (&acc)[kAcc], float (&ts)[2],
                                            int (&ti)[2], int (&cnt)[2],
                                            const Sel& S, int it0) {
  constexpr int kR = 2;  // rows g and g + 8 of the lane's m64 tile
  const int q = threadIdx.x & 3;
  uint32_t rows = 0;  // bit r: this lane's max of row r reaches the threshold
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
      m = fmaxf(m, fmaxf(acc[4 * j + 2 * (r & 1)], acc[4 * j + 2 * (r & 1) + 1]));
    if (m >= ts[r]) rows |= 1u << r;
  }
  if (!__any_sync(0xffffffffu, rows != 0)) return;
  const int c0 = it0 + 2 * q;
  const bool edge = it0 + kN > S.hi;
  uint32_t pend[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r)
    pend[r] = (rows >> r) & 1u ? survivors(acc, r, c0, S.hi, S.off, ts[r], ti[r], edge) : 0u;
  while (true) {
    bool over = false;
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (__any_sync(0xffffffffu, pend[r] != 0)) over |= push_row(acc, S, r, c0, pend[r], cnt[r]);
    if (!__any_sync(0xffffffffu, over)) break;
    merge_full(S, ts, ti, cnt, false);
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (pend[r]) pend[r] &= survivors(acc, r, c0, S.hi, S.off, ts[r], ti[r], edge);
  }
}

// B13's shared memory: the user rows (one [rows x 128 B] swizzled box per 64
// values of D), the ring of item boxes, the rows' lists and buffers, the
// barriers; offsets from a 1,024-byte aligned base
__host__ __device__ inline size_t smem16_bytes(int wgs, int nb, int stages, int k) {
  const size_t rows = 64 * (size_t)wgs;
  return (size_t)nb * rows * 128 + (size_t)stages * kBoxBytes + 8 * rows * (k + kCap16 + 1) +
         8 * (2 * (size_t)stages + 2);
}

// plan (ops/topk.py::streaming_topk_bf16_plan): a persistent grid walks the
// work items w = (row block w % RB, item range w / RB), so the blocks that
// run together read the same item range for different row blocks
template <int kType, bool kTma, int kWG>
__global__ void __launch_bounds__(128 * (1 + kWG), 1)
tile16_kernel(const __grid_constant__ CUtensorMap tmU, const __grid_constant__ CUtensorMap tmT,
              const uint16_t* __restrict__ U, const uint16_t* __restrict__ T, int B, int I,
              int D, int span, int n_ranges, int stages, int k,
              const unsigned long long* __restrict__ table, int bits, int col_offset,
              float* __restrict__ cand_s, int* __restrict__ cand_i) {
  constexpr int kRows16 = 64 * kWG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      reinterpret_cast<unsigned char*>(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  const int nb = (D + kBoxVals - 1) / kBoxVals;
  unsigned char* users = base;
  unsigned char* ring = base + (size_t)nb * kRows16 * 128;
  float* ls = reinterpret_cast<float*>(ring + (size_t)stages * kBoxBytes);
  int* li = reinterpret_cast<int*>(ls + kRows16 * k);
  float* bs = reinterpret_cast<float*>(li + kRows16 * k);
  int* bi = reinterpret_cast<int*>(bs + kRows16 * (kCap16 + 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(bi + kRows16 * (kCap16 + 1));
  uint64_t* empty = full + stages;
  uint64_t* ufull = empty + stages;
  uint64_t* uempty = ufull + 1;

  const int RB = (B + kRows16 - 1) / kRows16;
  const int W = RB * n_ranges;
  const int wg = threadIdx.x >> 7, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, kTma ? 1 : 32);
      mbar_init(empty + s, 4 * kWG);
    }
    mbar_init(ufull, kTma ? 1 : 32);
    mbar_init(uempty, 4 * kWG);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the only block-wide barrier: before the roles split

  // one big if-else, the roles never reconverge: setmaxnreg moves registers
  // from the producer warpgroup to the consumers
  if (wg == 0) {
    // ---- producer: one warp (one lane with TMA) keeps the ring full -------
    if constexpr (kWG == 4)  // 640 threads: 96 registers each at launch
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    else  // 384 threads: 168 each at launch
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 0 && (!kTma || lane == 0)) {
      int s = 0;
      uint32_t ph = 0, uph = 0;
      for (int w = blockIdx.x; w < W; w += gridDim.x) {
        const int rb = w % RB, lo = (w / RB) * span, hi = min(I, lo + span);
        const int n_tiles = (hi - lo + kN - 1) / kN;
        mbar_wait(uempty, uph ^ 1);  // both consumers are done with the last rows
        uph ^= 1;
        if (kTma) {
          mbar_expect_tx(ufull, (uint32_t)(nb * kRows16 * 128));
          for (int b = 0; b < nb; ++b)
            tma_load(users + (size_t)b * kRows16 * 128, &tmU, b * kBoxVals, rb * kRows16,
                     ufull);
        } else {
          for (int b = 0; b < nb; ++b)
            stage_box(users + (size_t)b * kRows16 * 128, U, rb * kRows16, kRows16, B,
                      b * kBoxVals, D);
          fence_proxy_async();
          mbar_arrive(ufull);
        }
        for (int t = 0; t < n_tiles; ++t)
          for (int b = 0; b < nb; ++b) {
            mbar_wait(empty + s, ph ^ 1);
            unsigned char* dst = ring + (size_t)s * kBoxBytes;
            if (kTma) {
              mbar_expect_tx(full + s, kBoxBytes);
              tma_load(dst, &tmT, b * kBoxVals, lo + t * kN, full + s);
            } else {
              stage_box(dst, T, lo + t * kN, kN, I, b * kBoxVals, D);
              fence_proxy_async();
              mbar_arrive(full + s);
            }
            if (++s == stages) {
              s = 0;
              ph ^= 1;
            }
          }
      }
    }
  } else {
    // ---- consumers: kWG warpgroups of one m64 tile (64 user rows) each ----
    // each runs its own products and selection: while one warpgroup selects,
    // the tensor cores serve the other's products
    if constexpr (kWG == 4)  // what the producer freed, shared out: 96 + 72 / 4
      asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n" ::: "memory");
    else  // 168 + 128 / 2
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1, wi = warp & 3, g = lane >> 2;
    const unsigned char* my_users = users + (size_t)cw * 64 * 128;
    Sel S{ls, li, bs, bi, table, bits, k, 0, 0, col_offset, cw * 64 + wi * 16};
    float acc[kAcc];
    float ts[2];
    int ti[2], cnt[2];
    int s = 0;
    uint32_t ph = 0, uph = 0;
    for (int w = blockIdx.x; w < W; w += gridDim.x) {
      const int rb = w % RB, range = w / RB, lo = range * span, hi = min(I, lo + span);
      const int n_tiles = (hi - lo + kN - 1) / kN;
      S.r0 = rb * kRows16;
      S.hi = hi;
      for (int i = 0; i < 16; ++i) {  // the warp's rows: empty lists
        const int lr = S.row_base + i;
        for (int qq = lane; qq < k; qq += 32) {
          ls[lr * k + qq] = -INFINITY;
          li[lr * k + qq] = INT_MAX;
        }
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // rows past B never pass
        ts[r] = S.r0 + sel_row(S, r, g) < B ? -INFINITY : INFINITY;
        ti[r] = INT_MAX;
        cnt[r] = 0;
      }
      mbar_wait(ufull, uph);
      uph ^= 1;
      for (int t = 0; t < n_tiles; ++t) {
        issue_tile<kType, kWG>(acc, my_users, ring, full, nb, D, stages, s, ph);
        wgmma_wait<0>();
        fence_acc(acc);  // the selection reads the sums after the wait
        for (int b = 0; b < nb; ++b)  // release the tile's stages
          if (lane == 0) mbar_arrive(empty + (s + stages * 2 - nb + b) % stages);
        select_tile(acc, ts, ti, cnt, S, lo + t * kN);
      }
      merge_full(S, ts, ti, cnt, true);
      for (int i = 0; i < 16; ++i) {  // the range's candidates of the warp's rows
        const int lr = S.row_base + i;
        if (S.r0 + lr >= B) continue;
        const long long at = ((long long)range * B + S.r0 + lr) * k;
        for (int qq = lane; qq < k; qq += 32) {
          cand_s[at + qq] = ls[lr * k + qq];
          cand_i[at + qq] = li[lr * k + qq];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(uempty);
    }
  }
}

}  // namespace b13

// ---- host side --------------------------------------------------------------

int stages_for(int D, int k) {
  return tile_smem_bytes(D, k, 3) <= (size_t)kMaxSmem ? 3 : 2;
}

template <bool V, int S>
int tile_launch(const float* U, const float* T, int B, int I, int D, int span, int k,
                const unsigned long long* table, int bits, int col_offset, int n_splits,
                float* cand_s, int* cand_i, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(D, k, S);
  const cudaError_t e = cudaFuncSetAttribute(
      tile_topk_kernel<V, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + kRows - 1) / kRows, n_splits);
  tile_topk_kernel<V, S><<<grid, kThreads, smem, stream>>>(U, T, B, I, D, span, k, table, bits,
                                                           col_offset, cand_s, cand_i);
  return (int)cudaGetLastError();
}

template <int K>
int merge_launch(const float* cand_s, const int* cand_i, int B, int n_splits, int k,
                 float* out_s, int* out_i, cudaStream_t stream) {
  merge_kernel<K><<<(B + kWarps - 1) / kWarps, kThreads, 0, stream>>>(cand_s, cand_i, B,
                                                                      n_splits, k, out_s, out_i);
  return (int)cudaGetLastError();
}

int splits_for(int B, int I, int D, int k) {
  const int S = stages_for(D, k);
  const size_t smem = tile_smem_bytes(D, k, S);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kernel = S == 3 ? tile_topk_kernel<true, 3> : tile_topk_kernel<true, 2>;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  const int row_blocks = (B + kRows - 1) / kRows;
  const int slots = sms * (occ > 0 ? occ : 1);
  const int tiles = (I + kCols - 1) / kCols;
  int n = slots / row_blocks;
  if (n < 1) n = 1;
  if (n > tiles) n = tiles;
  return n;
}

int tiles_launch(const float* U, const float* T, int B, int I, int D, int span, int k,
                 const unsigned long long* tab, int bits, int off, int n_splits, float* cs,
                 int* ci, cudaStream_t st) {
  const bool vec = D % Layout::kVals16 == 0 && ((uintptr_t)T & 15) == 0;
  const int S = stages_for(D, k);
  if (vec)
    return S == 3 ? tile_launch<true, 3>(U, T, B, I, D, span, k, tab, bits, off, n_splits, cs,
                                         ci, st)
                  : tile_launch<true, 2>(U, T, B, I, D, span, k, tab, bits, off, n_splits, cs,
                                         ci, st);
  return S == 3 ? tile_launch<false, 3>(U, T, B, I, D, span, k, tab, bits, off, n_splits, cs, ci,
                                        st)
                : tile_launch<false, 2>(U, T, B, I, D, span, k, tab, bits, off, n_splits, cs, ci,
                                        st);
}

int merge_any(const float* cs, const int* ci, int B, int n, int k, float* os, int* oi,
              cudaStream_t st) {
  if (k <= 16) return merge_launch<16>(cs, ci, B, n, k, os, oi, st);
  if (k <= 32) return merge_launch<32>(cs, ci, B, n, k, os, oi, st);
  return merge_launch<64>(cs, ci, B, n, k, os, oi, st);
}

// the history set of the call's rows, in ``table`` [2^bits]
int build_history(const void* row_ptr, const void* items, int B, unsigned long long* tab, int bits,
                  cudaStream_t st) {
  cudaError_t e = cudaMemsetAsync(tab, 0xff, sizeof(unsigned long long) << bits, st);
  if (e != cudaSuccess) return (int)e;
  hash_build_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      (const int*)row_ptr, (const int*)items, B, tab, bits);
  return (int)cudaGetLastError();
}

// ---- B13's TMA descriptors: cuTensorMapEncodeTiled through the runtime's
// driver entry point (the library links no libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a [rows, D] 16-bit matrix read in boxes of 64 values x box_rows rows,
// 128-byte swizzled, zeros outside
int encode_map(CUtensorMap* map, const void* ptr, int rows, int D, int box_rows, int dtype) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)b13::kBoxVals, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r =
      fn(map, dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
         2, const_cast<void*>(ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int kType, bool kTma, int kWG>
int tile16_launch(const CUtensorMap& mU, const CUtensorMap& mT, const void* U, const void* T,
                  int B, int I, int D, int span, int n_ranges, int stages, int k,
                  const unsigned long long* tab, int bits, int off, int grid, size_t smem,
                  float* cs, int* ci, cudaStream_t st) {
  auto kernel = b13::tile16_kernel<kType, kTma, kWG>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, 128 * (1 + kWG), smem, st>>>(mU, mT, (const uint16_t*)U, (const uint16_t*)T, B,
                                              I, D, span, n_ranges, stages, k, tab, bits, off,
                                              cs, ci);
  return (int)cudaGetLastError();
}

template <int kType>
int tile16_any(bool tma, int wgs, const CUtensorMap& mU, const CUtensorMap& mT, const void* U,
               const void* T, int B, int I, int D, int span, int n_ranges, int stages, int k,
               const unsigned long long* tab, int bits, int off, int grid, size_t smem,
               float* cs, int* ci, cudaStream_t st) {
#define B13_LAUNCH(TMA, MT)                                                                    \
  tile16_launch<kType, TMA, MT>(mU, mT, U, T, B, I, D, span, n_ranges, stages, k, tab, bits, \
                                off, grid, smem, cs, ci, st)
  if (tma) return wgs == 4 ? B13_LAUNCH(true, 4) : B13_LAUNCH(true, 2);
  return wgs == 4 ? B13_LAUNCH(false, 4) : B13_LAUNCH(false, 2);
#undef B13_LAUNCH
}

}  // namespace

// B5's item ranges of a call (the candidate scratch has one [B, k] slab per
// range), or minus a CUDA error code: as many as fill every SM once
extern "C" int streaming_topk_splits(int B, int I, int D, int k) {
  if (B <= 0 || I <= 0 || D <= 0 || D > 256 || k <= 0 || k > 64)
    return -(int)cudaErrorInvalidValue;
  return splits_for(B, I, D, k);
}

// B5 (and B14's float32 local stage). U: [B, D], T: [I, D] float32 (T
// 16-byte aligned when D % 4 == 0 for 16-byte copies); row T[j] is global
// item col_offset + j (B5: 0); row_ptr: [B + 1] CSR offsets into items,
// global item ids; table: [2^bits] int64 scratch (bits >= 10, 2^bits >= 2 *
// history entries); cand_s / cand_i: [n_splits, B, k] scratch; out_s /
// out_i: [B, k] float32 scores and int32 global ids
extern "C" int streaming_topk(const void* U, const void* T, int B, int I, int D,
                              const void* row_ptr, const void* items, int k, void* table,
                              int bits, int n_splits, void* cand_s, void* cand_i, void* out_s,
                              void* out_i, int col_offset, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (I <= 0 || D <= 0 || D > 256 || k <= 0 || k > 64 || bits < 10 || bits > 30 ||
      n_splits <= 0 || col_offset < 0 || col_offset > INT_MAX - I)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* tab = (unsigned long long*)table;
  int err = build_history(row_ptr, items, B, tab, bits, st);
  if (err != 0) return err;
  const int tiles_per_split = ((I + n_splits - 1) / n_splits + kCols - 1) / kCols;
  const int span = tiles_per_split * kCols;
  err = tiles_launch((const float*)U, (const float*)T, B, I, D, span, k, tab, bits, col_offset,
                     n_splits, (float*)cand_s, (int*)cand_i, st);
  if (err != 0) return err;
  return merge_any((const float*)cand_s, (const int*)cand_i, B, n_splits, k, (float*)out_s,
                   (int*)out_i, st);
}

// B13 (and B14's 16-bit local stage). As streaming_topk, on bfloat16 (dtype 1)
// or float16 (2) factors, under the launch plan of
// ops/topk.py::streaming_topk_bf16_plan: ``wgs`` consumer warpgroups (2 or 4,
// 64 user rows each), ``stages`` item boxes in the ring, item ranges of
// ``span`` items (a multiple of 64; cand_s / cand_i hold [n_ranges, B, k]), a
// persistent grid of ``grid`` blocks, ``tma`` for TMA staging (D % 8 == 0 and
// U, T 16-byte aligned) or element-wise staging
extern "C" int streaming_topk_16(const void* U, const void* T, int B, int I, int D,
                                 const void* row_ptr, const void* items, int k, void* table,
                                 int bits, int wgs, int stages, int span, int n_ranges,
                                 int grid, int tma, void* cand_s, void* cand_i, void* out_s,
                                 void* out_i, int dtype, int col_offset, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const int nb = (D + b13::kBoxVals - 1) / b13::kBoxVals;
  if (I <= 0 || D <= 0 || D > 256 || k <= 0 || k > 64 || bits < 10 || bits > 30 ||
      (dtype != kBF16 && dtype != kF16) || col_offset < 0 || col_offset > INT_MAX - I ||
      (wgs != 2 && wgs != 4) || stages < 4 || stages < nb ||
      span <= 0 ||
      span % b13::kN != 0 || n_ranges <= 0 || (long long)span * n_ranges < I ||
      (long long)span * (n_ranges - 1) >= I || grid <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = b13::smem16_bytes(wgs, nb, stages, k) + 1024;  // + alignment
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (tma && (D % 8 != 0 || ((uintptr_t)U & 15) || ((uintptr_t)T & 15)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* tab = (unsigned long long*)table;
  int err = build_history(row_ptr, items, B, tab, bits, st);
  if (err != 0) return err;
  alignas(64) CUtensorMap mU = {}, mT = {};
  if (tma) {
    err = encode_map(&mU, U, B, D, 64 * wgs, dtype);
    if (err == 0) err = encode_map(&mT, T, I, D, b13::kN, dtype);
    if (err != 0) return err;
  }
  float* cs = (float*)cand_s;
  int* ci = (int*)cand_i;
  err = dtype == kBF16
            ? tile16_any<kBF16>(tma, wgs, mU, mT, U, T, B, I, D, span, n_ranges, stages, k,
                                tab, bits, col_offset, grid, smem, cs, ci, st)
            : tile16_any<kF16>(tma, wgs, mU, mT, U, T, B, I, D, span, n_ranges, stages, k,
                               tab, bits, col_offset, grid, smem, cs, ci, st);
  if (err != 0) return err;
  return merge_any(cs, ci, B, n_ranges, k, (float*)out_s, (int*)out_i, st);
}

// B14's merge: the k best of n candidate lists per row by (score desc, id
// asc). cand_s / cand_i: [n, B, k], each row's list sorted by (score desc,
// id asc), the model group's lists in shard order (ids ascending with the
// shard); out_s / out_i: [B, k]. n k scores and ids of a row fit the
// static shared-memory limit (n k <= 6,144)
extern "C" int streaming_topk_merge(const void* cand_s, const void* cand_i, int B, int n, int k,
                                    void* out_s, void* out_i, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (n <= 0 || k <= 0 || k > 64 || n * k * 8 > 48 * 1024) return (int)cudaErrorInvalidValue;
  return rank_merge_launch((const float*)cand_s, (const int*)cand_i, B, n, k, (float*)out_s,
                           (int*)out_i, (cudaStream_t)stream);
}
