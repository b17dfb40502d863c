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
// through the same template). Replaces the same JAX functions on bf16 factors,
// whose tile product is _score_dot (recbole_cdr_tpu/ops/topk.py:37-46) with
// preferred_element_type float32, as cast in evaluator/evaluator.py:511-531
// and :593-595. The tile kernel is B5's with one change of product: the user
// rows and item slices stay 16-bit in shared memory (no split; a ring stage
// holds 64 values of D, the same 128 bytes as B5's 32 floats, so the stage
// stride, the ldmatrix addressing and its conflict-free banks carry over
// byte for byte), and each 32-byte depth step is one
// mma.sync.m16n8k16.f32.bf16.bf16.f32 whose fragments are loaded by the same
// ldmatrix.x4 of 16-bit rows (A: rows g / g + 8 at k 0-7 / 8-15; B: two
// 8-item fragments at k 0-7 / 8-15). bf16 x bf16 products are exact in
// float32, so the card and JAX differ only in the order of the float32 sums.
// Bound: one tensor-core product per score, 2 B I D flops over the dense
// bf16 rate of 989 TFLOP/s (0.29 ms for [2048 x 64] against 1.1M items),
// against B5's three TF32 products; the item table is half B5's bytes.
// Accumulators, selection, masking and the merge are B5's.
//
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
// over the model group, outside the kernels. Merge: B5's merge kernel over the
// [m, B, k] lists in shard order, by (score desc, id asc): the shards' ids
// ascend with the shard, so this is the stable merge of the lists
// concatenated in shard order, and ties go to the lowest global id, as in one
// top-k over the whole row: ids equal the unsharded top-k exactly.

#include <cfloat>
#include <climits>
#include <cmath>
#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

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

// per type: bytes of a value, the MMA depth, and the layout in values. A ring
// stage holds 128 bytes of D per item (32 floats or 64 16-bit values) at a
// row stride of 144 bytes (36 words, 4 mod 8: conflict-free ldmatrix rows);
// the user rows pad D to the MMA depth plus 16 bytes, the same property
template <int kType>
struct Layout {
  static constexpr int kBytes = kType == kF32 ? 4 : 2;
  static constexpr int kVals16 = 16 / kBytes;       // values per 16 bytes
  static constexpr int kMmaK = 32 / kBytes;         // MMA depth: 8 tf32, 16 bf16
  static constexpr int kDepth = 128 / kBytes;       // values of D per ring stage
  static constexpr int kTStride = kDepth + kVals16;  // stage row stride
  static constexpr int kUserArrays = kType == kF32 ? 2 : 1;  // TF32 hi and lo, or raw
  using Val = std::conditional_t<kType == kF32, float, uint16_t>;
  __host__ __device__ static int pad(int D) { return (D + kMmaK - 1) / kMmaK * kMmaK; }
  __host__ __device__ static int ust(int D) { return pad(D) + kVals16; }
};

template <int kType>
size_t tile_smem_bytes(int D, int k, int stages) {
  using L = Layout<kType>;
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

// one 16 x 8 x 16 product of 16-bit operands, float32 accumulators
template <int kType>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  if constexpr (kType == kBF16)
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

template <int kType, bool kVec, int kStages>
__global__ void __launch_bounds__(kThreads, 2)
tile_topk_kernel(const typename Layout<kType>::Val* __restrict__ U,
                 const typename Layout<kType>::Val* __restrict__ T, int B, int I, int D,
                 int span, int k, const unsigned long long* __restrict__ table, int bits,
                 int col_offset, float* __restrict__ cand_s, int* __restrict__ cand_i) {
  using Lay = Layout<kType>;
  using Val = typename Lay::Val;
  constexpr int kDepth = Lay::kDepth, kTStride = Lay::kTStride, kV16 = Lay::kVals16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = Lay::pad(D), ust = Lay::ust(D);
  // float32: [kRows][ust] TF32 high parts, then residuals; 16-bit: the raw rows
  uint32_t* uh = reinterpret_cast<uint32_t*>(smem);
  uint32_t* ul = uh + kRows * ust;
  uint16_t* us = reinterpret_cast<uint16_t*>(smem);
  Val* ring = kType == kF32 ? reinterpret_cast<Val*>(ul + kRows * ust)
                            : reinterpret_cast<Val*>(us + kRows * ust);  // [kStages][kCols][kTStride]
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

  // ---- the user rows, split once (float32) or staged raw; empty lists -----
  for (int r = warp; r < kRows; r += kWarps)
    for (int d = lane; d < Dp; d += 32) {
      const bool in = r0 + r < B && d < D;
      if constexpr (kType == kF32)
        split(in ? __ldg(U + (long long)(r0 + r) * D + d) : 0.f, uh[r * ust + d],
              ul[r * ust + d]);
      else
        us[r * ust + d] = in ? __ldg(U + (long long)(r0 + r) * D + d) : (uint16_t)0;
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
          if constexpr (kType == kF32)
            cp_async4(dst + r * kTStride + cc,
                      ok ? T + (long long)(item0 + r) * D + c0 + cc : T, ok ? 4 : 0);
          else  // no 2-byte cp.async: a plain copy, seen by the readers after the
                // barrier that precedes this stage's use
            dst[r * kTStride + cc] = ok ? __ldg(T + (long long)(item0 + r) * D + c0 + cc)
                                        : (uint16_t)0;
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
      if constexpr (kType != kF32) {
        // one 16-bit product per score
        uint32_t a[2][4], b[kNT][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) ldsm4(a[mt], us + a_off + mt * 16 * ust + c0 + kK * ks);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t raw[4];
          ldsm4(raw, tb + b_off + np * 16 * kTStride + kK * ks);
#pragma unroll
          for (int e = 0; e < 4; ++e) b[2 * np + (e >> 1)][e & 1] = raw[e];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) mma16<kType>(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
      } else {
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

// ---- host side --------------------------------------------------------------

template <int kType>
int stages_for(int D, int k) {
  return tile_smem_bytes<kType>(D, k, 3) <= (size_t)kMaxSmem ? 3 : 2;
}

template <int kType, bool V, int S>
int tile_launch(const void* U, const void* T, int B, int I, int D, int span, int k,
                const unsigned long long* table, int bits, int col_offset, int n_splits,
                float* cand_s, int* cand_i, cudaStream_t stream) {
  using Val = typename Layout<kType>::Val;
  const size_t smem = tile_smem_bytes<kType>(D, k, S);
  const cudaError_t e = cudaFuncSetAttribute(
      tile_topk_kernel<kType, V, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + kRows - 1) / kRows, n_splits);
  tile_topk_kernel<kType, V, S><<<grid, kThreads, smem, stream>>>(
      (const Val*)U, (const Val*)T, B, I, D, span, k, table, bits, col_offset, cand_s, cand_i);
  return (int)cudaGetLastError();
}

template <int K>
int merge_launch(const float* cand_s, const int* cand_i, int B, int n_splits, int k,
                 float* out_s, int* out_i, cudaStream_t stream) {
  merge_kernel<K><<<(B + kWarps - 1) / kWarps, kThreads, 0, stream>>>(cand_s, cand_i, B,
                                                                      n_splits, k, out_s, out_i);
  return (int)cudaGetLastError();
}

template <int kType>
int splits_for(int B, int I, int D, int k) {
  const int S = stages_for<kType>(D, k);
  const size_t smem = tile_smem_bytes<kType>(D, k, S);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kernel = S == 3 ? tile_topk_kernel<kType, true, 3> : tile_topk_kernel<kType, true, 2>;
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

template <int kType>
int tiles_launch(const void* U, const void* T, int B, int I, int D, int span, int k,
                 const unsigned long long* tab, int bits, int off, int n_splits, float* cs,
                 int* ci, cudaStream_t st) {
  const bool vec = D % Layout<kType>::kVals16 == 0 && ((uintptr_t)T & 15) == 0;
  const int S = stages_for<kType>(D, k);
  if (vec)
    return S == 3 ? tile_launch<kType, true, 3>(U, T, B, I, D, span, k, tab, bits, off,
                                                n_splits, cs, ci, st)
                  : tile_launch<kType, true, 2>(U, T, B, I, D, span, k, tab, bits, off,
                                                n_splits, cs, ci, st);
  return S == 3 ? tile_launch<kType, false, 3>(U, T, B, I, D, span, k, tab, bits, off, n_splits,
                                               cs, ci, st)
                : tile_launch<kType, false, 2>(U, T, B, I, D, span, k, tab, bits, off, n_splits,
                                               cs, ci, st);
}

int merge_any(const float* cs, const int* ci, int B, int n, int k, float* os, int* oi,
              cudaStream_t st) {
  if (k <= 16) return merge_launch<16>(cs, ci, B, n, k, os, oi, st);
  if (k <= 32) return merge_launch<32>(cs, ci, B, n, k, os, oi, st);
  return merge_launch<64>(cs, ci, B, n, k, os, oi, st);
}

}  // namespace

// the item ranges of a call (the candidate scratch has one [B, k] slab per
// range), or minus a CUDA error code: as many as fill every SM once. dtype:
// 0 float32 factors (B5), 1 bfloat16 (B13), 2 float16
extern "C" int streaming_topk_splits(int B, int I, int D, int k, int dtype) {
  if (B <= 0 || I <= 0 || D <= 0 || D > 256 || k <= 0 || k > 64 || dtype < 0 || dtype > 2)
    return -(int)cudaErrorInvalidValue;
  if (dtype == kF32) return splits_for<kF32>(B, I, D, k);
  return dtype == kBF16 ? splits_for<kBF16>(B, I, D, k) : splits_for<kF16>(B, I, D, k);
}

// U: [B, D], T: [I, D] of the factors' type ``dtype`` (T 16-byte aligned when
// 16 bytes hold whole values of D); row T[j] is global item col_offset + j
// (B5 and B13: 0); row_ptr: [B + 1] CSR offsets into items, global item ids;
// table: [2^bits] int64 scratch (bits >= 10, 2^bits >= 2 * history entries);
// cand_s / cand_i: [n_splits, B, k] scratch; out_s / out_i: [B, k] float32
// scores and int32 global ids
extern "C" int streaming_topk(const void* U, const void* T, int B, int I, int D,
                              const void* row_ptr, const void* items, int k, void* table,
                              int bits, int n_splits, void* cand_s, void* cand_i, void* out_s,
                              void* out_i, int dtype, int col_offset, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (I <= 0 || D <= 0 || D > 256 || k <= 0 || k > 64 || bits < 10 || bits > 30 ||
      n_splits <= 0 || dtype < 0 || dtype > 2 || col_offset < 0 || col_offset > INT_MAX - I)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* tab = (unsigned long long*)table;
  cudaError_t e = cudaMemsetAsync(tab, 0xff, sizeof(unsigned long long) << bits, st);
  if (e != cudaSuccess) return (int)e;
  hash_build_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      (const int*)row_ptr, (const int*)items, B, tab, bits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int tiles_per_split = ((I + n_splits - 1) / n_splits + kCols - 1) / kCols;
  const int span = tiles_per_split * kCols;
  float* cs = (float*)cand_s;
  int* ci = (int*)cand_i;
  const int off = col_offset;
  int err;
  if (dtype == kF32)
    err = tiles_launch<kF32>(U, T, B, I, D, span, k, tab, bits, off, n_splits, cs, ci, st);
  else if (dtype == kBF16)
    err = tiles_launch<kBF16>(U, T, B, I, D, span, k, tab, bits, off, n_splits, cs, ci, st);
  else
    err = tiles_launch<kF16>(U, T, B, I, D, span, k, tab, bits, off, n_splits, cs, ci, st);
  if (err != 0) return err;
  return merge_any(cs, ci, B, n_splits, k, (float*)out_s, (int*)out_i, st);
}

// B14's merge: the k best of n candidate lists per row by (score desc, id
// asc). cand_s / cand_i: [n, B, k] (the model group's lists in shard order);
// out_s / out_i: [B, k]
extern "C" int streaming_topk_merge(const void* cand_s, const void* cand_i, int B, int n, int k,
                                    void* out_s, void* out_i, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (n <= 0 || k <= 0 || k > 64) return (int)cudaErrorInvalidValue;
  return merge_any((const float*)cand_s, (const int*)cand_i, B, n, k, (float*)out_s,
                   (int*)out_i, (cudaStream_t)stream);
}
