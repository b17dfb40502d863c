// B12: DCDCSR's benchmark top-k and blend.
//
// Replaces recbole_cdr_tpu/models/dcdcsr.py:179-189, the non-overlapped part
// of DCDCSR._build_benchmark: for each row m of rest [M, D] (the target
// table's rows past the overlap) the similarities rest[m] . src[j] to the
// n_ov overlapped source rows (PAD row 0 among them), their top k (value
// descending, the lower index first on a tie, as lax.top_k), and the blend
//   sn     = mean(s_pop[idx])
//   beta   = sn / (sn + t_pop[m])            (NaN where both are 0, as JAX)
//   sim_e  = sum_q sim_q src[idx_q] / (sum_q sim_q if > 0 else 1)
//   out[m] = (1 - beta) rest[m] + beta sim_e
// written with idx [M, k] and sim [M, k].
//
// Bound on an H100: operations, the 2 M n_ov D flops of the similarity
// product (of the rows that hold a value other than 0): on the tensor cores
// in 3xTF32 (three TF32 products a term, 495 TFLOP/s), or on the CUDA cores
// in float32 (67 TFLOP/s), as the JAX reference computes it; the bytes (the
// two tables once, the output) are ~30x below.
//
// The reported similarities are float32 fmaf chains over d in order
// (sim = fmaf(rest[m][d], src[j][d], sim), d = 0 .. D - 1, from 0), as the
// first design computed every one of them on the CUDA cores: the results do
// not depend on the tiling or the launch's column ranges, and two runs are
// bit-equal. Here the tensor cores screen and the chains are computed for a
// short list a row. Design, three launches:
//   1. nonzero_kernel lists the rest rows that hold a value other than 0 (a
//      warp a row). An all-zero row's chains are all 0 (finite tables), so
//      its top k are ids 0 .. k - 1; the merge writes it without a screen.
//      (DCDCSR's tables at BOTH entry: two rows in three are all zero.) The
//      wrapper reads the count back to size the next launch.
//   2. screen_kernel: grid (block of kRows listed rows, column range); a
//      block walks its range in tiles of kCols source rows, each staged with
//      its kRows rest rows (gathered through the list) in kDepth-wide slices
//      of D through a two-stage ring of shared memory filled by 16-byte
//      cp.async (4-byte where D is not a multiple of 4). Eight warps each
//      own a 32 x 16 block of scores as mma.sync m16n8k8 TF32 accumulators in
//      3xTF32 (both operands split into a TF32 high part and the exact
//      float32 rest; hi*hi + hi*lo + lo*hi), fragments by ldmatrix. A
//      screened score s lies within e of the chain f, e = (D + 8) 2^-19 D ma
//      mb + D 2^-125 (1 + ma + mb) for rows of largest |value| ma and mb
//      (the split's dropped terms are under 3 2^-20 of each |product|, the
//      tensor core's float32 sums and the chain's under (0.75 D + 0.5 D)
//      2^-23 of the sum of |products|, at most D ma mb; the second term
//      covers values the tensor core may flush as subnormal). So a candidate
//      j is certainly out of the row's top k once k others have (s - e, id)
//      better than (s_j + e_j, j) in the (value desc, id asc) order. At a
//      tile's end the scores go to shared memory and each row's 4-lane group
//      tests its 64 against the row's bar (the k-th best lower key of its
//      list; the range's first tile sets it, group_kth), appending those
//      that pass (lower and upper key, id) to the row's list. A list that
//      would overflow is pruned by its group (group_prune: the bar from the
//      list, the dominated dropped) and the tile tested again. At the
//      range's end each list is pruned, its entries (about k) rescored by
//      the exact chain, a lane a candidate, and the group's k best written
//      to part [splits, M, K]. A row whose list still outgrows its room (a
//      tile whose scores nearly all pass, or a tie of more than its room
//      within e of the k-th) is rescored over its whole range instead, by
//      the warp.
//   3. merge_blend_kernel: one warp per row merges the splits' lists (k
//      rounds of a warp argmax by (value desc, index asc)), then computes
//      the blend, the D columns spread over the lanes.
// ops/benchmark_topk.py::benchmark_topk_plan sets the ranges.

#include <cfloat>
#include <climits>
#include <cmath>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                  // rest rows per block
constexpr int kWarpsN = 4;                 // warps across a tile's columns (2 down its rows)
constexpr int kNT = 2;                     // 8-column MMA fragments per warp and tile
constexpr int kCols = kWarpsN * 8 * kNT;   // source rows per tile
constexpr int kDepth = 32;                 // values of D per ring stage
constexpr int kTStride = kDepth + 4;       // a staged row's stride: conflict-free ldmatrix
constexpr int kStages = 2;
constexpr int kSStride = kCols + 4;        // a row of the tile's scores in shared memory
constexpr int kMergeWarps = 8;

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// ---- copies and tensor-core products (as in csrc/streaming_topk.cu) ------

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

// x = hi + lo exactly: hi is x cut to TF32 (its top 19 bits), lo the exact
// float32 rest, of which the tensor core reads the TF32 part
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

// ---- selection within a warp ----------------------------------------------

// a float's order as an unsigned key (larger float, larger key; -0 as +0)
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x + 0.f);
  return u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float(k ^ ((k & 0x80000000u) ? 0x80000000u : 0xffffffffu));
}

// E entries a lane (value, id; padding (-inf, INT_MAX)): `rounds` rounds of a
// warp argmax by (value desc, id asc), each taking its winner out (a round is
// two warp reductions, redux.sync, of the value's order key and of the id);
// lane q receives round q's winner (padding where none was left), and the
// last round's winner comes back in (last_v, last_i) on every lane.
template <int E>
__device__ __forceinline__ void select_rounds(const float (&v)[E], const int (&id)[E],
                                              int rounds, float& mine_v, int& mine_i,
                                              float& last_v, int& last_i) {
  const int lane = threadIdx.x & 31;
  unsigned key[E];
  int ids[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    ids[e] = id[e];
    key[e] = id[e] == INT_MAX ? 0u : order_key(v[e]);
  }
  mine_v = -INFINITY;
  mine_i = INT_MAX;
  last_v = -INFINITY;
  last_i = INT_MAX;
  for (int q = 0; q < rounds; ++q) {
    unsigned bk = key[0];
    int bi = ids[0];
#pragma unroll
    for (int e = 1; e < E; ++e)
      if (key[e] > bk || (key[e] == bk && ids[e] < bi)) {
        bk = key[e];
        bi = ids[e];
      }
    const unsigned wk = __reduce_max_sync(0xffffffffu, bk);
    const int wi = (int)__reduce_min_sync(0xffffffffu, bk == wk ? (unsigned)bi : 0xffffffffu);
    if (wi == INT_MAX) break;  // only padding left
    const float wv = key_value(wk);
    if (lane == q) {
      mine_v = wv;
      mine_i = wi;
    }
    last_v = wv;
    last_i = wi;
#pragma unroll
    for (int e = 0; e < E; ++e)  // real ids are unique
      if (ids[e] == wi) {
        key[e] = 0u;
        ids[e] = INT_MAX;
      }
  }
}

// The k-th best of a row's entries held by its 4-lane group (lanes 4 g ..
// 4 g + 3 of a warp), NE entries a lane (padding (-inf, INT_MAX)): k rounds
// of a group argmax by (value desc, id asc), each taking its winner out;
// (-inf, INT_MAX) where the group holds fewer than k. Every lane of the warp
// calls it (its groups' rows side by side).
template <int NE>
__device__ __forceinline__ void group_kth(float (&v)[NE], int (&id)[NE], int k, float& kv,
                                          int& ki) {
  kv = -INFINITY;
  ki = INT_MAX;
  for (int q = 0; q < k; ++q) {
    float bv = v[0];
    int bi = id[0];
#pragma unroll
    for (int e = 1; e < NE; ++e)
      if (better(v[e], id[e], bv, bi)) {
        bv = v[e];
        bi = id[e];
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off, 4);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off, 4);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    kv = bv;
    ki = bi;
#pragma unroll
    for (int e = 0; e < NE; ++e)  // real ids are unique; padding stays padding
      if (id[e] == bi) {
        v[e] = -INFINITY;
        id[e] = INT_MAX;
      }
  }
  if (ki == INT_MAX) kv = -INFINITY;
}

// the exact similarity: the float32 fmaf chain over d in order, from 0; the
// loads of 32 values of each row are issued before their 32 fmafs, so a
// chain waits about one memory latency per 32 values
template <bool kVec>
__device__ __forceinline__ float chain(const float* __restrict__ a, const float* __restrict__ b,
                                       int D) {
  float acc = 0.f;
  for (int d0 = 0; d0 < D; d0 += 32) {
    if (kVec) {
      float4 x[8], y[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (d0 + 4 * u < D) {
          x[u] = __ldg(reinterpret_cast<const float4*>(a + d0 + 4 * u));
          y[u] = __ldg(reinterpret_cast<const float4*>(b + d0 + 4 * u));
        }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (d0 + 4 * u < D) {
          acc = fmaf(x[u].x, y[u].x, acc);
          acc = fmaf(x[u].y, y[u].y, acc);
          acc = fmaf(x[u].z, y[u].z, acc);
          acc = fmaf(x[u].w, y[u].w, acc);
        }
    } else {
      float x[32], y[32];
#pragma unroll
      for (int u = 0; u < 32; ++u)
        if (d0 + u < D) {
          x[u] = __ldg(a + d0 + u);
          y[u] = __ldg(b + d0 + u);
        }
#pragma unroll
      for (int u = 0; u < 32; ++u)
        if (d0 + u < D) acc = fmaf(x[u], y[u], acc);
    }
  }
  return acc;
}

// ---- the screen -------------------------------------------------------------

// a row's state in shared memory: its list of candidates (lower and upper
// key and id; every one that can still be in the range's top k is in it),
// and the bar a candidate's upper key must not fall below (the k-th best
// lower key of the list at its last merge)
struct Rows {
  float* lo;     // [kRows][room]
  float* hi;
  int* id;
  float* bar_v;  // [kRows]
  int* bar_i;
  int* n;        // entries listed
  int* over;     // the list outgrew its room: rescore the whole range
};

size_t screen_smem_bytes(int room) {
  return sizeof(float) * ((size_t)kStages * (kRows + kCols) * kTStride +
                          (size_t)kRows * kSStride + kRows + kCols) +
         12 * (size_t)kRows * room + 16 * (size_t)kRows;
}

// e of a rest row's candidates, e = fma(ee.x, mb, ee.y) for a source row of
// largest |value| mb: ee.x = err D ma + D 2^-125, ee.y = D 2^-125 (1 + ma),
// each rounded up, from the rest row's largest |value| ma (see the header)
__device__ __forceinline__ float2 row_err(float ma, float errD, float tiny) {
  return make_float2(__fmaf_ru(errD, ma, tiny), __fmaf_ru(tiny, ma, tiny));
}

// A candidate's keys: (lower, upper) = (s - e rounded down, s + e rounded up).
__device__ __forceinline__ float2 keys(float s, float2 ee, float mb) {
  const float err = __fmaf_ru(ee.x, mb, ee.y);
  return make_float2(__fsub_rd(s, err), __fadd_ru(s, err));
}

// Row r's list pruned by its 4-lane group (lanes 4 g .. 4 g + 3, NE = room /
// 4 entries a lane): the bar from its listed lower keys (the k-th best; the
// bar stays where fewer than k are listed), then every entry that k others
// do not beat for certain kept, compacted in order. Every lane of the warp
// calls it; `go` says whether this lane's row takes part.
template <int NE>
__device__ void group_prune(const Rows& S, int r, int k, bool go) {
  constexpr int room = 4 * NE;
  const int lane = threadIdx.x & 31, tq = lane & 3;
  const int m = go ? S.n[r] : 0;
  float lv[NE];
  int li[NE];
#pragma unroll
  for (int i = 0; i < NE; ++i) {
    const int j = tq + 4 * i;
    lv[i] = j < m ? S.lo[r * room + j] : -INFINITY;
    li[i] = j < m ? S.id[r * room + j] : INT_MAX;
  }
  float bv;
  int bi;
  group_kth<NE>(lv, li, k, bv, bi);
  int base = 0;
#pragma unroll 4
  for (int i = 0; i < NE; ++i) {
    const int j = tq + 4 * i;
    const bool in = j < m;
    const float l = in ? S.lo[r * room + j] : 0.f, h = in ? S.hi[r * room + j] : 0.f;
    const int id = in ? S.id[r * room + j] : 0;
    const bool kept = in && (bi == INT_MAX || !better(bv, bi, h, id));
    const unsigned mine = (__ballot_sync(0xffffffffu, kept) >> (lane & ~3)) & 0xfu;
    __syncwarp();  // the batch is read before any of it moves down
    if (kept) {
      const int at = r * room + base + __popc(mine & ((1u << tq) - 1));
      S.lo[at] = l;
      S.hi[at] = h;
      S.id[at] = id;
    }
    base += __popc(mine);
    __syncwarp();
  }
  if (go && tq == 0) {
    S.n[r] = base;
    if (bi != INT_MAX) {
      S.bar_v[r] = bv;
      S.bar_i[r] = bi;
    }
  }
  __syncwarp();
}

template <bool kVec, int kRoom>
__global__ void __launch_bounds__(kThreads, 2)
screen_kernel(const float* __restrict__ A, const float* __restrict__ Bsrc, int M,
              const int* __restrict__ rows, int n_rows, int n_ov, int D, int span, int k,
              int K, float* __restrict__ part_val, int* __restrict__ part_idx) {
  constexpr int room = kRoom, NE = kRoom / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // [kStages][kRows + kCols][kTStride]
  float* score = ring + kStages * (kRows + kCols) * kTStride;  // [kRows][kSStride]
  float* ma = score + kRows * kSStride;  // [kRows] largest |value|
  float* mb = ma + kRows;                // [kCols] the tile's
  Rows S;
  S.lo = mb + kCols;
  S.hi = S.lo + kRows * room;
  S.id = reinterpret_cast<int*>(S.hi + kRows * room);
  S.bar_v = reinterpret_cast<float*>(S.id + kRows * room);
  S.bar_i = reinterpret_cast<int*>(S.bar_v + kRows);
  S.n = S.bar_i + kRows;
  S.over = S.n + kRows;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;               // fragment row / column group
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;  // its 32 x 16 block of a tile
  const int r0 = blockIdx.x * kRows;
  const int lo = blockIdx.y * span;
  const int hi = min(n_ov, lo + span);
  const int Dp = (D + 7) / 8 * 8;
  // e's factors: see the header and row_err
  const float errD = __fmul_ru(ldexpf((float)(D + 8), -19), (float)D);
  const float tiny = ldexpf((float)D, -125);
  // the tests' rows: thread (r, q) takes row r's columns 16 q .. 16 q + 15,
  // so warp w owns rows 8 w .. 8 w + 7, 4 lanes a row
  const int tr = tid >> 2, tq = tid & 3;

  // ---- empty lists -------------------------------------------------------
  for (int r = tid; r < kRows; r += kThreads) {
    S.bar_v[r] = -INFINITY;
    S.bar_i[r] = INT_MAX;
    S.n[r] = 0;
    S.over[r] = 0;
  }

  const int n_tiles = hi > lo ? (hi - lo + kCols - 1) / kCols : 0;
  const int nk = (Dp + kDepth - 1) / kDepth;  // ring stages per tile
  const int total = n_tiles * nk;

  // stage (tile, slice) of the walk into ring buffer `buf`: the block's rest
  // rows, then the tile's source rows; rows past M or the range and columns
  // past D are zero-filled
  int is_tile = 0, is_kc = 0;
  auto issue = [&](int buf) {
    float* dst = ring + buf * (kRows + kCols) * kTStride;
    const int col0 = lo + is_tile * kCols, c0 = is_kc * kDepth;
    if (kVec) {
      constexpr int kPieces = kDepth / 4;  // 16-byte pieces of a staged row
      const int q = tid % kPieces, col = c0 + 4 * q;
      for (int r = tid / kPieces; r < kRows + kCols; r += kThreads / kPieces) {
        const bool a_side = r < kRows;
        const bool in = a_side ? r0 + r < n_rows : col0 + r - kRows < hi;
        const long long row = a_side ? (in ? __ldg(rows + r0 + r) : 0) : col0 + r - kRows;
        const bool ok = in && col < D;
        const float* src = a_side ? A : Bsrc;
        cp_async16(dst + r * kTStride + 4 * q, ok ? src + row * D + col : src, ok ? 16 : 0);
      }
    } else {
      for (int r = warp; r < kRows + kCols; r += kWarps) {
        const bool a_side = r < kRows;
        const bool in = a_side ? r0 + r < n_rows : col0 + r - kRows < hi;
        const long long row = a_side ? (in ? __ldg(rows + r0 + r) : 0) : col0 + r - kRows;
        const float* src = a_side ? A : Bsrc;
        for (int cc = lane; cc < kDepth; cc += 32) {
          const bool ok = in && c0 + cc < D;
          cp_async4(dst + r * kTStride + cc, ok ? src + row * D + c0 + cc : src, ok ? 4 : 0);
        }
      }
    }
    if (++is_kc == nk) {
      is_kc = 0;
      ++is_tile;
    }
  };

  // per-lane ldmatrix offsets: A rows (g, g + 8) x columns (0-3, 4-7) of a
  // 16-row slab; B, two 8-column fragments of depth 0-3 and 4-7 per x4 load
  const int a_off = (wm * 32 + (lane & 7) + ((lane >> 3) & 1) * 8) * kTStride + (lane >> 4) * 4;
  const int b_off = (kRows + wn * 8 * kNT + (lane & 7) + (lane >> 4) * 8) * kTStride +
                    ((lane >> 3) & 1) * 4;

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
    __syncthreads();  // stage `it` landed; every thread is done with stage it - 1
    if (it + kStages - 1 < total) issue((it + kStages - 1) % kStages);
    cp_commit();

    const float* tb = ring + (it % kStages) * (kRows + kCols) * kTStride;
    // the rows' largest |value| over this slice, 4 threads a row: the source
    // rows' every tile, the rest rows' in the first
    for (int side = tile == 0 ? 0 : 1; side < 2; ++side) {
      const float4* p = reinterpret_cast<const float4*>(tb + (side * kRows + tr) * kTStride +
                                                        8 * tq);
      const float4 x = p[0], y = p[1];
      float m = fmaxf(fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)), fmaxf(fabsf(x.z), fabsf(x.w))),
                      fmaxf(fmaxf(fabsf(y.x), fabsf(y.y)), fmaxf(fabsf(y.z), fabsf(y.w))));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float* most = side ? mb : ma;
      if (tq == 0) most[tr] = kc == 0 ? m : fmaxf(most[tr], m);
    }
    const int steps = min(kDepth, Dp - kc * kDepth) / 8;
#pragma unroll
    for (int ks = 0; ks < kDepth / 8; ++ks) {
      if (ks >= steps) break;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t raw[4];
        ldsm4(raw, tb + a_off + mt * 16 * kTStride + 8 * ks);
#pragma unroll
        for (int e = 0; e < 4; ++e) split(__uint_as_float(raw[e]), ah[mt][e], al[mt][e]);
      }
      uint32_t bh[kNT][2], bl[kNT][2];
      {
        uint32_t raw[4];
        ldsm4(raw, tb + b_off + 8 * ks);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(__uint_as_float(raw[e]), bh[e >> 1][e & 1], bl[e >> 1][e & 1]);
      }
      // small terms first; each pass runs 2 kNT independent MMAs
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

    // ---- the tile's scores are complete: to shared memory, then tested ----
    kc = 0;
    const int col0 = lo + tile * kCols;
    ++tile;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 32 + mt * 16 + g + 8 * h, col = wn * 8 * kNT + nt * 8 + 2 * t;
          *reinterpret_cast<float2*>(score + row * kSStride + col) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          acc[mt][nt][2 * h] = acc[mt][nt][2 * h + 1] = 0.f;
        }
    __syncthreads();  // the tile's scores and largest values are written
    // each row's 4 lanes test its 64 scores against its bar; an all-zero
    // rest row tests none (every chain of it is 0: its top k are the
    // range's first k ids)
    const float m_a = ma[tr];
    const float2 ee = row_err(m_a, errD, tiny);
    const bool live = r0 + tr < n_rows && !S.over[tr];
    if (tile == 1) {  // the range's first tile sets the bar: the k-th best of its lower keys
      float lv[16];
      int li[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int c = 16 * tq + u, j = col0 + c;
        lv[u] = live && j < hi ? keys(score[tr * kSStride + c], ee, mb[c]).x : -INFINITY;
        li[u] = live && j < hi ? j : INT_MAX;
      }
      float bv;
      int bi;
      group_kth<16>(lv, li, k, bv, bi);
      if (live && tq == 0) {
        S.bar_v[tr] = bv;
        S.bar_i[tr] = bi;
      }
      __syncwarp();
    }
    // the row's passing scores against its bar, and their place in its list
    unsigned pass;
    int n, x, row_n;
    auto test = [&]() {
      pass = 0;
      if (live) {
        const float bar_v = S.bar_v[tr];
        const int bar_i = S.bar_i[tr];
        const float4* srow = reinterpret_cast<const float4*>(score + tr * kSStride + 16 * tq);
        const float4* mrow = reinterpret_cast<const float4*>(mb + 16 * tq);
#pragma unroll
        for (int u4 = 0; u4 < 4; ++u4) {
          const float4 sv = srow[u4], mv = mrow[u4];
          const float sx[4] = {sv.x, sv.y, sv.z, sv.w}, mx[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
          for (int u1 = 0; u1 < 4; ++u1) {
            const int u = 4 * u4 + u1, j = col0 + 16 * tq + u;
            if (j < hi && !better(bar_v, bar_i, keys(sx[u1], ee, mx[u1]).y, j)) pass |= 1u << u;
          }
        }
      }
      n = __popc(pass);
      x = n;  // inclusive prefix over the row's 4 lanes
      int y = __shfl_up_sync(0xffffffffu, x, 1, 4);
      if (tq >= 1) x += y;
      y = __shfl_up_sync(0xffffffffu, x, 2, 4);
      if (tq >= 2) x += y;
      row_n = __shfl_sync(0xffffffffu, x, 3, 4);
    };
    test();
    bool full = S.n[tr] + row_n > room;
    if (__any_sync(0xffffffffu, full)) {  // lists too full: pruned by their groups, tested again
      group_prune<NE>(S, tr, k, full);
      test();
      full = S.n[tr] + row_n > room;
    }
    const int listed = S.n[tr];
    __syncwarp();
    if (full && tq == 0) S.over[tr] = 1;  // still too many: the range is rescored whole
    if (!full && n) {
      int at = tr * room + listed + x - n;
      for (unsigned b = pass; b; b &= b - 1) {
        const int c = 16 * tq + __ffs(b) - 1;
        const float2 kk = keys(score[tr * kSStride + c], ee, mb[c]);
        S.lo[at] = kk.x;
        S.hi[at] = kk.y;
        S.id[at] = col0 + c;
        ++at;
      }
    }
    __syncwarp();
    if (!full && tq == 0) S.n[tr] = listed + row_n;
  }
  cp_wait<0>();
  __syncthreads();

  // ---- each row's list pruned by its group, rescored by the exact chain;
  // its top k. A warp's rows' entries are spread over its lanes, the chains
  // written over their lower keys.
  group_prune<NE>(S, tr, k, r0 + tr < n_rows && !S.over[tr]);
  int counts[kRows / kWarps];
  int n_listed = 0;
#pragma unroll
  for (int i = 0; i < kRows / kWarps; ++i) {
    const int r = 8 * warp + i;
    counts[i] = r0 + r < n_rows && !S.over[r] ? S.n[r] : 0;
    n_listed += counts[i];
  }
  for (int f = lane; f < n_listed; f += 32) {
    int i = 0, j = f;
    while (j >= counts[i]) j -= counts[i++];
    const int r = 8 * warp + i;
    S.lo[r * room + j] = chain<kVec>(A + (long long)__ldg(rows + r0 + r) * D,
                                     Bsrc + (long long)S.id[r * room + j] * D, D);
  }
  __syncwarp();
  // each row's k best by its 4-lane group (all the warp's rows at once), in
  // order: lane 0 of the group writes round q's winner to place q
  {
    const int r = tr;
    const bool listed = r0 + r < n_rows && !S.over[r];
    const int m = listed ? S.n[r] : 0;
    const long long at =
        ((long long)blockIdx.y * M + (listed ? __ldg(rows + r0 + r) : 0)) * K;
    unsigned taken = 0;
    for (int q = 0; q < k; ++q) {
      float bv = -INFINITY;
      int bi = INT_MAX, bpos = -1;
      for (int i = 0; tq + 4 * i < m; ++i) {
        if ((taken >> i) & 1u) continue;
        const float v = S.lo[r * room + tq + 4 * i];
        const int id = S.id[r * room + tq + 4 * i];
        if (better(v, id, bv, bi)) {
          bv = v;
          bi = id;
          bpos = i;
        }
      }
      float wv = bv;
      int wi = bi;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, wv, off, 4);
        const int oi = __shfl_xor_sync(0xffffffffu, wi, off, 4);
        if (better(ov, oi, wv, wi)) {
          wv = ov;
          wi = oi;
        }
      }
      if (bpos >= 0 && bi == wi) taken |= 1u << bpos;
      if (listed && tq == 0) {
        part_val[at + q] = wi == INT_MAX ? -INFINITY : wv;
        part_idx[at + q] = wi;
      }
    }
    if (listed && tq == 0)
      for (int q = k; q < K; ++q) {
        part_val[at + q] = -INFINITY;
        part_idx[at + q] = INT_MAX;
      }
  }
  // a row whose list outgrew its room: the whole range, 32 columns at a time,
  // against the running top k, by the warp
  for (unsigned need = __ballot_sync(0xffffffffu, tq == 0 && r0 + tr < n_rows && S.over[tr]);
       need; need &= need - 1) {
    const int r = 8 * warp + (__ffs(need) - 1) / 4, row = __ldg(rows + r0 + r);
    const float* a = A + (long long)row * D;
    float mv = -INFINITY, lv;
    int mi = INT_MAX, li;
    for (int j0 = lo; j0 < hi; j0 += 32) {
      const int j = j0 + lane;
      const float v[2] = {mv, j < hi ? chain<kVec>(a, Bsrc + (long long)j * D, D) : -INFINITY};
      const int id[2] = {mi, j < hi ? j : INT_MAX};
      select_rounds<2>(v, id, k, mv, mi, lv, li);
    }
    const long long at = ((long long)blockIdx.y * M + row) * K;
    if (lane < K) {  // rounds past k (or past the range) leave padding
      part_val[at + lane] = lane < k ? mv : -INFINITY;
      part_idx[at + lane] = lane < k ? mi : INT_MAX;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kMergeWarps * 32)
merge_blend_kernel(const float* __restrict__ part_val, const int* __restrict__ part_idx,
                   int splits, const int* __restrict__ nonzero, const float* __restrict__ rest,
                   const float* __restrict__ src, const float* __restrict__ s_pop,
                   const float* __restrict__ t_pop, int M, int D, int k,
                   float* __restrict__ out, int* __restrict__ idx_out,
                   float* __restrict__ sim_out) {
  extern __shared__ float merge_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMergeWarps + warp;
  if (row >= M) return;  // only warp-level synchronisation below
  const int nc = splits * K;
  float* cv = merge_smem + (long long)warp * 2 * (nc + K);
  int* ci = reinterpret_cast<int*>(cv + nc);
  float* sv = cv + 2 * nc;
  int* si = reinterpret_cast<int*>(sv + K);

  if (!__ldg(nonzero + row)) {  // every chain 0: the first k ids, the lower first
    if (lane < k) {
      sv[lane] = 0.f;
      si[lane] = lane;
    }
  } else {
    for (int e = lane; e < nc; e += 32) {
      const long long p = ((long long)(e / K) * M + row) * K + e % K;
      cv[e] = part_val[p];
      ci[e] = part_idx[p];
    }
    __syncwarp();
    for (int r = 0; r < k; ++r) {
      float bv = -INFINITY;
      int bi = INT_MAX, bp = -1;
      for (int e = lane; e < nc; e += 32) {
        if (better(cv[e], ci[e], bv, bi)) {
          bv = cv[e];
          bi = ci[e];
          bp = e;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        const int op = __shfl_xor_sync(0xffffffffu, bp, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
          bp = op;
        }
      }
      if (lane == 0 && bp >= 0) {  // k <= n_ov: a real candidate is always left
        sv[r] = bv;
        si[r] = bi;
        cv[bp] = -INFINITY;  // taken
        ci[bp] = INT_MAX;
      }
      __syncwarp();
    }
  }
  __syncwarp();

  // the sums in q order; the k loads issued at once, a lane each or K a lane
  const float pop = lane < k ? __ldg(s_pop + si[lane]) : 0.f;
  float sn = 0.f, sum_sim = 0.f;
  for (int q = 0; q < k; ++q) {
    sn += __shfl_sync(0xffffffffu, pop, q);
    sum_sim += sv[q];
  }
  sn = sn / (float)k;
  const float beta = sn / (sn + t_pop[row]);
  const float denom = sum_sim > 0.f ? sum_sim : 1.f;
  const float* rrow = rest + (long long)row * D;
  float* orow = out + (long long)row * D;
  for (int d = lane; d < D; d += 32) {
    float x[K];
#pragma unroll
    for (int q = 0; q < K; ++q)
      if (q < k) x[q] = __ldg(src + (long long)si[q] * D + d);
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < K; ++q)
      if (q < k) acc = fmaf(sv[q], x[q], acc);
    orow[d] = (1.f - beta) * rrow[d] + beta * (acc / denom);
  }
  if (lane < k) {
    idx_out[(long long)row * k + lane] = si[lane];
    sim_out[(long long)row * k + lane] = sv[lane];
  }
}

// The rest rows that hold a value other than 0: nonzero[m] 1 or 0, and
// their ids listed in rows[0 .. count) in no set order (a warp a row).
__global__ void __launch_bounds__(kThreads)
nonzero_kernel(const float* __restrict__ A, int M, int D, int* __restrict__ nonzero,
               int* __restrict__ rows, int* __restrict__ count) {
  const int lane = threadIdx.x & 31;
  for (int m = blockIdx.x * kWarps + (threadIdx.x >> 5); m < M; m += gridDim.x * kWarps) {
    bool any = false;
    for (int d = lane; d < D; d += 32) any |= __ldg(A + (long long)m * D + d) != 0.f;
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) {
      nonzero[m] = any;
      if (any) rows[atomicAdd(count, 1)] = m;
    }
  }
}

template <bool V, int R>
int screen_launch(const float* rest, const float* src, int M, const int* rows, int n_rows,
                  int n_ov, int D, int span, int k, int splits, int K, float* part_val,
                  int* part_idx, cudaStream_t stream) {
  const size_t smem = screen_smem_bytes(R);
  const cudaError_t e = cudaFuncSetAttribute(
      screen_kernel<V, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n_rows + kRows - 1) / kRows, splits);
  screen_kernel<V, R><<<grid, kThreads, smem, stream>>>(rest, src, M, rows, n_rows, n_ov, D,
                                                        span, k, K, part_val, part_idx);
  return (int)cudaGetLastError();
}

template <int K>
int launch(const float* rest, const float* src, const float* s_pop, const float* t_pop,
           int M, const int* nonzero, const int* rows, int n_rows, int n_ov, int D, int k,
           int splits, int span, float* part_val, int* part_idx, float* out, int* idx,
           float* sim, cudaStream_t stream) {
  const bool vec = D % 4 == 0 && ((uintptr_t)rest & 15) == 0 && ((uintptr_t)src & 15) == 0;
  if (n_rows > 0) {  // the lists' room: 64 for k <= 16, else 96
    constexpr int R = K == 16 ? 64 : 96;
    const int e = vec ? screen_launch<true, R>(rest, src, M, rows, n_rows, n_ov, D, span, k,
                                               splits, K, part_val, part_idx, stream)
                      : screen_launch<false, R>(rest, src, M, rows, n_rows, n_ov, D, span, k,
                                                splits, K, part_val, part_idx, stream);
    if (e != 0) return e;
  }
  const size_t smem = (size_t)kMergeWarps * 2 * (splits * K + K) * sizeof(float);
  merge_blend_kernel<K><<<(M + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, smem,
                          stream>>>(part_val, part_idx, splits, nonzero, rest, src, s_pop,
                                    t_pop, M, D, k, out, idx, sim);
  return (int)cudaGetLastError();
}

}  // namespace

// The rest rows that hold a value other than 0 (nonzero_kernel): nonzero
// [M] and rows [M] int32 out, count [1] int32 out (the rows listed).
extern "C" int benchmark_topk_rows(const void* rest, int M, int D, void* nonzero, void* rows,
                                   void* count, void* stream) {
  if (M < 0 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int), st);
  if (e != cudaSuccess || M == 0) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int need = (M + kWarps - 1) / kWarps;
  nonzero_kernel<<<need < 8 * sms ? need : 8 * sms, kThreads, 0, st>>>(
      (const float*)rest, M, D, (int*)nonzero, (int*)rows, (int*)count);
  return (int)cudaGetLastError();
}

// rest [M, D], src [n_ov, D], s_pop [n_ov], t_pop [M] float32; 1 <= k <= 32,
// k <= n_ov; nonzero [M], rows [n_rows] from benchmark_topk_rows; 1 <= splits
// <= 8 column ranges of `span` source rows each (a multiple of 64, splits *
// span >= n_ov; ops/benchmark_topk.py::benchmark_topk_plan over the n_rows
// listed rows); scratch part_val / part_idx [splits, M, 16 or 32 (k <= 16 or
// not)]; out [M, D], idx [M, k] int32, sim [M, k].
extern "C" int benchmark_topk(const void* rest, const void* src, const void* s_pop,
                              const void* t_pop, int M, const void* nonzero, const void* rows,
                              int n_rows, int n_ov, int D, int k, int splits, int span,
                              void* part_val, void* part_idx, void* out, void* idx, void* sim,
                              void* stream) {
  if (M <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > 32 || k > n_ov || D < 1 || splits < 1 || splits > 8 || span < 1 ||
      span % kCols || (long long)splits * span < n_ov || n_rows < 0 || n_rows > M)
    return (int)cudaErrorInvalidValue;
  const float* r = (const float*)rest;
  const float* s = (const float*)src;
  const float* sp = (const float*)s_pop;
  const float* tp = (const float*)t_pop;
  const int* nz = (const int*)nonzero;
  const int* rw = (const int*)rows;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 16)
    return launch<16>(r, s, sp, tp, M, nz, rw, n_rows, n_ov, D, k, splits, span,
                      (float*)part_val, (int*)part_idx, (float*)out, (int*)idx, (float*)sim, st);
  return launch<32>(r, s, sp, tp, M, nz, rw, n_rows, n_ov, D, k, splits, span,
                    (float*)part_val, (int*)part_idx, (float*)out, (int*)idx, (float*)sim, st);
}
