// B16: DeepAPF's attention-gated score, forward, backward and grid.
//
// Replaces recbole_cdr_tpu/models/deepapf.py:70-101 DeepAPF._att_mlp and
// _forward (XLA gathers, two [P, D] x [D, D] products of the attention MLP,
// a 2-way softmax, the blend and the predict dot) and their autodiff. Per
// pair, with the entity's shared row e, its domain-only row o and the other
// side's row t (the entity is the item in overlap_items mode, the user in
// overlap_users mode):
//
//   x_s = e * t,  x_o = o * t
//   a_. = relu(x_. @ W + b) . w2                      (W [D, D], b [D], w2 [D])
//   a_s = -1e31 where the entity does not overlap      (id > overlapped_num)
//   (al_s, al_o) = softmax(a_s, a_o),  ent = al_s e + al_o o
//   logit = (ent * t) . pl
//
// -1e31 stays finite: exp(-1e31 - max) is exactly 0, never NaN, and the
// masked share logit gets exactly zero gradient (al_s is 0 and its gradient
// is set to 0, as jnp.where gives it).
//
// A training call's pairs are both domains' at once, the source pairs
// first: pair q < n_src reads the entity's row of the shared table and of
// the source domain's entity table, and the other side's row of the source
// domain's other table, by the ids of the source pairs; the later pairs the
// target domain's tables (struct Pairs). The rows are read from the tables
// by id; no gathered [P, D] row set exists.
//
// Bound on an H100: a training step's 16,384 pairs at D = 64 read 12.6 MB of
// rows (3.8 us at 3.35 TB/s); their two D x D products are 0.27 GFLOP, 1.6
// us in 3xTF32 at 495 TFLOP/s (4.0 us on the CUDA cores). The backward adds
// the five tables' gradients, written whole (about 30 MB at phase 11's
// tables), and the products twice more.
//
// Forward (forward_kernel): persistent blocks keep W's MMA fragments in
// shared memory for the whole launch; each warp takes units of 8 MT pairs
// (the grid's unit: MT = 2 in float32 up to D = 64, else 1), each unit's e,
// o, t rows staged by cp.async into the warp's own buffer, the next unit's
// while the current one computes (one buffer where two do not fit: float32
// at D = 128). The products and the epilogue are the grid's (below): x_s of
// pair g in row g of an mma.sync tile, x_o in row g + 8, 3xTF32 m16n8k8 in
// float32, m16n8k16 on the 16-bit values; no block barrier after W.
//
// Backward, two launches around the plan of the step's ids:
// (1) backward_kernel: persistent blocks keep W's fragments for z = x W
// and for dx = dZ W^T in shared memory (float32 words: every product of the
// backward runs in TF32 with the split terms, 3xTF32 in float32; 16-bit
// values are exact in TF32, so their low parts are left out) and take
// tiles of 8 pairs a warp (64 pairs, 32 where shared memory holds only
// half), staged by cp.async, the next tile's while one computes. A warp
// recomputes its pairs' z from the staged rows as the forward does, then in
// the accumulator fragments the chain rule into d(a_s) = al_s al_o (d al_s
// - d al_o) (and -d(a_s) for a_o), dZ = relu'(z) d(a) w2, and dx = dZ W^T
// with dZ's fragments as the A operand (W^T's k order permuted to match);
// each pair's three row gradients d e, d o, d t go in float32 to a [3, P,
// D] scratch, its keyed ids to keys (the entity's id + N for a target pair:
// keys over [source | target] rows of the entity side, N its tables' rows;
// the other side's id + M the same way). dZ goes to shared memory, and
// every warp adds its tiles of dW += x^T dZ over the tile's rows; db, dw2
// and dpl are summed in registers; each block writes its partial sums once.
// (ops/row_groups.py::group_rows then groups both key sets in one launch.)
// (2) tables_kernel: the first blocks add the weight partials in block
// order; the others write the five tables' gradients, every row once, each
// row's terms from the scratch summed in float32 in position order from
// the plan and rounded once to the operands' type: the source domain's
// entity table row r reads key r's positions, the target's key N + r's,
// the shared table's both (key r's, then key N + r's: position order, the
// source pairs being first), and the other tables the same over M; a row
// no pair names is written 0. A row of at most kBigTerms terms is summed by
// a row group of a warp in order (add_terms); a longer one by a block, in
// segments of kSegTerms terms summed in order at once, then the segments'
// sums in order (a popular item's row holds hundreds of terms). No float
// atomic: every result is bit-reproducible from run to run. Measured on an
// H100 (PERF.md, probe_deepapf_pairs.py): the tables kernel is the
// backward's largest launch, its heads' chains of dependent loads and its
// zero rows' stores adding up rather than overlapping.
//
// The grid (grid_kernel), the predict fallback's [B, I] tile from the
// tables and the ids: persistent blocks keep W's MMA fragments in shared
// memory for the whole launch and take 2-D tiles of bu = min(8, B) users x
// bi = 16 items (8 in 16 bits when I <= 8; grid() picks them). A
// tile stages each of its users' rows and each of its items' rows once
// (cp.async, 16 bytes a copy; a block's first tile while it stages W): 8 +
// 32 rows serve 128 pairs. A warp takes 8 pairs (8 items of one user) as the
// 16 rows of an mma.sync tile, x_s of pair g in row g and x_o in row g + 8,
// and forms x = e * t and o * t straight into its A fragments from the
// staged rows (in 16 bits one rounding each, as before); W's B fragments
// are stored in the order the lanes read them (one 8-byte load each), and b
// seeds the accumulators. float32: 3xTF32 m16n8k8 (hi * lo, lo * hi, hi *
// hi, as B5), float32 accuracy, a warp taking two such tiles at once so
// that they share each B fragment's load and split; 16 bits: m16n8k16 on
// the 16-bit values, exact products and float32 sums. The epilogue runs on
// the accumulator fragments: lane (g, c) holds columns 8 j + 2 c, + 1 of
// both rows of pair g, so relu and . w2 reduce over the quad's 4 lanes with
// two shuffles; the softmax follows in the quad, then the logit: in float32
// al_s (x_s . pl) + al_o (x_o . pl), those dots summed while x is formed;
// in 16 bits from ent rounded as JAX rounds it, over the quad's columns of
// the staged rows. One lane writes the sigmoid; z never leaves the
// registers. Measured on an H100 (PERF.md): the float32 grid is bound by
// mma.sync's TF32 rate (its products alone take 0.051 ms of 0.056 on a
// fallback tile), so wgmma is its next step; the 16-bit grid by the
// per-tile staging and the epilogue.
//
// B16-bf16, the 16-bit form (DeepAPF under compute_dtype: bfloat16; float16
// through the same templates): every operand and output is 16-bit (the
// tables, the weights, the logits' gradient; the logits, the grid's
// probabilities, every gradient). Every kernel stages the 16-bit rows as
// they are; the forward and the grid feed them and W to the tensor cores
// as they are, the backward widened to TF32, where they are exact. Each
// dot and each sum accumulates in float32 and is rounded to the 16-bit type
// where JAX's bf16 _forward has a named intermediate: x_s and x_o, x @ W +
// b, the a's, alpha after the softmax, entity_e, the logit, and the grid's
// sigmoid. The masked share logit stays the float32
// kMasked: under float16 JAX's -1e31 is -inf, and both give alpha_s = 0
// exactly and no NaN. The backward is the float32 chain rule on those
// rounded values (a rounding passes its gradient through unchanged; the
// softmax's slope at its unrounded value), each gradient rounded once to
// the operands' type: a table row after its float32 sum, the weights' after
// the block-order sum. The float32 form is the same template with every
// rounding the identity.

#include <cmath>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "float16.cuh"
#include "row_groups.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;
constexpr float kMasked = -1e31f;

// the weight gradients [dW | db | dw2 | dpl], D D + 3 D values
__host__ __device__ constexpr int npart(int D) { return D * D + 3 * D; }

// A call's pairs, the source domain's first: pair q < n_src is source pair
// q, a later one target pair q - n_src. The entity side's tables have N
// rows (its shared table and each domain's own), the other side's M.
template <typename T>
struct Pairs {
  const T* share;    // [N, D] the entity side's shared table
  const T* only_s;   // [N, D] the source domain's entity table
  const T* only_t;   // [N, D] the target domain's
  const T* other_s;  // [M, D] the source domain's other-side table
  const T* other_t;  // [M, D] the target domain's
  const int* ent_s;  // [n_src] the source pairs' entity ids
  const int* oth_s;  // [n_src] their other ids
  const int* ent_t;  // [n - n_src] the target pairs'
  const int* oth_t;
  int n_src, n;
  int N, M;
  int overlapped;    // the share logit is masked where the entity id exceeds it
};

// pair q's domain (0 source, 1 target), entity id and other id
template <typename T>
__device__ __forceinline__ int pair_ids(const Pairs<T>& pr, int q, int& ent, int& oth) {
  const int dom = q >= pr.n_src;
  const int i = dom ? q - pr.n_src : q;
  ent = __ldg((dom ? pr.ent_t : pr.ent_s) + i);
  oth = __ldg((dom ? pr.oth_t : pr.oth_s) + i);
  return dom;
}

// ---- the tables' gradients from the plan -------------------------------------

// the five tables' gradients and their rows
template <typename T>
struct TableGrads {
  T* share;    // [N, D]
  T* only_s;   // [N, D]
  T* only_t;
  T* other_s;  // [M, D]
  T* other_t;
  int N, M;
};

// four float32 values stored at p as T, each rounded once to nearest in T
template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]) {
  if constexpr (kWide<T>) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint2 x;
    x.x = to_bits<T>(v[0]) | to_bits<T>(v[1]) << 16;
    x.y = to_bits<T>(v[2]) | to_bits<T>(v[3]) << 16;
    *reinterpret_cast<uint2*>(p) = x;
  }
}

// a row's terms for add_terms: the positions of up to two heads, the
// first's first, each an unweighted row of the [n, D] scratch
struct HeadTerms {
  const int* pos;
  int st0, n0, st1;
  __device__ __forceinline__ Term operator()(int k) const {
    return Term{__ldg(pos + (k < n0 ? st0 + k : st1 + k - n0)), 1.f};
  }
};

// (start, length) of head h of a grouping
__device__ __forceinline__ int2 head_span(const GroupsView& g, int h) {
  return make_int2(__ldg(g.head_start + h), __ldg(g.head_len + h));
}

// (start, length) of local row r's head, (0, 0) for none: head_of with the
// head's span loaded beside its check
__device__ __forceinline__ int2 span_of(const GroupsView& g, int r) {
  const int h = __ldg(g.row_head + r);
  if ((unsigned)h >= (unsigned)__ldg(g.meta + 1)) return make_int2(0, 0);
  const int row = __ldg(g.head_row + h);
  const int2 span = make_int2(__ldg(g.head_start + h), __ldg(g.head_len + h));
  return row == r ? span : make_int2(0, 0);
}

// the tables kernel's blocks a multiprocessor (its registers' bound): two
// beat one and three, where it spills (probe_deepapf_pairs.py)
constexpr int kTablesBlocks = 2;

// a block's row groups (row_geo<4>(D)): G lanes a row group, four columns a
// lane, `steps` column steps
template <int D>
struct RowGroups {
  RowGeo geo;
  int gl, group, groups;
  __device__ RowGroups() {
    geo = row_geo<4>(D);
    const int lane = threadIdx.x & 31;
    gl = lane % geo.G;
    group = (threadIdx.x >> 5) * geo.per_warp + lane / geo.G;
    groups = kWarps * geo.per_warp;
  }
};

// A row group's sum, written to row (rounded once to T), of the n terms of
// `terms`, each a row of src [., D], added in order (add_terms, 8 rows in
// flight a lane). Every lane of the group calls it with the same n.
template <int D, typename T>
__device__ __forceinline__ void group_row(const RowGroups<D>& rg, const HeadTerms& terms, int n,
                                          const float* __restrict__ src, T* row) {
  for (int s = 0; s < rg.geo.steps; ++s) {
    const int d = (s * rg.geo.G + rg.gl) * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    add_terms<4, 8, false>(n, terms, src, D, d, rg.geo, acc);
    if (d < D) store4(row + d, acc);
  }
}

// the terms of a segment of block_row's sum: a row of up to 16 segments
// (512 terms at D = 64) takes one round of the block's row groups
constexpr int kSegTerms = 32;

// A block's sum of a row of n terms, more than kBigTerms: segments of
// kSegTerms consecutive terms, a row group each (at once, `groups` of them
// a round), each added in order from 0; then the round's segment sums added
// in segment order into the row's running sum (smem: groups + 1 rows of D
// floats), the row rounded once to T as it is written. The order is fixed
// by the ids alone. Every thread of the block calls it; it ends with a
// barrier.
template <int D, typename T>
__device__ void block_row(const RowGroups<D>& rg, const HeadTerms& terms, int n,
                          const float* __restrict__ src, T* row, float* smem) {
  float* part = smem;
  float* sum = smem + rg.groups * D;
  for (int c = threadIdx.x; c < D; c += kThreads) sum[c] = 0.f;
  const int segs = (n + kSegTerms - 1) / kSegTerms;
  for (int s0 = 0; s0 < segs; s0 += rg.groups) {
    const int s = s0 + rg.group, lo = s * kSegTerms;
    const int len = s < segs ? (n - lo < kSegTerms ? n - lo : kSegTerms) : 0;
    for (int st = 0; st < rg.geo.steps; ++st) {
      const int d = (st * rg.geo.G + rg.gl) * 4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      add_terms<4, 8, false>(len, [&](int k) { return terms(lo + k); }, src, D, d, rg.geo, acc);
      if (d < D) *reinterpret_cast<float4*>(part + rg.group * D + d) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();
    const int m = segs - s0 < rg.groups ? segs - s0 : rg.groups;
    for (int c = threadIdx.x; c < D; c += kThreads) {
      float a = sum[c];
      for (int k = 0; k < m; ++k) a = __fadd_rn(a, part[k * D + c]);
      sum[c] = a;
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < D; c += kThreads) st1(row + c, sum[c]);
  __syncthreads();  // sum is rewritten by the block's next row
}

template <int D>
constexpr size_t block_row_smem() {
  return sizeof(float) * (kWarps * (size_t)row_geo<4>(D).per_warp + 1) * D;
}

// Blocks [0, WB): out[i] = the sum over blocks k, in order, of partial[k,
// i], rounded to T. The others write every row of the five tables
// (TableGrads) once, from rows [3, n, D] (d e, d o, d t of each pair) and
// the groupings ge of the entity keys (2 N rows) and go of the other keys
// (2 M rows): (1) the rows with a key of more than kBigTerms positions, a
// block each (block_row): a big entity key's own row, then the shared rows
// of the big entity keys (by the source key where both domains' are big),
// then the big other keys' rows; (2) every other key's rows by a row group:
// its domain's entity or other-side row and, for an entity key, the shared
// row, unless the other domain's key of the row writes it (its source key
// does, where there is one); (3) the rows no key names, 0: a warp checks 32
// rows, then writes the zero rows among them in coalesced 16-byte pieces.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, kTablesBlocks)
tables_kernel(const float* __restrict__ partial, int blocks, T* __restrict__ wout,
              const float* __restrict__ rows, int n, GroupsView ge, GroupsView go,
              TableGrads<T> tg) {
  constexpr int NPART = npart(D), WB = (NPART + kThreads - 1) / kThreads;
  if (blockIdx.x < WB) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= NPART) return;
    float s = 0.f;
    for (int k0 = 0; k0 < blocks; k0 += 16) {  // 16 loads in flight, added in block order
      float v[16];
#pragma unroll
      for (int k = 0; k < 16; ++k)
        v[k] = k0 + k < blocks ? __ldg(partial + (long long)(k0 + k) * NPART + i) : 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (k0 + k < blocks) s = __fadd_rn(s, v[k]);
    }
    st1(wout + i, rnd<T>(s));
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  const RowGroups<D> rg;
  const int N = tg.N, M = tg.M;
  const long long plane = (long long)n * D;
  const float* de = rows;
  const float* dov = rows + plane;
  const float* dt = rows + 2 * plane;
  const int bid = blockIdx.x - WB, nb = gridDim.x - WB;
  auto long_rows = [&]() {  // (1)
    const int big_e = __ldg(ge.meta + 2), big_o = __ldg(go.meta + 2);
    for (int b = bid; b < 2 * big_e + big_o; b += nb) {
      const bool on_e = b < 2 * big_e;
      const GroupsView& G = on_e ? ge : go;
      const int h = __ldg(G.big + (on_e ? b % big_e : b - 2 * big_e));
      const int key = __ldg(G.head_row + h), base = on_e ? N : M;
      const bool tgt = key >= base;
      const int r = key - (tgt ? base : 0);
      const int2 sp = head_span(G, h);
      if (b >= big_e && on_e) {  // the shared row
        const int2 other = span_of(ge, tgt ? r : N + r);  // the other domain's key of the row
        const int2 s0 = tgt ? other : sp, s1 = tgt ? sp : other;
        if (tgt && s0.y > kBigTerms) continue;  // the source key's
        block_row<D>(rg, HeadTerms{ge.pos, s0.x, s0.y, s1.x}, s0.y + s1.y, de,
                     tg.share + (long long)r * D, reinterpret_cast<float*>(smem));
        continue;
      }
      T* out = on_e ? (tgt ? tg.only_t : tg.only_s) : (tgt ? tg.other_t : tg.other_s);
      block_row<D>(rg, HeadTerms{G.pos, sp.x, sp.y, 0}, sp.y, on_e ? dov : dt,
                   out + (long long)r * D, reinterpret_cast<float*>(smem));
    }
  };

  auto heads_pass = [&]() {  // (2)
    const int heads_e = __ldg(ge.meta + 1), heads = heads_e + __ldg(go.meta + 1);
    for (long long w = (long long)bid * rg.groups + rg.group; w < heads;
         w += (long long)nb * rg.groups) {  // the same w in a whole row group
      const bool on_e = w < heads_e;
      const GroupsView& G = on_e ? ge : go;
      const int h = on_e ? (int)w : (int)w - heads_e, key = __ldg(G.head_row + h);
      const int2 sp = head_span(G, h);
      const int base = on_e ? N : M;
      const bool tgt = key >= base;
      const int r = key - (tgt ? base : 0);
      if (sp.y <= kBigTerms)
        group_row(rg, HeadTerms{G.pos, sp.x, sp.y, 0}, sp.y, on_e ? dov : dt,
                  (on_e ? (tgt ? tg.only_t : tg.only_s) : (tgt ? tg.other_t : tg.other_s)) +
                      (long long)r * D);
      if (!on_e) continue;
      const int2 other = span_of(ge, tgt ? r : N + r);  // the other domain's key of the row
      const int2 s0 = tgt ? other : sp, s1 = tgt ? sp : other;
      if ((tgt && s0.y > 0) || s0.y > kBigTerms || s1.y > kBigTerms) continue;  // another's row
      group_row(rg, HeadTerms{ge.pos, s0.x, s0.y, s1.x}, s0.y + s1.y, de,
                tg.share + (long long)r * D);
    }
  };

  auto zero_pass = [&]() {  // (3)
    constexpr int kPieces = D * (int)sizeof(T) / 16;  // 16-byte pieces of a row
    const int lane = threadIdx.x & 31;
    const long long warp = ((long long)bid * kThreads + threadIdx.x) >> 5;
    const long long warps = ((long long)nb * kThreads) >> 5;
    const long long total = 3LL * N + 2LL * M;
    for (long long x0 = warp * 32; x0 < total; x0 += warps * 32) {
      const long long x = x0 + lane;
      bool zero = false;
      unsigned long long row = 0;  // the lane's row's address
      if (x < total) {
        int kind, r;  // 0 shared, 1 / 2 the source / target entity table, 3 / 4 other side
        if (x < 3LL * N) kind = (int)(x / N), r = (int)(x % N);
        else kind = 3 + (int)((x - 3LL * N) / M), r = (int)((x - 3LL * N) % M);
        const GroupsView& G = kind < 3 ? ge : go;
        const int base = kind < 3 ? N : M;
        zero = !((kind != 2 && kind != 4 && head_of(G, r) >= 0) ||
                 (kind != 1 && kind != 3 && head_of(G, base + r) >= 0));
        T* t = kind == 0 ? tg.share : kind == 1 ? tg.only_s : kind == 2 ? tg.only_t
               : kind == 3 ? tg.other_s : tg.other_t;
        row = reinterpret_cast<unsigned long long>(t + (long long)r * D);
      }
      // the zero rows among the warp's 32, their pieces a lane each
      const unsigned zm = __ballot_sync(0xffffffffu, zero);
      const int pieces = __popc(zm) * kPieces;
      for (int i0 = 0; i0 < pieces; i0 += 32) {
        const int i = i0 + lane < pieces ? i0 + lane : pieces - 1;
        uint4* dst = reinterpret_cast<uint4*>(
            __shfl_sync(0xffffffffu, row, __fns(zm, 0, i / kPieces + 1)));
        if (i0 + lane < pieces) dst[i % kPieces] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  long_rows();
  heads_pass();
  zero_pass();
}

// blocks of a persistent launch: every SM full, never more blocks than tiles
template <typename K>
int persistent_blocks(K kernel, size_t smem, long long tiles) {
  if (tiles <= 0) return 0;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  const long long full = (long long)sms * (occ > 0 ? occ : 1);
  return (int)(full < tiles ? full : tiles);
}

template <int D, typename T>
int tables(const float* partial, int blocks, T* wout, const float* rows, int n,
           const GroupsView& ge, const GroupsView& go, const TableGrads<T>& tg,
           cudaStream_t stream) {
  constexpr int WB = (npart(D) + kThreads - 1) / kThreads;
  // as many blocks as run at once (the passes loop over their work)
  const int rest = grid_for(3LL * tg.N + 2LL * tg.M, kThreads, kTablesBlocks);
  if (rest <= 0) return (int)cudaErrorInvalidDevice;
  tables_kernel<D, T><<<WB + rest, kThreads, block_row_smem<D>(), stream>>>(
      partial, blocks > 0 ? blocks : 1, wout, rows, n, ge, go, tg);
  return (int)cudaGetLastError();
}

// ---- the grid: 2-D pair tiles, both products on the tensor cores ----------

constexpr int kTileUsers = 8;   // at most, users of a grid tile
constexpr int kTileItems = 16;  // at most, items of a grid tile (a multiple of 8 MT)

template <int D, typename T>
struct Grid {
  static constexpr bool kF32 = kWide<T>;
  static constexpr int NK = D / (kF32 ? 8 : 16);        // k-steps: m16n8k8 tf32, m16n8k16
  static constexpr int NT = D / 8;                      // n-tiles of 8 columns
  static constexpr int RS = D + 16 / (int)sizeof(T);    // staged row stride (elements)
  static constexpr int WWORDS = NK * NT * 64;           // W's B fragments, 32-bit words
  static constexpr int CHUNK = 16 / (int)sizeof(T);     // elements of a 16-byte copy
  // m-tiles a warp takes at once: two share each B fragment's load and
  // split in 3xTF32; the 16-bit products are cheap and one keeps 64 registers
  static constexpr int MT = kF32 && D <= 64 ? 2 : 1;
  static constexpr int UNIT = 8 * MT;                   // their items
};

// a grid block's shared memory: W's fragments, b | w2 | pl widened, the
// tile's ids, its rows (two a user and one an item when the user is the
// entity, else one and two), each 16 bytes longer than D values
template <int D, typename T>
size_t grid_smem_bytes(int bu, int bi, int entity_is_item) {
  using G = Grid<D, T>;
  const int rows = entity_is_item ? bu + 2 * bi : 2 * bu + bi;
  return 4 * (size_t)G::WWORDS + 12 * (size_t)D + 4 * (size_t)(kTileUsers + kTileItems) +
         (size_t)rows * G::RS * sizeof(T);
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

// two 16-bit values (a packed word) times two, each product rounded once to
// T: the exact product of two 16-bit values, as rnd<T>(__fmul_rn(...))
template <typename T>
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                     *reinterpret_cast<const __nv_bfloat162*>(&b));
    return *reinterpret_cast<const uint32_t*>(&r);
  } else {
    const __half2 r = __hmul2(*reinterpret_cast<const __half2*>(&a),
                              *reinterpret_cast<const __half2*>(&b));
    return *reinterpret_cast<const uint32_t*>(&r);
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);  // bit-equal in the quad's 4 lanes
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// W [D, D] into its B fragments, in the order the warps read them: for
// k-step ks and n-tile j, lane L's two words at ((ks NT + j) 32 + L) 2 (one
// 8-byte load). tf32: W[8 ks + c + 4 r][8 j + g]; 16 bits: the pair W[k][n],
// W[k + 1][n] at k = 16 ks + 2 c + 8 r (g = L / 4, c = L % 4, r the word).
// W is read in 16-byte pieces of its rows
template <int D, typename T>
__device__ void stage_fragments(const T* __restrict__ W, uint32_t* wf) {
  using G = Grid<D, T>;
  constexpr int kPieces = D / G::CHUNK;  // 16-byte pieces of a row
  for (int v = threadIdx.x; v < D * kPieces; v += kThreads) {
    const int k = v / kPieces, n0 = (v % kPieces) * G::CHUNK;
    const uint4 piece = __ldg(reinterpret_cast<const uint4*>(W + k * D + n0));
    const uint32_t words[4] = {piece.x, piece.y, piece.z, piece.w};
#pragma unroll
    for (int q = 0; q < G::CHUNK; ++q) {
      const int n = n0 + q;
      if constexpr (G::kF32) {
        const int ks = k / 8, kk = k % 8;
        wf[((ks * G::NT + n / 8) * 32 + 4 * (n % 8) + kk % 4) * 2 + kk / 4] = words[q];
      } else {
        const int ks = k / 16, kk = k % 16;
        const int w = ((ks * G::NT + n / 8) * 32 + 4 * (n % 8) + (kk % 8) / 2) * 2 + kk / 8;
        reinterpret_cast<unsigned short*>(wf)[2 * w + (k & 1)] =
            (unsigned short)(q & 1 ? words[q / 2] >> 16 : words[q / 2] & 0xffffu);
      }
    }
  }
}

// acc[s] = b + [x_s; x_o] @ W for the 16 rows of each of the warp's MT
// m-tiles: rows g (x_s) and g + 8 (x_o) of the quad g's pair of m-tile s, x
// formed in the A fragments from the staged rows (b first: the float32
// sum's order is the only change); the m-tiles share each B fragment.
// float32 also sums this thread's share of x_s . pl and x_o . pl into se,
// so: its logit al_s (x_s . pl) + al_o (x_o . pl) needs no second pass over
// the rows
template <int D, typename T, int MT>
__device__ __forceinline__ void grid_products(const T* (&E)[MT], const T* (&O)[MT],
                                              const T* (&Tt)[MT], const uint32_t* wf,
                                              const float* bs, const float* pls,
                                              float (&acc)[MT][D / 8][4], float (&se)[MT],
                                              float (&so)[MT]) {
  using G = Grid<D, T>;
  const int lane = threadIdx.x & 31, c = lane & 3;
  const uint2* wf2 = reinterpret_cast<const uint2*>(wf) + lane;
#pragma unroll
  for (int j = 0; j < G::NT; ++j) {
    const float2 bv = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * c);
#pragma unroll
    for (int s = 0; s < MT; ++s) {
      acc[s][j][0] = acc[s][j][2] = bv.x;
      acc[s][j][1] = acc[s][j][3] = bv.y;
    }
  }
#pragma unroll
  for (int s = 0; s < MT; ++s) se[s] = so[s] = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < G::NK; ++ks) {
    if constexpr (G::kF32) {
      const int k = 8 * ks + c;
      const float p0 = pls[k], p1 = pls[k + 4];
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int s = 0; s < MT; ++s) {
        const float t0 = Tt[s][k], t1 = Tt[s][k + 4];
        const float x[4] = {__fmul_rn(E[s][k], t0), __fmul_rn(O[s][k], t0),
                            __fmul_rn(E[s][k + 4], t1), __fmul_rn(O[s][k + 4], t1)};
        se[s] = fmaf(x[2], p1, fmaf(x[0], p0, se[s]));
        so[s] = fmaf(x[3], p1, fmaf(x[1], p0, so[s]));
#pragma unroll
        for (int i = 0; i < 4; ++i) split(x[i], ah[s][i], al[s][i]);
      }
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const uint2 w = wf2[(ks * G::NT + j) * 32];
        uint32_t bh0, bl0, bh1, bl1;
        split(__uint_as_float(w.x), bh0, bl0);
        split(__uint_as_float(w.y), bh1, bl1);
#pragma unroll
        for (int s = 0; s < MT; ++s) {
          mma_tf32(acc[s][j], al[s], bh0, bh1);  // the small terms first
          mma_tf32(acc[s][j], ah[s], bl0, bl1);
          mma_tf32(acc[s][j], ah[s], bh0, bh1);
        }
      }
    } else {
      const int k = 16 * ks + 2 * c;
      uint32_t a[MT][4];
#pragma unroll
      for (int s = 0; s < MT; ++s) {
        const uint32_t* e = reinterpret_cast<const uint32_t*>(E[s] + k);
        const uint32_t* o = reinterpret_cast<const uint32_t*>(O[s] + k);
        const uint32_t* t = reinterpret_cast<const uint32_t*>(Tt[s] + k);
        a[s][0] = mul2<T>(e[0], t[0]);
        a[s][1] = mul2<T>(o[0], t[0]);
        a[s][2] = mul2<T>(e[4], t[4]);
        a[s][3] = mul2<T>(o[4], t[4]);
      }
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const uint2 w = wf2[(ks * G::NT + j) * 32];
#pragma unroll
        for (int s = 0; s < MT; ++s) mma_16<T>(acc[s][j], a[s], w.x, w.y);
      }
    }
  }
}

// 16 bits: ent = rnd(al_s e + al_o o), logit += (ent * t) . pl over the
// thread's columns of the A fragments (pairs of columns, one 32-bit load of
// each row a pair), as the pair kernels round
template <int D, typename T>
__device__ __forceinline__ float blend16(const T* E, const T* O, const T* Tt, const float* pls,
                                         float als, float alo) {
  using G = Grid<D, T>;
  const int c = threadIdx.x & 3;
  float lg[2] = {0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < G::NK; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = 16 * ks + 2 * c + 8 * h;
      const uint32_t e = *reinterpret_cast<const uint32_t*>(E + d);
      const uint32_t o = *reinterpret_cast<const uint32_t*>(O + d);
      const uint32_t t = *reinterpret_cast<const uint32_t*>(Tt + d);
      const float2 p = *reinterpret_cast<const float2*>(pls + d);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const float en = rnd<T>(__fadd_rn(__fmul_rn(als, from_bits<T>(v ? e >> 16 : e & 0xffffu)),
                                          __fmul_rn(alo, from_bits<T>(v ? o >> 16 : o & 0xffffu))));
        lg[v] = fmaf(__fmul_rn(en, from_bits<T>(v ? t >> 16 : t & 0xffffu)), v ? p.y : p.x, lg[v]);
      }
    }
  return __fadd_rn(lg[0], lg[1]);
}

// The logit of quad g's pair from its mma tile's accumulators (acc[j] holds
// columns 8 j + 2 c, + 1 of rows g (x_s) and g + 8 (x_o), z = acc rounded
// to T) and its staged rows: a = relu(z) . w2, the softmax in the quad
// (the share logit masked where `masked`), then the logit, in float32 al_s
// (x_s . pl) + al_o (x_o . pl) from grid_products' dots se, so, in 16 bits
// from ent rounded as JAX rounds it (blend16), rounded to T. Every lane of
// the quad returns it.
template <int D, typename T>
__device__ __forceinline__ float pair_logit(const float (&acc)[D / 8][4], float se, float so,
                                            const T* E, const T* O, const T* Tt,
                                            const float* w2s, const float* pls, bool masked) {
  const int c = threadIdx.x & 3;
  float ps[2] = {0.f, 0.f}, po[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const float2 wv = *reinterpret_cast<const float2*>(w2s + 8 * j + 2 * c);
    ps[0] = fmaf(fmaxf(rnd<T>(acc[j][0]), 0.f), wv.x, ps[0]);
    ps[1] = fmaf(fmaxf(rnd<T>(acc[j][1]), 0.f), wv.y, ps[1]);
    po[0] = fmaf(fmaxf(rnd<T>(acc[j][2]), 0.f), wv.x, po[0]);
    po[1] = fmaf(fmaxf(rnd<T>(acc[j][3]), 0.f), wv.y, po[1]);
  }
  const float sa = quad_sum(__fadd_rn(ps[0], ps[1]));  // every lane shuffles
  const float oa = quad_sum(__fadd_rn(po[0], po[1]));
  const float as = masked ? kMasked : rnd<T>(sa);
  const float ao = rnd<T>(oa);
  const float mx = fmaxf(as, ao);
  const float es = expf(__fsub_rn(as, mx)), eo = expf(__fsub_rn(ao, mx));
  const float sum = __fadd_rn(es, eo);
  const float als = rnd<T>(__fdiv_rn(es, sum)), alo = rnd<T>(__fdiv_rn(eo, sum));
  if constexpr (kWide<T>)
    return fmaf(als, quad_sum(se), __fmul_rn(alo, quad_sum(so)));
  else
    return rnd<T>(quad_sum(blend16<D, T>(E, O, Tt, pls, als, alo)));
}

// the grid: [bu users x bi items] tiles of the [B, I] pairs, tile t at users
// (t % n_ub) bu.., items (t / n_ub) bi..; a warp takes units of MT m-tiles
// (8 MT consecutive items of one user; m-tile s its items 8 s .. 8 s + 7),
// quad g of its lanes pair g of each
template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
grid_kernel(const T* __restrict__ share_tab, const T* __restrict__ only_tab,
            const T* __restrict__ other_tab, const int* __restrict__ users,
            const int* __restrict__ items, int B, int I, int bu, int bi, int overlapped,
            int entity_is_item, const T* __restrict__ W, const T* __restrict__ b,
            const T* __restrict__ w2, const T* __restrict__ pl, T* __restrict__ out) {
  using G = Grid<D, T>;
  constexpr int MT = G::MT;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* wf = reinterpret_cast<uint32_t*>(smem);
  float* bs = reinterpret_cast<float*>(wf + G::WWORDS);
  float* w2s = bs + D;
  float* pls = w2s + D;
  int* uid = reinterpret_cast<int*>(pls + D);
  int* iid = uid + kTileUsers;
  T* urows = reinterpret_cast<T*>(iid + kTileItems);  // a user's t, or its e and o
  const int nu = entity_is_item ? 1 : 2, ni = 3 - nu;   // staged rows per user, per item
  const int n_rows = bu * nu + bi * ni;
  T* irows = urows + (size_t)bu * nu * G::RS;           // an item's e and o, or its t
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, c = lane & 3;
  const int n_ub = (B + bu - 1) / bu, units = bi / G::UNIT;
  const long long tiles = (long long)n_ub * ((I + bi - 1) / bi);
  constexpr int kRowChunks = D / G::CHUNK;

  // tile t's rows, each staged once (zeros past the edges), and its ids
  auto stage_rows = [&](long long t) {
    const int u0 = (int)(t % n_ub) * bu, i0 = (int)(t / n_ub) * bi;
    for (int e = threadIdx.x; e < n_rows * kRowChunks; e += kThreads) {
      const int r = e / kRowChunks, q = e % kRowChunks;
      const T* src = nullptr;
      if (r < bu * nu) {
        const int u = r / nu;
        if (u0 + u < B)
          src = (entity_is_item ? other_tab : (r % nu ? only_tab : share_tab)) +
                (long long)__ldg(users + u0 + u) * D;
      } else {
        const int i = (r - bu * nu) / ni;
        if (i0 + i < I)
          src = (entity_is_item ? ((r - bu * nu) % ni ? only_tab : share_tab) : other_tab) +
                (long long)__ldg(items + i0 + i) * D;
      }
      cp_async16(urows + (size_t)r * G::RS + q * G::CHUNK,
                 src ? src + q * G::CHUNK : share_tab, src != nullptr);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    const int x = threadIdx.x;
    if (x < bu) uid[x] = u0 + x < B ? __ldg(users + u0 + x) : -1;
    if (x < bi) iid[x] = i0 + x < I ? __ldg(items + i0 + x) : -1;
  };

  // the first tile's copies fly while W's fragments are staged
  if (blockIdx.x < tiles) stage_rows(blockIdx.x);
  stage_fragments<D, T>(W, wf);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    bs[d] = ld1(b + d);
    w2s[d] = ld1(w2 + d);
    pls[d] = ld1(pl + d);
  }
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int u0 = (int)(t % n_ub) * bu, i0 = (int)(t / n_ub) * bi;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    for (int m = warp; m < bu * units; m += kWarps) {
      const int u = m / units, s0 = (m % units) * G::UNIT;
      if (u0 + u >= B || i0 + s0 >= I) continue;  // uniform across the warp
      const T *E[MT], *O[MT], *Tt[MT];
      int ent[MT];
#pragma unroll
      for (int s = 0; s < MT; ++s) {
        const int slot = s0 + 8 * s + g;
        if (entity_is_item) {
          E[s] = irows + (size_t)(2 * slot) * G::RS;
          Tt[s] = urows + (size_t)u * G::RS;
          ent[s] = iid[slot];
        } else {
          E[s] = urows + (size_t)(2 * u) * G::RS;
          Tt[s] = irows + (size_t)slot * G::RS;
          ent[s] = uid[u];
        }
        O[s] = E[s] + G::RS;
      }
      float acc[MT][G::NT][4], se[MT], so[MT];
      grid_products<D, T, MT>(E, O, Tt, wf, bs, pls, acc, se, so);
#pragma unroll
      for (int s = 0; s < MT; ++s) {
        // a = relu(z) . w2, the softmax and the logit (pair_logit)
        const float lg = pair_logit<D, T>(acc[s], se[s], so[s], E[s], O[s], Tt[s], w2s, pls,
                                          ent[s] > overlapped);  // strict >
        const int slot = s0 + 8 * s + g;
        if (c == 0 && i0 + slot < I)
          st1(out + (long long)(u0 + u) * I + i0 + slot,
              rnd<T>(__fdiv_rn(1.f, __fadd_rn(1.f, expf(-lg)))));
      }
    }
    __syncthreads();  // the rows are restaged next
    if (t + gridDim.x < tiles) stage_rows(t + gridDim.x);
  }
}

template <int D, typename T>
int grid(const T* share, const T* only, const T* other, const int* users, const int* items, int B,
         int I, int overlapped, int entity_is_item, const T* W, const T* b, const T* w2,
         const T* pl, T* out, cudaStream_t stream) {
  // the tile: min(8, B) users x kTileItems items, or one unit of items when
  // I fits in it
  constexpr int unit = Grid<D, T>::UNIT;
  static_assert(kTileItems % unit == 0, "a tile holds whole units of items");
  if (B < 0 || I < 0) return (int)cudaErrorInvalidValue;
  const int bu = B < 1 ? 1 : B < kTileUsers ? B : kTileUsers;
  const int bi = I <= unit ? unit : kTileItems;
  const size_t smem = grid_smem_bytes<D, T>(bu, bi, entity_is_item);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((B + bu - 1) / bu) * ((I + bi - 1) / bi);
  const int blocks = persistent_blocks(grid_kernel<D, T>, smem, tiles);
  if (blocks < 0) return -blocks;
  if (blocks > 0)
    grid_kernel<D, T><<<blocks, kThreads, smem, stream>>>(share, only, other, users, items, B, I,
                                                          bu, bi, overlapped, entity_is_item, W,
                                                          b, w2, pl, out);
  return (int)cudaGetLastError();
}

// ---- the pair forward: a warp's units of pairs on the tensor cores ----------

// a warp's unit (the grid's: 8 MT pairs), its staged rows (e, o, t of each
// pair, 16 bytes longer than D values), and the block's shared memory: W's
// fragments, b | w2 | pl widened, then each warp's NBUF buffers (two, so
// that the next unit's rows load while the current one computes, where they
// fit)
template <int D, typename T>
struct PairUnit {
  using G = Grid<D, T>;
  static constexpr int MT = G::MT;
  static constexpr int UNIT = 8 * MT;
  static constexpr int ROWS = 3 * UNIT;
  static constexpr size_t BUF = (size_t)ROWS * G::RS * sizeof(T);
  static constexpr size_t FIXED = 4 * (size_t)G::WWORDS + 12 * (size_t)D;
  static constexpr int NBUF = FIXED + 2 * kWarps * BUF <= (size_t)kMaxSmem ? 2 : 1;
  static constexpr size_t SMEM = FIXED + NBUF * kWarps * BUF;
};

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
forward_kernel(Pairs<T> pr, const T* __restrict__ W, const T* __restrict__ b,
               const T* __restrict__ w2, const T* __restrict__ pl, T* __restrict__ out) {
  using G = Grid<D, T>;
  using U = PairUnit<D, T>;
  constexpr int MT = U::MT;
  constexpr int kRowChunks = D / G::CHUNK;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* wf = reinterpret_cast<uint32_t*>(smem);
  float* bs = reinterpret_cast<float*>(wf + G::WWORDS);
  float* w2s = bs + D;
  float* pls = w2s + D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, c = lane & 3;
  T* bufs = reinterpret_cast<T*>(smem + U::FIXED) + (size_t)warp * U::NBUF * U::ROWS * G::RS;
  const long long units = ((long long)pr.n + U::UNIT - 1) / U::UNIT;
  const long long stride = (long long)gridDim.x * kWarps;

  // unit u's rows into buf (zeros past the last pair), one commit group
  auto stage = [&](long long u, T* buf) {
    for (int e = lane; e < U::ROWS * kRowChunks; e += 32) {
      const int r = e / kRowChunks, k = e % kRowChunks, which = r % 3;
      const long long q = u * U::UNIT + r / 3;
      const T* src = nullptr;
      if (q < pr.n) {
        int ent, oth;
        const int dom = pair_ids(pr, (int)q, ent, oth);
        src = which == 0 ? pr.share + (long long)ent * D
              : which == 1 ? (dom ? pr.only_t : pr.only_s) + (long long)ent * D
                           : (dom ? pr.other_t : pr.other_s) + (long long)oth * D;
      }
      cp_async16(buf + (size_t)r * G::RS + k * G::CHUNK, src ? src + k * G::CHUNK : pr.share,
                 src != nullptr);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  long long u = (long long)blockIdx.x * kWarps + warp;
  if (u < units) stage(u, bufs);  // the first unit's copies fly while W is staged
  stage_fragments<D, T>(W, wf);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    bs[d] = ld1(b + d);
    w2s[d] = ld1(w2 + d);
    pls[d] = ld1(pl + d);
  }
  __syncthreads();
  for (int cur = 0; u < units; u += stride) {
    T* buf = bufs + (size_t)cur * U::ROWS * G::RS;
    if constexpr (U::NBUF == 2) {
      if (u + stride < units) stage(u + stride, bufs + (size_t)(cur ^ 1) * U::ROWS * G::RS);
      else asm volatile("cp.async.commit_group;\n" ::);  // an empty group keeps the count
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      cur ^= 1;
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncwarp();
    const T *E[MT], *O[MT], *Tt[MT];
#pragma unroll
    for (int s = 0; s < MT; ++s) {
      E[s] = buf + (size_t)(3 * (8 * s + g)) * G::RS;
      O[s] = E[s] + G::RS;
      Tt[s] = O[s] + G::RS;
    }
    float acc[MT][G::NT][4], se[MT], so[MT];
    grid_products<D, T, MT>(E, O, Tt, wf, bs, pls, acc, se, so);
#pragma unroll
    for (int s = 0; s < MT; ++s) {
      // the grid's epilogue (pair_logit)
      const long long q = u * U::UNIT + 8 * s + g;
      int ent = 0, oth;
      if (q < pr.n) pair_ids(pr, (int)q, ent, oth);
      const float lg = pair_logit<D, T>(acc[s], se[s], so[s], E[s], O[s], Tt[s], w2s, pls,
                                        ent > pr.overlapped);  // strict >
      if (c == 0 && q < pr.n) st1(out + q, lg);
    }
    __syncwarp();  // buf is restaged next
    if constexpr (U::NBUF == 1)
      if (u + stride < units) stage(u + stride, bufs);
  }
}

template <int D, typename T>
int forward(const Pairs<T>& pr, const T* W, const T* b, const T* w2, const T* pl, T* out,
            cudaStream_t stream) {
  using U = PairUnit<D, T>;
  const long long units = ((long long)pr.n + U::UNIT - 1) / U::UNIT;
  const int blocks =
      persistent_blocks(forward_kernel<D, T>, U::SMEM, (units + kWarps - 1) / kWarps);
  if (blocks < 0) return -blocks;
  if (blocks > 0)
    forward_kernel<D, T><<<blocks, kThreads, U::SMEM, stream>>>(pr, W, b, w2, pl, out);
  return (int)cudaGetLastError();
}

// ---- the backward's pair tiles on the tensor cores ---------------------------

// A value of T in shared memory, widened
template <typename T>
__device__ __forceinline__ float sm1(const T* p) {
  if constexpr (kWide<T>) return *p;
  else return from_bits<T>(*reinterpret_cast<const unsigned short*>(p));
}

// the backward's tile: PW warps take 8 pairs each (TP pairs), x_s of pair g
// in row g of an m16n8k8 tile, x_o in row g + 8, as the forward; every warp
// then adds its WT m16n8 tiles of dW over the tile's 2 TP rows. Shared
// memory: W's fragments for z = x W and for dx = dZ W^T (float32 words),
// b | w2 | pl, NBUF buffers of the tile's e, o, t rows (as the forward's),
// and dZ [2][TP][ZS] (x_s rows, then x_o rows). Two buffers where they fit,
// all eight warps in the pair stage where one buffer fits (else four)
template <int D, typename T>
constexpr size_t bwd_bytes(int pw, int nbuf) {
  return 8 * (size_t)D * D + 12 * (size_t)D +
         (size_t)nbuf * 3 * 8 * pw * (D + 16 / sizeof(T)) * sizeof(T) +
         2 * 8 * (size_t)pw * (D + 8) * 4;
}

template <int D, typename T>
struct BwdTile {
  static constexpr int NT = D / 8;                      // n-tiles, and k-steps of 8
  static constexpr int RS = D + 16 / (int)sizeof(T);    // staged row stride (elements)
  static constexpr int ZS = D + 8;                      // dZ row stride (floats)
  static constexpr int CHUNK = 16 / (int)sizeof(T);     // elements of a 16-byte copy
  static constexpr int PW = bwd_bytes<D, T>(kWarps, 1) <= kMaxSmem ? kWarps : kWarps / 2;
  static constexpr int NBUF = bwd_bytes<D, T>(PW, 2) <= kMaxSmem ? 2 : 1;
  static constexpr int TP = 8 * PW;
  static constexpr size_t SMEM = bwd_bytes<D, T>(PW, NBUF);
  static constexpr int WT = (D / 16) * NT / kWarps;     // dW tiles a warp: one m-tile's
  static_assert(WT >= 1 && NT % WT == 0, "a warp's dW tiles share one m-tile");
};

// W [D, D] as float32 B fragments: wf for z = x W (k-step ks, n-tile j, lane
// L's two words at ((ks NT + j) 32 + L) 2: W[8 ks + c + 4 r][8 j + g]), wt for
// dx = dZ W^T with its k order permuted so that dZ's accumulator fragments
// serve as A fragments unchanged (k-step j, n-tile i: W[8 i + g][8 j + 2 c +
// r]); g = L / 4, c = L % 4, r the word
template <int D, typename T>
__device__ void stage_tf32_fragments(const T* __restrict__ W, float* wf, float* wt) {
  constexpr int NT = D / 8;
  for (int v = threadIdx.x; v < D * D; v += kThreads) {
    const int k = v / D, n = v % D;
    const float w = ld1(W + v);
    wf[(((k / 8) * NT + n / 8) * 32 + 4 * (n % 8) + k % 4) * 2 + (k % 8) / 4] = w;
    // W[k][n] is B's (row n, column k) of W^T: n-tile k / 8, k-step n / 8
    wt[(((n / 8) * NT + k / 8) * 32 + 4 * (k % 8) + (n % 8) / 2) * 2 + n % 2] = w;
  }
}

// acc += a b in TF32 with the split terms: a's low part unless a is exact in
// TF32 (16-bit values), b's unless exact
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  if constexpr (!kExactA) mma_tf32(acc, al, bh0, bh1);  // the small terms first
  if constexpr (!kExactB) mma_tf32(acc, ah, bl0, bl1);
  mma_tf32(acc, ah, bh0, bh1);
}

// rows [3, n, D] float32: each pair's d e, d o and d t; keys [2, n]; partial
// [gridDim.x, NPART]: the block's sums of [dW | db | dw2 | dpl]
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
backward_kernel(Pairs<T> pr, const T* __restrict__ W, const T* __restrict__ b,
                const T* __restrict__ w2, const T* __restrict__ pl, const T* __restrict__ g,
                float* __restrict__ rows, int* __restrict__ keys, float* __restrict__ partial) {
  using B = BwdTile<D, T>;
  constexpr int NT = B::NT, WT = B::WT;
  constexpr bool kExact = !kWide<T>;  // 16-bit values are exact in TF32
  constexpr int kRowChunks = D / B::CHUNK;
  extern __shared__ __align__(16) unsigned char smem[];
  float* wf = reinterpret_cast<float*>(smem);
  float* wt = wf + D * D;
  float* bs = wt + D * D;
  float* w2s = bs + D;
  float* pls = w2s + D;
  T* bufs = reinterpret_cast<T*>(pls + D);
  float* dZs = reinterpret_cast<float*>(bufs + (size_t)B::NBUF * 3 * B::TP * B::RS);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, c = lane & 3;
  const long long plane = (long long)pr.n * D;
  const long long tiles = ((long long)pr.n + B::TP - 1) / B::TP;

  // tile t's rows into buf (zeros past the last pair), one commit group
  auto stage = [&](long long t, T* buf) {
    for (int e = threadIdx.x; e < 3 * B::TP * kRowChunks; e += kThreads) {
      const int r = e / kRowChunks, k = e % kRowChunks, which = r % 3;
      const long long q = t * B::TP + r / 3;
      const T* src = nullptr;
      if (q < pr.n) {
        int ent, oth;
        const int dom = pair_ids(pr, (int)q, ent, oth);
        src = which == 0 ? pr.share + (long long)ent * D
              : which == 1 ? (dom ? pr.only_t : pr.only_s) + (long long)ent * D
                           : (dom ? pr.other_t : pr.other_s) + (long long)oth * D;
      }
      cp_async16(buf + (size_t)r * B::RS + k * B::CHUNK, src ? src + k * B::CHUNK : pr.share,
                 src != nullptr);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  if (blockIdx.x < tiles) stage(blockIdx.x, bufs);  // its copies fly while W is staged
  stage_tf32_fragments<D, T>(W, wf, wt);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    bs[d] = ld1(b + d);
    w2s[d] = ld1(w2 + d);
    pls[d] = ld1(pl + d);
  }
  const uint2* wf2 = reinterpret_cast<const uint2*>(wf) + lane;
  const uint2* wt2 = reinterpret_cast<const uint2*>(wt) + lane;

  // the block's partial sums: dW's tiles in fragments; db, dw2, dpl at the
  // pair stage's columns 8 j + 2 c + h, over its pairs
  float aw[WT][4], acc_b[NT][2], acc_w2[NT][2], acc_pl[NT][2];
#pragma unroll
  for (int i = 0; i < WT; ++i) aw[i][0] = aw[i][1] = aw[i][2] = aw[i][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) acc_b[j][h] = acc_w2[j][h] = acc_pl[j][h] = 0.f;

  int cur = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    T* buf = bufs + (size_t)cur * 3 * B::TP * B::RS;
    if constexpr (B::NBUF == 2) {
      if (t + gridDim.x < tiles) stage(t + gridDim.x, bufs + (size_t)(cur ^ 1) * 3 * B::TP * B::RS);
      else asm volatile("cp.async.commit_group;\n" ::);  // an empty group keeps the count
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      cur ^= 1;
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();

    if (warp < B::PW) {
      // the pair stage: pair gq of the warp's 8
      const int p = 8 * warp + gq;
      const long long q = t * B::TP + p;
      const T* E = buf + (size_t)(3 * p) * B::RS;
      const T* O = E + B::RS;
      const T* Tt = O + B::RS;
      int ent = -1, oth = 0, dom = 0;
      float gv = 0.f;
      if (q < pr.n) {
        dom = pair_ids(pr, (int)q, ent, oth);
        gv = ld1(g + q);
        if (c == 0) {
          keys[q] = dom ? ent + pr.N : ent;
          keys[pr.n + q] = dom ? oth + pr.M : oth;
        }
      }
      const bool masked = ent > pr.overlapped;

      // z = b + x W, x formed in the A fragments (rounded to T)
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 bv = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * c);
        acc[j][0] = acc[j][2] = bv.x;
        acc[j][1] = acc[j][3] = bv.y;
      }
#pragma unroll 2
      for (int ks = 0; ks < NT; ++ks) {
        const int k = 8 * ks + c;
        const float t0 = sm1(Tt + k), t1 = sm1(Tt + k + 4);
        const float x[4] = {rnd<T>(__fmul_rn(sm1(E + k), t0)), rnd<T>(__fmul_rn(sm1(O + k), t0)),
                            rnd<T>(__fmul_rn(sm1(E + k + 4), t1)),
                            rnd<T>(__fmul_rn(sm1(O + k + 4), t1))};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split(x[i], ah[i], al[i]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint2 w = wf2[(ks * NT + j) * 32];
          uint32_t bh0, bl0, bh1, bl1;
          split(__uint_as_float(w.x), bh0, bl0);
          split(__uint_as_float(w.y), bh1, bl1);
          mma3<kExact, kExact>(acc[j], ah, al, bh0, bh1, bl0, bl1);
        }
      }

      // the attention logits and the softmax (every lane of the quad), the
      // chain rule into d(a_s) = al_s al_o (d al_s - d al_o), d(a_o) = -d(a_s)
      float ps[2] = {0.f, 0.f}, po[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 wv = *reinterpret_cast<const float2*>(w2s + 8 * j + 2 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = rnd<T>(acc[j][i]);
        ps[0] = fmaf(fmaxf(acc[j][0], 0.f), wv.x, ps[0]);
        ps[1] = fmaf(fmaxf(acc[j][1], 0.f), wv.y, ps[1]);
        po[0] = fmaf(fmaxf(acc[j][2], 0.f), wv.x, po[0]);
        po[1] = fmaf(fmaxf(acc[j][3], 0.f), wv.y, po[1]);
      }
      const float sa = quad_sum(__fadd_rn(ps[0], ps[1]));
      const float oa = quad_sum(__fadd_rn(po[0], po[1]));
      const float as = masked ? kMasked : rnd<T>(sa);  // strict >
      const float ao = rnd<T>(oa);
      const float mx = fmaxf(as, ao);
      const float es = expf(__fsub_rn(as, mx)), eo = expf(__fsub_rn(ao, mx));
      const float sum = __fadd_rn(es, eo);
      const float als_u = __fdiv_rn(es, sum), alo_u = __fdiv_rn(eo, sum);
      const float als = rnd<T>(als_u), alo = rnd<T>(alo_u);
      float ds = 0.f, dov = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = 8 * j + 2 * c + h;
          const float dent = __fmul_rn(__fmul_rn(gv, sm1(Tt + d)), pls[d]);
          ds = fmaf(dent, sm1(E + d), ds);
          dov = fmaf(dent, sm1(O + d), dov);
        }
      ds = quad_sum(ds);
      dov = quad_sum(dov);
      const float das = masked ? 0.f : __fmul_rn(__fmul_rn(als_u, alo_u), __fsub_rn(ds, dov));
      const float dao = -das;

      // dZ = relu'(z) d(a) w2 in acc's place and into dZs; the sums of db, dw2
      float* zs = dZs + (size_t)p * B::ZS;
      float* zo = dZs + (size_t)(B::TP + p) * B::ZS;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 wv = *reinterpret_cast<const float2*>(w2s + 8 * j + 2 * c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float w = h ? wv.y : wv.x;
          const float z_s = acc[j][h], z_o = acc[j][2 + h];
          const float dzs = z_s > 0.f ? __fmul_rn(das, w) : 0.f;
          const float dzo = z_o > 0.f ? __fmul_rn(dao, w) : 0.f;
          acc_w2[j][h] = fmaf(dao, fmaxf(z_o, 0.f), fmaf(das, fmaxf(z_s, 0.f), acc_w2[j][h]));
          acc_b[j][h] = __fadd_rn(__fadd_rn(acc_b[j][h], dzs), dzo);
          acc[j][h] = dzs;
          acc[j][2 + h] = dzo;
        }
        *reinterpret_cast<float2*>(zs + 8 * j + 2 * c) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(zo + 8 * j + 2 * c) = make_float2(acc[j][2], acc[j][3]);
      }

      // dx = dZ W^T: dZ's n-tile j is the A fragment of k-step j as it lies
      float dx[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i) dx[i][0] = dx[i][1] = dx[i][2] = dx[i][3] = 0.f;
#pragma unroll 2
      for (int j = 0; j < NT; ++j) {
        const float a[4] = {acc[j][0], acc[j][2], acc[j][1], acc[j][3]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split(a[i], ah[i], al[i]);
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const uint2 w = wt2[(j * NT + i) * 32];
          uint32_t bh0, bl0, bh1, bl1;
          split(__uint_as_float(w.x), bh0, bl0);
          split(__uint_as_float(w.y), bh1, bl1);
          mma3<false, kExact>(dx[i], ah, al, bh0, bh1, bl0, bl1);
        }
      }

      // the rows' gradients, in float32: d e = al_s d ent + dx_s t, d o =
      // al_o d ent + dx_o t, d t = g ent pl + dx_s e + dx_o o; d pl += g ent t
      float* dr = rows + q * D;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        float ge[2], go[2], gt[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = 8 * i + 2 * c + h;
          const float e = sm1(E + d), o = sm1(O + d), tt = sm1(Tt + d);
          const float dxs = dx[i][h], dxo = dx[i][2 + h];
          const float en = rnd<T>(__fadd_rn(__fmul_rn(als, e), __fmul_rn(alo, o)));
          const float gent = __fmul_rn(gv, en);
          const float dent = __fmul_rn(__fmul_rn(gv, tt), pls[d]);
          acc_pl[i][h] = fmaf(gent, tt, acc_pl[i][h]);
          ge[h] = fmaf(dxs, tt, __fmul_rn(als, dent));
          go[h] = fmaf(dxo, tt, __fmul_rn(alo, dent));
          gt[h] = fmaf(dxo, o, fmaf(dxs, e, __fmul_rn(gent, pls[d])));
        }
        if (q < pr.n) {
          const int d = 8 * i + 2 * c;
          *reinterpret_cast<float2*>(dr + d) = make_float2(ge[0], ge[1]);
          *reinterpret_cast<float2*>(dr + plane + d) = make_float2(go[0], go[1]);
          *reinterpret_cast<float2*>(dr + 2 * plane + d) = make_float2(gt[0], gt[1]);
        }
      }
    }
    __syncthreads();

    // dW += x^T dZ over the tile's rows: the warp's WT tiles of m-tile mt
    // (rows 16 mt .. of dW), k-step s the x rows of pairs 8 (s / 2) .. + 7,
    // x_s for even s, x_o for odd; A[m][kk] = x[pair kk][16 mt + m], B[kk][n] = dZ
    {
      const int mt = warp * WT / NT, n0 = warp * WT % NT;
#pragma unroll 2
      for (int s = 0; s < 2 * B::PW; ++s) {
        const int side = s & 1, p0 = 8 * (s >> 1) + c;
        const T* X0 = buf + (size_t)(3 * p0 + side) * B::RS + 16 * mt + gq;
        const T* T0 = buf + (size_t)(3 * p0 + 2) * B::RS + 16 * mt + gq;
        const T* X1 = X0 + 12 * B::RS;  // pair p0 + 4
        const T* T1 = T0 + 12 * B::RS;
        const float x[4] = {rnd<T>(__fmul_rn(sm1(X0), sm1(T0))),
                            rnd<T>(__fmul_rn(sm1(X0 + 8), sm1(T0 + 8))),
                            rnd<T>(__fmul_rn(sm1(X1), sm1(T1))),
                            rnd<T>(__fmul_rn(sm1(X1 + 8), sm1(T1 + 8)))};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split(x[i], ah[i], al[i]);
        const float* z0 = dZs + (size_t)(side * B::TP + p0) * B::ZS + gq;
        const float* z1 = z0 + 4 * B::ZS;
#pragma unroll
        for (int i = 0; i < WT; ++i) {
          const int n = 8 * (n0 + i);
          uint32_t bh0, bl0, bh1, bl1;
          split(z0[n], bh0, bl0);
          split(z1[n], bh1, bl1);
          mma3<kExact, false>(aw[i], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
    __syncthreads();  // the rows and dZ are restaged next
    if constexpr (B::NBUF == 1)
      if (t + gridDim.x < tiles) stage(t + gridDim.x, bufs);
  }

  // this block's partial sums [dW | db | dw2 | dpl]: dW from its fragments;
  // the others over the 8 pairs of a warp (shuffles in a fixed tree), then
  // over the warps in order through dZs' space
  float* part = partial + (long long)blockIdx.x * npart(D);
  {
    const int mt = warp * WT / NT, n0 = warp * WT % NT;
#pragma unroll
    for (int i = 0; i < WT; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        part[(16 * mt + gq + 8 * (r / 2)) * D + 8 * (n0 + i) + 2 * c + r % 2] = aw[i][r];
  }
  float* red = dZs;  // [kWarps][3][D]
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[3] = {acc_b[j][h], acc_w2[j][h], acc_pl[j][h]};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
        if (gq == 0) red[(warp * 3 + k) * D + 8 * j + 2 * c + h] = v[k];
      }
    }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * D; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < B::PW; ++w) s = __fadd_rn(s, red[w * 3 * D + i]);
    part[D * D + i] = s;
  }
}

template <int D, typename T>
int backward(const Pairs<T>& pr, const T* W, const T* b, const T* w2, const T* pl, const T* g,
             float* rows, int* keys, float* partial, int blocks, cudaStream_t stream) {
  const size_t smem = BwdTile<D, T>::SMEM;
  if (blocks > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        backward_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    backward_kernel<D, T><<<blocks, kThreads, smem, stream>>>(pr, W, b, w2, pl, g, rows, keys,
                                                               partial);
  } else {
    const cudaError_t e =
        cudaMemsetAsync(partial, 0, (size_t)npart(D) * sizeof(float), stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

template <typename T>
Pairs<T> pairs_of(const void* const* tabs, const void* const* ids, int n_src, int n, int N, int M,
                  int overlapped) {
  return {(const T*)tabs[0], (const T*)tabs[1], (const T*)tabs[2], (const T*)tabs[3],
          (const T*)tabs[4], (const int*)ids[0], (const int*)ids[1], (const int*)ids[2],
          (const int*)ids[3], n_src, n, N, M, overlapped};
}

}  // namespace

// Each entry takes the operands' type code, dtype: 0 float32, 1 bfloat16, 2
// float16 (every floating operand and output of one call has that type; the
// partial sums and the row scratch stay float32), and the width D (32, 64 or
// 128); the pair (D, dtype) picks the instance, and any other pair returns
// INVALID.
#define DEEPAPF_DISPATCH(CALL, INVALID)                               \
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
    default: return (INVALID);                                        \
  }

#define DEEPAPF_W(T) (const T*)W, (const T*)b, (const T*)w2, (const T*)pl

// The pair entries' operands: tabs, the five tables' addresses (the entity
// side's shared table [N, D], the source and the target domain's entity
// tables [N, D], the source and the target domain's other-side tables [M,
// D]); ids, four int32 arrays' (the source pairs' entity and other ids
// [n_src], the target pairs' [n - n_src]); a pair's share logit is masked
// where its entity id exceeds overlapped. W [D, D], b [D], w2 [D], pl [D].

// out: [n] logits, the source pairs' first
extern "C" int deepapf_forward(const void* const* tabs, const void* const* ids, int n_src, int n,
                               int overlapped, const void* W, const void* b, const void* w2,
                               const void* pl, int D, void* out, int dtype, void* stream) {
  if (n < 0 || n_src < 0 || n_src > n) return (int)cudaErrorInvalidValue;
#define DEEPAPF_FWD(d, T)                                                                  \
  forward<d, T>(pairs_of<T>(tabs, ids, n_src, n, 0, 0, overlapped), DEEPAPF_W(T), (T*)out, \
                (cudaStream_t)stream)
  DEEPAPF_DISPATCH(DEEPAPF_FWD, (int)cudaErrorInvalidValue)
#undef DEEPAPF_FWD
}

// share_tab, only_tab: the entity side's tables; other_tab: the other
// side's; users [B], items [I] int32; out: [B, I] sigmoid probabilities
extern "C" int deepapf_grid(const void* share_tab, const void* only_tab, const void* other_tab,
                            const void* users, const void* items, int B, int I,
                            int overlapped, int entity_is_item, const void* W,
                            const void* b, const void* w2, const void* pl, int D, void* out,
                            int dtype, void* stream) {
#define DEEPAPF_GRID(d, T)                                                                  \
  grid<d, T>((const T*)share_tab, (const T*)only_tab, (const T*)other_tab, (const int*)users, \
             (const int*)items, B, I, overlapped, entity_is_item, DEEPAPF_W(T),                \
             (T*)out, (cudaStream_t)stream)
  DEEPAPF_DISPATCH(DEEPAPF_GRID, (int)cudaErrorInvalidValue)
#undef DEEPAPF_GRID
}

// the backward's block count for n pairs (its partial-sum scratch has one
// row per block), or minus a CUDA error code
extern "C" int deepapf_backward_blocks(int D, int n, int dtype) {
#define DEEPAPF_BLOCKS(d, T)                                                    \
  persistent_blocks(backward_kernel<d, T>, BwdTile<d, T>::SMEM,                 \
                    ((long long)n + BwdTile<d, T>::TP - 1) / BwdTile<d, T>::TP)
  DEEPAPF_DISPATCH(DEEPAPF_BLOCKS, -(int)cudaErrorInvalidValue)
#undef DEEPAPF_BLOCKS
}

// The backward's first launch. g: [n] the logits' gradients; rows: float32
// [3, n, D] out, each pair's gradients of its shared, entity and other-side
// rows; keys: int32 [2, n] out, each pair's entity id (+ N for a target
// pair) and other id (+ M); partial: float32 [max(blocks, 1), D*D + 3D]
extern "C" int deepapf_backward(const void* const* tabs, const void* const* ids, int n_src, int n,
                                int N, int M, int overlapped, const void* W, const void* b,
                                const void* w2, const void* pl, int D, const void* g, void* rows,
                                void* keys, void* partial, int blocks, int dtype, void* stream) {
  if (n < 0 || n_src < 0 || n_src > n || N < 0 || M < 0) return (int)cudaErrorInvalidValue;
#define DEEPAPF_BWD(d, T)                                                                    \
  backward<d, T>(pairs_of<T>(tabs, ids, n_src, n, N, M, overlapped), DEEPAPF_W(T),          \
                 (const T*)g, (float*)rows, (int*)keys, (float*)partial, blocks,             \
                 (cudaStream_t)stream)
  DEEPAPF_DISPATCH(DEEPAPF_BWD, (int)cudaErrorInvalidValue)
#undef DEEPAPF_BWD
}

// The backward's second launch. out: the summed weight gradients [dW | db |
// dw2 | dpl]; rows: the first launch's; plan_e, plan_o: the groupings of its
// keys over 2 N and 2 M rows (meta, head_row, head_start, head_len, pos,
// row_head, big); grads: the five tables' gradients, in tabs' order, every
// row written
extern "C" int deepapf_backward_tables(const void* partial, int blocks, void* out, const void* rows,
                                       int n, int D, const void* const* plan_e,
                                       const void* const* plan_o, void* const* grads, int N,
                                       int M, int dtype, void* stream) {
  if (n < 0 || N < 0 || M < 0) return (int)cudaErrorInvalidValue;
#define DEEPAPF_TABLES(d, T)                                                                 \
  tables<d, T>((const float*)partial, blocks, (T*)out, (const float*)rows, n,                \
               groups_view(plan_e), groups_view(plan_o),                                     \
               TableGrads<T>{(T*)grads[0], (T*)grads[1], (T*)grads[2], (T*)grads[3],         \
                             (T*)grads[4], N, M},                                            \
               (cudaStream_t)stream)
  DEEPAPF_DISPATCH(DEEPAPF_TABLES, (int)cudaErrorInvalidValue)
#undef DEEPAPF_TABLES
}
