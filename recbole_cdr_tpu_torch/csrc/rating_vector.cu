// B11: DTCDR's DMF rating-vector product, forward and backward.
//
// Replaces recbole_cdr_tpu/models/dtcdr.py:127-154 (_rating_vector: each
// id's padded history row scattered into a dense binary [B, N] vector, its
// PAD column zeroed, then `vec @ table`) and its autodiff (`vec.T @ gout`).
// The vector is a set, so with the history held as a CSR of each row's
// distinct non-PAD entries the same function is
//
//   forward:  out[b] = sum over j in row(ids[b]) of table[cols[j]]
//   backward: dtable[cols[j]] += gout[b] for every b and every j in row(ids[b])
//
// Bound on an H100: bytes. The dense form reads a [B, N] vector (0.9 GB at
// B = 8,192 and N = 27.8k); the gather-sum reads each distinct id's history
// entries and the table rows they name (D floats each, L2-resident: the
// tables are at most ~11 MB), one add per entry and column.
//
// Design. Batches repeat popular ids (a popular item is in hundreds of the
// batch's pairs, with thousands of history entries), so every launch works
// per distinct id:
//   1. one thread per id: atomicMin of its position into firstpos[row] (an
//      [R] int32 scratch the caller fills with INT_MAX), so each row's first
//      position in the batch is its "head";
//   2. one block plans the work: each head's row is cut into pieces of
//      kPiece entries, and an exclusive scan of the pieces per position
//      gives piece_start (piece_start[B] = the total);
//   3. a fixed grid of warps strides over the pieces; a warp finds its
//      piece's head by binary search in piece_start, loads the piece's
//      column ids in one coalesced read, and sums (forward) or scatters
//      (backward) the table rows, each lane holding up to 4 columns of a
//      128-column slice. Pieces keep the work balanced whatever the rows'
//      lengths (the smoke pair's rows reach 13.9k entries);
//   4. forward: heads add their pieces' partial sums into out[head] with
//      atomicAdd (the caller zeroes out), then every non-head copies its
//      head's row. Backward: every position first adds its gout row into
//      its head's slot of a zeroed [B, D] scratch, then the pieces add the
//      head's summed gradient into each entry's table row with atomicAdd.
// So both directions cost the distinct rows' entries times D, not B times
// the rows' lengths. A row of one piece sums in a fixed order; longer rows
// and the backward's shared table rows add in a run-dependent order.
//
// B11-bf16, the 16-bit form (DMF under compute_dtype: bfloat16; float16
// through the same template). JAX's rating vector stays float32
// (dtcdr.py:132), and float32 @ bf16 promotes to float32, so the forward
// reads 16-bit table rows (half the bytes), widens them exactly and sums
// them in float32 into a float32 output. The backward's gout is float32 (the
// towers run in float32); the table's gradient passes back through the
// promotion's cast, so it is the float32 row sum rounded once to the
// table's type: the pieces add into a float32 scratch table, and one
// elementwise launch rounds it into the 16-bit gradient.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPlanThreads = 1024;
constexpr int kPiece = 32;   // history entries per piece: one column id per lane
constexpr int kLanes = 4;    // columns per lane in a 128-column slice
constexpr int kSlice = 32 * kLanes;
constexpr int kGrid = 1056;  // 132 SMs x 8 blocks of 8 warps

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float x) { return __float2half_rn(x); }

__global__ void first_position_kernel(const int* __restrict__ ids, int B, int R,
                                      int* __restrict__ firstpos) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const int r = ids[b];
  if (r >= 0 && r < R) atomicMin(firstpos + r, b);
}

__device__ __forceinline__ int n_pieces(const int* ptr, int r) {
  return (ptr[r + 1] - ptr[r] + kPiece - 1) / kPiece;
}

// One block of kPlanThreads: head_of[b] is the first position of ids[b] (b
// itself for an id out of [0, R), which then has no pieces); piece_start is
// the exclusive scan of the heads' piece counts, piece_start[B] the total.
__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(const int* __restrict__ ids, const int* __restrict__ ptr,
            const int* __restrict__ firstpos, int B, int R,
            int* __restrict__ head_of, int* __restrict__ piece_start) {
  __shared__ int warp_sums[kPlanThreads / 32];
  const int per = (B + kPlanThreads - 1) / kPlanThreads;
  const int lo = min(B, (int)threadIdx.x * per), hi = min(B, lo + per);
  int local = 0;
  for (int b = lo; b < hi; ++b) {
    const int r = ids[b];
    const bool valid = r >= 0 && r < R;
    const int h = valid ? firstpos[r] : b;
    head_of[b] = h;
    if (valid && h == b) local += n_pieces(ptr, r);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = local;  // inclusive scan within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int start = x - local + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int b = lo; b < hi; ++b) {
    piece_start[b] = start;
    const int r = ids[b];
    if (head_of[b] == b && r >= 0 && r < R) start += n_pieces(ptr, r);
  }
  if (threadIdx.x == kPlanThreads - 1) piece_start[B] = start;
}

// the head b whose pieces hold piece w: piece_start[b] <= w < piece_start[b + 1]
__device__ __forceinline__ int head_of_piece(const int* piece_start, int B, int w) {
  int lo = 0, hi = B;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (piece_start[mid] <= w) lo = mid;
    else hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
forward_pieces_kernel(const int* __restrict__ ptr, const int* __restrict__ cols,
                      const T* __restrict__ table, const int* __restrict__ ids,
                      const int* __restrict__ piece_start, int B, int D,
                      float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int total = piece_start[B];
  for (int w = blockIdx.x * kWarps + (threadIdx.x >> 5); w < total; w += gridDim.x * kWarps) {
    const int b = head_of_piece(piece_start, B, w);
    const int r = ids[b];
    const int j0 = ptr[r] + (w - piece_start[b]) * kPiece;
    const int n = min(kPiece, ptr[r + 1] - j0);
    const int my_col = lane < n ? cols[j0 + lane] : 0;
    float* o = out + (long long)b * D;
    for (int d0 = 0; d0 < D; d0 += kSlice) {
      float acc[kLanes];
#pragma unroll
      for (int t = 0; t < kLanes; ++t) acc[t] = 0.f;
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const T* row = table + (long long)__shfl_sync(0xffffffffu, my_col, i) * D;
#pragma unroll
        for (int t = 0; t < kLanes; ++t) {
          const int d = d0 + lane + 32 * t;
          if (d < D) acc[t] += widen(row[d]);
        }
      }
#pragma unroll
      for (int t = 0; t < kLanes; ++t) {
        const int d = d0 + lane + 32 * t;
        if (d < D) atomicAdd(o + d, acc[t]);
      }
    }
  }
}

// one warp per position: a non-head copies its head's row
__global__ void copy_from_head_kernel(const int* __restrict__ head_of, int B, int D,
                                      float* __restrict__ out) {
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const long long h = head_of[b];
  if (h == b) return;
  for (int d = threadIdx.x & 31; d < D; d += 32) out[b * D + d] = out[h * D + d];
}

// one warp per position: its gradient row into its head's slot
__global__ void coalesce_kernel(const float* __restrict__ gout,
                                const int* __restrict__ head_of, int B, int D,
                                float* __restrict__ gsum) {
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const long long h = head_of[b];
  for (int d = threadIdx.x & 31; d < D; d += 32) atomicAdd(gsum + h * D + d, gout[b * D + d]);
}

__global__ void __launch_bounds__(kThreads)
backward_pieces_kernel(const int* __restrict__ ptr, const int* __restrict__ cols,
                       const float* __restrict__ gsum, const int* __restrict__ ids,
                       const int* __restrict__ piece_start, int B, int D,
                       float* __restrict__ dtable) {
  const int lane = threadIdx.x & 31;
  const int total = piece_start[B];
  for (int w = blockIdx.x * kWarps + (threadIdx.x >> 5); w < total; w += gridDim.x * kWarps) {
    const int b = head_of_piece(piece_start, B, w);
    const int r = ids[b];
    const int j0 = ptr[r] + (w - piece_start[b]) * kPiece;
    const int n = min(kPiece, ptr[r + 1] - j0);
    const int my_col = lane < n ? cols[j0 + lane] : 0;
    const float* g = gsum + (long long)b * D;
    for (int d0 = 0; d0 < D; d0 += kSlice) {
      float gv[kLanes];
#pragma unroll
      for (int t = 0; t < kLanes; ++t) {
        const int d = d0 + lane + 32 * t;
        gv[t] = d < D ? g[d] : 0.f;
      }
      for (int i = 0; i < n; ++i) {
        float* row = dtable + (long long)__shfl_sync(0xffffffffu, my_col, i) * D;
#pragma unroll
        for (int t = 0; t < kLanes; ++t) {
          const int d = d0 + lane + 32 * t;
          if (d < D) atomicAdd(row + d, gv[t]);
        }
      }
    }
  }
}

// the float32 gradient table rounded once into the 16-bit one
template <typename T>
__global__ void round_kernel(const float* __restrict__ src, long long n, T* __restrict__ dst) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads)
    dst[i] = narrow<T>(src[i]);
}

int plan(const int* ptr, int R, const int* ids, int B, int* firstpos, int* head_of,
         int* piece_start, cudaStream_t st) {
  first_position_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, st>>>(ids, B, R, firstpos);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  plan_kernel<<<1, kPlanThreads, 0, st>>>(ids, ptr, firstpos, B, R, head_of, piece_start);
  return (int)cudaGetLastError();
}

template <typename T>
int forward_launch(const void* ptr, const void* cols, int R, const void* table, int D,
                   const void* ids, int B, void* firstpos, void* head_of, void* piece_start,
                   void* out, cudaStream_t st) {
  if (B <= 0) return (int)cudaGetLastError();
  const int* p = (const int*)ptr;
  const int* id = (const int*)ids;
  int* ho = (int*)head_of;
  int* ps = (int*)piece_start;
  int e = plan(p, R, id, B, (int*)firstpos, ho, ps, st);
  if (e != 0) return e;
  forward_pieces_kernel<T><<<kGrid, kThreads, 0, st>>>(p, (const int*)cols, (const T*)table,
                                                       id, ps, B, D, (float*)out);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  copy_from_head_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0, st>>>(ho, B, D, (float*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int round_launch(const float* src, long long n, void* dst, cudaStream_t st) {
  if (n <= 0) return (int)cudaGetLastError();
  const long long blocks = (n + kThreads - 1) / kThreads;
  round_kernel<T><<<(unsigned)(blocks < kGrid ? blocks : kGrid), kThreads, 0, st>>>(src, n,
                                                                                   (T*)dst);
  return (int)cudaGetLastError();
}

}  // namespace

// ptr: [R + 1], cols: [nnz] (each row's distinct entries); table: [N, D] of
// the type of dtype (0 float32, 1 bfloat16, 2 float16); ids: [B]; firstpos:
// [R] filled with INT_MAX; head_of: [B]; piece_start: [B + 1]; out: float32
// [B, D], zeroed
extern "C" int rating_vector_forward(const void* ptr, const void* cols, int R,
                                     const void* table, int D, const void* ids, int B,
                                     void* firstpos, void* head_of, void* piece_start,
                                     void* out, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define B11_FWD(T) \
  forward_launch<T>(ptr, cols, R, table, D, ids, B, firstpos, head_of, piece_start, out, st)
  if (dtype == 0) return B11_FWD(float);
  if (dtype == 1) return B11_FWD(__nv_bfloat16);
  if (dtype == 2) return B11_FWD(__half);
#undef B11_FWD
  return (int)cudaErrorInvalidValue;
}

// gout: float32 [B, D]; gsum: [B, D] zeroed scratch; dtable: float32 [N, D],
// zeroed (the gradient for dtype 0, else the scratch the 16-bit gradient
// dtable16 [N, D] of the table's type is rounded from); the rest as in the
// forward
extern "C" int rating_vector_backward(const void* ptr, const void* cols, int R,
                                      const void* gout, int D, const void* ids, int B,
                                      void* firstpos, void* head_of, void* piece_start,
                                      void* gsum, void* dtable, int N, int dtype,
                                      void* dtable16, void* stream) {
  if (dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (B > 0) {
    const int* p = (const int*)ptr;
    const int* id = (const int*)ids;
    int* ho = (int*)head_of;
    int* ps = (int*)piece_start;
    int e = plan(p, R, id, B, (int*)firstpos, ho, ps, st);
    if (e != 0) return e;
    coalesce_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0, st>>>((const float*)gout, ho, B,
                                                                     D, (float*)gsum);
    e = (int)cudaGetLastError();
    if (e != 0) return e;
    backward_pieces_kernel<<<kGrid, kThreads, 0, st>>>(p, (const int*)cols, (const float*)gsum,
                                                       id, ps, B, D, (float*)dtable);
    e = (int)cudaGetLastError();
    if (e != 0) return e;
  }
  const long long n = (long long)N * D;
  if (dtype == 1) return round_launch<__nv_bfloat16>((const float*)dtable, n, dtable16, st);
  if (dtype == 2) return round_launch<__half>((const float*)dtable, n, dtable16, st);
  return (int)cudaGetLastError();
}
