// t-SNE's exact repulsion over all pairs of a 2-D embedding, for sm_90a: the
// O(N^2) half of the KL gradient at one degree of freedom,
//   neg[i] = sum_{j != i} q_ij^2 (y_i - y_j),  sum_q = sum_{i != j} q_ij,
//   q_ij = 1 / (1 + |y_i - y_j|^2),
// the repulsive term that sklearn's Barnes-Hut gradient approximates and that
// the port computes exactly (Barnes-Hut at angle = 0).
//
// What bounds it: the reciprocal, one a pair, which the special-function unit
// issues at 16 a clock per SM; the other ~7 FP32 instructions a pair come
// close behind. Nothing is read twice from device memory: a block of 256
// threads owns 512 rows (two a thread, y_i in registers) and walks a range of
// columns in tiles of 256 staged in shared memory, where every thread reads
// the same y_j (a broadcast). Each thread sums a tile's pairs in the working
// type, then adds the tile's partial into float64 row accumulators, so that a
// float32 chain holds at most 256 terms. In float32 the reciprocal is the
// hardware approximation (rcp.approx, d^2 >= 1, so never subnormal); float64
// divides.
//
// Columns are split into ranges (the grid's y) so that small N still fills the
// card: at least kBlocksPerSm blocks an SM where N allows, from the current
// device's SM count. Each (row tile, range) block writes its partial rows to
// scratch, and a second launch sums the ranges of each row in a fixed order,
// with the rows' sum_q reduced by a fixed tree a block and a third, one-block
// launch summing the blocks' sums in a fixed order. No atomic adds: a call
// repeats bit for bit on a card. This file alone knows the tiling: the caller
// asks hipac_tsne_repulsion_scratch for the scratch a call needs.
//
// The diagonal (q_ii = 1) is left out of sum_q by a predicate, only in the
// tiles that hold a row of the block; its difference is 0, so neg needs none.
// The last tile of a range is cut by count, never padded.
//
// Built by ops/build.py (nvcc, plain C entry point, no PyTorch headers).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 2;  // rows a thread
constexpr int kRowsPerBlock = kThreads * kRows;
constexpr int kColTile = kThreads;  // columns a shared-memory tile, one a thread
constexpr int kBlocksPerSm = 4;     // the grid's least blocks an SM where N allows

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
  __device__ static float2 make(float x, float y) { return make_float2(x, y); }
};
template <>
struct Vec2<double> {
  using type = double2;
  __device__ static double2 make(double x, double y) { return make_double2(x, y); }
};

__device__ __forceinline__ float recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ double recip(double x) { return 1.0 / x; }

// One tile's pairs for the thread's rows, into nx, ny, sq (the working type).
// kDiag: the tile may hold one of the rows, so j == i is left out of sq.
// kFull: the tile holds kColTile columns (a constant trip count).
template <typename T, bool kDiag, bool kFull>
__device__ __forceinline__ void tile_pairs(const typename Vec2<T>::type* tile,
                                           int count, long long c0,
                                           const typename Vec2<T>::type* yi,
                                           const long long* row, T* nx, T* ny,
                                           T* sq) {
  const int m = kFull ? kColTile : count;
#pragma unroll 8
  for (int j = 0; j < m; ++j) {
    const typename Vec2<T>::type yj = tile[j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const T dx = yi[r].x - yj.x;
      const T dy = yi[r].y - yj.y;
      const T q = recip(dx * dx + dy * dy + T(1));
      if (kDiag) {
        sq[r] += c0 + j == row[r] ? T(0) : q;
      } else {
        sq[r] += q;
      }
      const T q2 = q * q;
      nx[r] += q2 * dx;
      ny[r] += q2 * dy;
    }
  }
}

// part: (splits, 3, n) float64, the (neg x, neg y, sum_q) of each row over
// the block's column range.
template <typename T>
__global__ void __launch_bounds__(kThreads)
repulsion_pairs(const typename Vec2<T>::type* __restrict__ y,
                double* __restrict__ part, long long n,
                long long cols_per_split) {
  using V = typename Vec2<T>::type;
  __shared__ V tile[kColTile];
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  const int split = blockIdx.y;
  const long long c_begin = split * cols_per_split;
  const long long c_end = c_begin + cols_per_split < n ? c_begin + cols_per_split : n;
  V yi[kRows];
  long long row[kRows];
  double ax[kRows], ay[kRows], as[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    row[r] = row0 + r * kThreads + threadIdx.x;
    yi[r] = row[r] < n ? y[row[r]] : Vec2<T>::make(T(0), T(0));
    ax[r] = ay[r] = as[r] = 0.0;
  }
  for (long long c0 = c_begin; c0 < c_end; c0 += kColTile) {
    const int count = c_end - c0 < kColTile ? static_cast<int>(c_end - c0) : kColTile;
    __syncthreads();  // the previous tile is read by every thread
    if (static_cast<int>(threadIdx.x) < count) tile[threadIdx.x] = y[c0 + threadIdx.x];
    __syncthreads();
    T nx[kRows], ny[kRows], sq[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) nx[r] = ny[r] = sq[r] = T(0);
    const bool diag = c0 < row0 + kRowsPerBlock && row0 < c0 + count;
    if (diag) {
      tile_pairs<T, true, false>(tile, count, c0, yi, row, nx, ny, sq);
    } else if (count == kColTile) {
      tile_pairs<T, false, true>(tile, count, c0, yi, row, nx, ny, sq);
    } else {
      tile_pairs<T, false, false>(tile, count, c0, yi, row, nx, ny, sq);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ax[r] += static_cast<double>(nx[r]);
      ay[r] += static_cast<double>(ny[r]);
      as[r] += static_cast<double>(sq[r]);
    }
  }
  double* out = part + static_cast<long long>(split) * 3 * n;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row[r] < n) {
      out[row[r]] = ax[r];
      out[n + row[r]] = ay[r];
      out[2 * n + row[r]] = as[r];
    }
  }
}

// Sum of a block's values by a fixed tree; every thread takes part.
__device__ __forceinline__ double block_sum(double v, double* red) {
  red[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (static_cast<int>(threadIdx.x) < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  return red[0];
}

// neg[i] = the ranges' partials summed in order; block_sums[b] = the block's
// rows' sum_q.
template <typename T>
__global__ void __launch_bounds__(kThreads)
repulsion_rows(const double* __restrict__ part, int splits, long long n,
               typename Vec2<T>::type* __restrict__ neg,
               double* __restrict__ block_sums) {
  __shared__ double red[kThreads];
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  double s = 0.0;
  if (i < n) {
    double x = 0.0, yv = 0.0;
    for (int k = 0; k < splits; ++k) {
      const double* p = part + static_cast<long long>(k) * 3 * n;
      x += p[i];
      yv += p[n + i];
      s += p[2 * n + i];
    }
    neg[i] = Vec2<T>::make(static_cast<T>(x), static_cast<T>(yv));
  }
  const double total = block_sum(s, red);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = total;
}

// sum_q = the blocks' sums, a strided sum a thread and a fixed tree.
__global__ void __launch_bounds__(kThreads)
repulsion_total(const double* __restrict__ block_sums, long long blocks,
                double* __restrict__ sum_q) {
  __shared__ double red[kThreads];
  double s = 0.0;
  for (long long b = threadIdx.x; b < blocks; b += kThreads) s += block_sums[b];
  const double total = block_sum(s, red);
  if (threadIdx.x == 0) *sum_q = total;
}

// The column ranges for n rows on `sms` SMs, and the float64 scratch they
// take: (splits, 3, n) partial rows, then one sum_q a rows-launch block.
int column_splits(long long n, int sms) {
  const long long row_tiles = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long want = (static_cast<long long>(kBlocksPerSm) * sms + row_tiles - 1) / row_tiles;
  long long splits = want < n ? want : n;
  if (splits > 65535) splits = 65535;
  return splits < 1 ? 1 : static_cast<int>(splits);
}

long long scratch_len(long long n, int splits) {
  return 3LL * splits * n + (n + kThreads - 1) / kThreads;
}

// The current device's SM count, or a negative cudaError_t.
int current_sms() {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  return sms > 0 ? sms : -static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const void* y, void* neg, void* sum_q, double* scratch, long long n,
           int splits, cudaStream_t stream) {
  using V = typename Vec2<T>::type;
  if (reinterpret_cast<uintptr_t>(y) % sizeof(V) ||
      reinterpret_cast<uintptr_t>(neg) % sizeof(V)) {
    return cudaErrorInvalidValue;
  }
  const long long row_tiles = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long row_blocks = (n + kThreads - 1) / kThreads;
  if (row_tiles > 0x7fffffffLL || row_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long cols_per_split = (n + splits - 1) / splits;
  double* block_sums = scratch + 3LL * splits * n;
  repulsion_pairs<T><<<dim3(static_cast<unsigned int>(row_tiles), splits), kThreads,
                       0, stream>>>(static_cast<const V*>(y), scratch, n, cols_per_split);
  repulsion_rows<T><<<static_cast<unsigned int>(row_blocks), kThreads, 0, stream>>>(
      scratch, splits, n, static_cast<V*>(neg), block_sums);
  repulsion_total<<<1, kThreads, 0, stream>>>(block_sums, row_blocks,
                                             static_cast<double*>(sum_q));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The float64 elements of scratch that a call on n >= 2 rows takes on the
// current device, or a negative cudaError_t.
extern "C" long long hipac_tsne_repulsion_scratch(long long n) {
  if (n < 2) return -static_cast<long long>(cudaErrorInvalidValue);
  const int sms = current_sms();
  return sms < 0 ? sms : scratch_len(n, column_splits(n, sms));
}

// y: (n, 2) contiguous, float32 (is_double = 0) or float64 (1); neg: (n, 2) of
// y's type; sum_q: one float64; scratch: scratch_len float64, at least what
// hipac_tsne_repulsion_scratch(n) gives on this device. 2 <= n. Three launches
// on `stream`. Returns a cudaError_t as int (0 = launched).
extern "C" int hipac_tsne_repulsion(const void* y, void* neg, void* sum_q,
                                    void* scratch, long long scratch_elems,
                                    long long n, int is_double, void* stream) {
  if (n < 2) return cudaErrorInvalidValue;
  const int sms = current_sms();
  if (sms < 0) return -sms;
  const int splits = column_splits(n, sms);
  if (scratch_elems < scratch_len(n, splits)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* part = static_cast<double*>(scratch);
  return is_double ? launch<double>(y, neg, sum_q, part, n, splits, s)
                   : launch<float>(y, neg, sum_q, part, n, splits, s);
}
