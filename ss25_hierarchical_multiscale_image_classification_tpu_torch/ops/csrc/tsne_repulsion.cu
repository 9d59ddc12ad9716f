// t-SNE's exact repulsion over all pairs of a 2-D embedding, for sm_90a: the
// O(N^2) half of the KL gradient at one degree of freedom,
//   neg[i] = sum_{j != i} q_ij^2 (y_i - y_j),  sum_q = sum_{i != j} q_ij,
//   q_ij = 1 / (1 + |y_i - y_j|^2),
// the repulsive term that sklearn's Barnes-Hut gradient approximates and that
// the port computes exactly (Barnes-Hut at angle = 0).
//
// What bounds it: issue slots. q_ij = q_ji, so each unordered pair {i < j} is
// taken once: its t = q^2 (y_i - y_j) is added to row i and subtracted from
// row j, and its q is summed once (the total doubled at the end, exactly).
// A pair costs 10 FP32 instructions (2 subtracts, 2 FMAs for d^2 + 1, the
// add into sum_q, q^2, 4 FMAs into the row and column accumulators) and one
// rcp.approx on the special-function unit (16 a clock per SM against 128 FP32
// issue slots, so it keeps pace). Nothing is read twice from device memory.
//
// The tiling (this file alone knows it; the caller asks
// hipac_tsne_repulsion_scratch for the scratch a call takes):
// - Rows come in strips of kStrip = 2048, a block's 8 warps of 256 rows, a
//   lane's kR = 8 rows in registers. A strip pairs with the columns from its
//   own first row to n, in items of kChunk = 128 columns, so strip s has
//   ceil(n / 128) - 16 s items, and a linear list of all (strip, item) pairs
//   is cut into equal contiguous pieces, one a block, with the grid sized from
//   the SM count: the short strips at the end leave no tail, and small N still
//   fills the card.
// - Each warp holds its own copy of the item's 128 columns in shared memory,
//   (x, y, cx, cy) in 32 groups of kC = 4. In step s of 32, lane l takes group
//   (l + s) mod 32: a column load feeds kR pairs, and the column accumulators
//   move through shared memory from lane to lane, so no two lanes touch one
//   column at once and no reduction is needed inside the warp.
// - An item whose columns reach into the warp's rows (the strip's first 16
//   items) or past n takes the masked path: the pair counts iff i < j < n, so
//   the diagonal is excluded by index, never by distance (coincident points
//   count q = 1). A warp whose rows all lie above the item's columns skips it.
//
// Fixed-order sums, no atomic adds, so a call repeats bit for bit on a card;
// no float32 chain holds more than 256 terms before a float64 accumulator
// (float64 works in float64 throughout):
// - a row's float32 partial over an item (128 terms) goes into a float64
//   accumulator in shared memory; a run of items of one strip in one block
//   (a segment) writes its rows' sums to scratch slot (block + strip);
// - a column's float32 partial over a warp's 256 rows (the lanes in turn)
//   is summed over the 8 warps in float64 and written to scratch, one slot a
//   (item, column);
// - each lane sums its rows' q over half an item (64 terms) in float32, then
//   in float64; the block's sum by a fixed tree goes to scratch.
// A second launch sums each row's slots in a fixed order (its strip's
// segments by block, then every strip's column partial by strip), and its
// block 0 sums the blocks' q in a fixed order: two launches a call.
//
// In float32 the reciprocal is the hardware approximation (rcp.approx,
// d^2 + 1 >= 1, so never subnormal); float64 divides.
//
// Built by ops/build.py (nvcc, plain C entry point, no PyTorch headers).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kR = 8;                          // rows a lane
constexpr int kC = 4;                          // columns a lane a step
constexpr int kWarpRows = 32 * kR;             // 256
constexpr int kStrip = kWarps * kWarpRows;     // 2048 rows a strip
constexpr int kChunk = 32 * kC;                // 128 columns an item
constexpr int kItemsPerStrip = kStrip / kChunk;  // 16
constexpr int kBlocksPerSm = 2;
constexpr int kMaxDevices = 64;

static_assert(kStrip % kChunk == 0, "a strip is a whole number of items");

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using two = float2;
  using four = float4;
  __host__ __device__ static float2 make(float x, float y) { return make_float2(x, y); }
};
struct __align__(32) Double4 {
  double x, y, z, w;
};
template <>
struct Vec<double> {
  using two = double2;
  using four = Double4;
  __host__ __device__ static double2 make(double x, double y) { return make_double2(x, y); }
};

__device__ __forceinline__ float recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ double recip(double x) { return 1.0 / x; }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// The work list for n rows on `sms` SMs.
struct Plan {
  long long n;
  long long chunks;   // items of strip 0: ceil(n / kChunk)
  long long strips;   // ceil(n / kStrip)
  long long items;    // (strip, item) pairs in all
  long long per;      // items a block
  int blocks;
};

// Items of the strips before `strip`: strip s has chunks - kItemsPerStrip s.
__host__ __device__ __forceinline__ long long items_before(long long strip,
                                                           long long chunks) {
  return strip * chunks - kItemsPerStrip * strip * (strip - 1) / 2;
}

Plan make_plan(long long n, int sms) {
  Plan p;
  p.n = n;
  p.chunks = (n + kChunk - 1) / kChunk;
  p.strips = (n + kStrip - 1) / kStrip;
  p.items = items_before(p.strips, p.chunks);
  const long long want = static_cast<long long>(kBlocksPerSm) * sms;
  const long long blocks = p.items < want ? p.items : want;
  p.per = (p.items + blocks - 1) / blocks;
  p.blocks = static_cast<int>((p.items + p.per - 1) / p.per);
  return p;
}

// Scratch, in float64 elements: the column partials (x, y) of every item's
// columns, the row partials (x, y) of every segment's strip, the blocks' q.
long long col_part_len(const Plan& p) { return 2LL * kChunk * p.items; }
long long row_part_len(const Plan& p) { return 2LL * kStrip * (p.blocks + p.strips); }
long long scratch_len(const Plan& p) { return col_part_len(p) + row_part_len(p) + p.blocks; }

// One warp's 256 rows (xi, yi, a lane's kR) against an item's 128 columns in
// the warp's copy `tile` ([kC][32] of (x, y, cx, cy)): steps s0 .. s0 + 15 of
// 32, lane l taking group (l + s) mod 32 in step s. kMask: the pair counts iff
// j > i and j < n (indices relative to the strip's first row: i0 the lane's
// first row, c0 the item's first column, n_rel the rows left from the strip's
// first).
template <typename T, bool kMask>
__device__ __forceinline__ void warp_steps(typename Vec<T>::four (*tile)[32],
                                           int s0, const T* xi, const T* yi,
                                           T* rx, T* ry, T* sq, int lane,
                                           int i0, int c0, int n_rel) {
  using V4 = typename Vec<T>::four;
  using V2 = typename Vec<T>::two;
#pragma unroll 2
  for (int s = s0; s < s0 + 16; ++s) {
    const int g = (lane + s) & 31;
    V4 v[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) v[c] = tile[c][g];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const T dx = xi[r] - v[c].x;
        const T dy = yi[r] - v[c].y;
        T q = recip(fma_rn(dx, dx, fma_rn(dy, dy, T(1))));
        if constexpr (kMask) {
          const int j = c0 + c * 32 + g;
          if (j <= i0 + r * 32 || j >= n_rel) q = T(0);
        }
        sq[r] += q;
        const T q2 = q * q;
        rx[r] = fma_rn(q2, dx, rx[r]);
        ry[r] = fma_rn(q2, dy, ry[r]);
        v[c].z = fma_rn(-q2, dx, v[c].z);
        v[c].w = fma_rn(-q2, dy, v[c].w);
      }
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      *reinterpret_cast<V2*>(&tile[c][g].z) = Vec<T>::make(v[c].z, v[c].w);
    }
    __syncwarp();
  }
}

template <typename T>
struct MinBlocks {
  static constexpr int value = std::is_same<T, float>::value ? kBlocksPerSm : 1;
};

// A lane's rows from r0 on (r0 + 32 r, zeros past n), and its accumulators at
// 0: float32 keeps the segment's sums in float64 in shared memory (racc, the
// lane's kR entries 32 apart), float64 in rx, ry.
template <typename T>
__device__ __forceinline__ void start_segment(const typename Vec<T>::two* y,
                                              long long n, long long r0, T* xi,
                                              T* yi, T* rx, T* ry,
                                              double2* racc) {
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const long long i = r0 + r * 32;
    const typename Vec<T>::two v = i < n ? y[i] : Vec<T>::make(T(0), T(0));
    xi[r] = v.x;
    yi[r] = v.y;
    rx[r] = ry[r] = T(0);
    if constexpr (std::is_same<T, float>::value) racc[r * 32] = make_double2(0.0, 0.0);
  }
}

// Launch 1: every unordered pair once. col_part: (items, kChunk) of (x, y);
// row_part: (blocks + strips, kStrip) of (x, y); block_q: (blocks).
template <typename T>
__global__ void __launch_bounds__(kThreads, MinBlocks<T>::value)
repulsion_pairs(const typename Vec<T>::two* __restrict__ y, Plan p,
                double2* __restrict__ col_part, double2* __restrict__ row_part,
                double* __restrict__ block_q) {
  using V2 = typename Vec<T>::two;
  using V4 = typename Vec<T>::four;
  constexpr bool kF32 = std::is_same<T, float>::value;
  __shared__ V4 tile[kWarps][kC][32];
  // float32: the segment's float64 row sums (x, y), [warp][r][lane]
  __shared__ double2 racc[kF32 ? kWarps * kR * 32 : 1];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lo = warp * kWarpRows;  // the warp's rows [lo, lo + 256) in a strip
  const int i0 = lo + lane;         // the lane's first row in a strip
  double2* my_racc = racc + (kF32 ? warp * kR * 32 + lane : 0);
  const long long first = static_cast<long long>(blockIdx.x) * p.per;
  const long long last = first + p.per < p.items ? first + p.per : p.items;
  long long strip = 0;
  while (items_before(strip + 1, p.chunks) <= first) ++strip;
  long long k = first - items_before(strip, p.chunks);

  T xi[kR], yi[kR], rx[kR], ry[kR], sq[kR];
  double q64 = 0.0;
  start_segment<T>(y, p.n, strip * kStrip + i0, xi, yi, rx, ry, my_racc);

  for (long long it = first; it < last; ++it) {
    const long long s0 = strip * kStrip;  // the strip's first row
    const int c0 = static_cast<int>(k * kChunk);  // from s0
    const int n_rel = static_cast<int>(p.n - s0);
    // this warp's copy of the item's columns, their accumulators at 0
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int j = c0 + c * 32 + lane;
      const V2 v = j < n_rel ? y[s0 + j] : Vec<T>::make(T(0), T(0));
      V4 t;
      t.x = v.x;
      t.y = v.y;
      t.z = t.w = T(0);
      tile[warp][c][lane] = t;
    }
    __syncwarp();
    if constexpr (kF32) {
#pragma unroll
      for (int r = 0; r < kR; ++r) rx[r] = ry[r] = T(0);
    }
    const int c_end = c0 + kChunk < n_rel ? c0 + kChunk : n_rel;
    // none of the item's columns above the warp's rows: nothing to take
    const bool skip = c_end - 1 <= lo;
    const bool full = c0 >= lo + kWarpRows && c0 + kChunk <= n_rel;
    for (int half = 0; half < 32 && !skip; half += 16) {
#pragma unroll
      for (int r = 0; r < kR; ++r) sq[r] = T(0);
      if (full) {
        warp_steps<T, false>(tile[warp], half, xi, yi, rx, ry, sq, lane, i0, c0, n_rel);
      } else {
        warp_steps<T, true>(tile[warp], half, xi, yi, rx, ry, sq, lane, i0, c0, n_rel);
      }
      // q's chains: 64 terms
#pragma unroll
      for (int r = 0; r < kR; ++r) q64 += static_cast<double>(sq[r]);
    }
    if constexpr (kF32) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        double2 a = my_racc[r * 32];
        a.x += static_cast<double>(rx[r]);
        a.y += static_cast<double>(ry[r]);
        my_racc[r * 32] = a;
      }
    }
    __syncthreads();
    // the item's column partials over the warps: value t is column t / 2,
    // coordinate t % 2
    for (int t = threadIdx.x; t < 2 * kChunk; t += kThreads) {
      const int col = t >> 1, c = col >> 5, g = col & 31;
      double s = 0.0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s += static_cast<double>(t & 1 ? tile[w][c][g].w : tile[w][c][g].z);
      }
      reinterpret_cast<double*>(col_part + it * kChunk)[t] = s;
    }
    __syncthreads();

    if (++k == p.chunks - kItemsPerStrip * strip || it + 1 == last) {
      // the segment ends: its rows' sums to slot (block + strip)
      double2* out = row_part + (blockIdx.x + strip) * kStrip + i0;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if constexpr (kF32) {
          out[r * 32] = my_racc[r * 32];
        } else {
          out[r * 32] = make_double2(rx[r], ry[r]);
        }
      }
      if (it + 1 < last) {
        ++strip;
        k = 0;
        start_segment<T>(y, p.n, strip * kStrip + i0, xi, yi, rx, ry, my_racc);
      }
    }
  }

  // the block's q by a fixed tree (tile is free: every warp is past it)
  double* red = reinterpret_cast<double*>(tile);
  red[threadIdx.x] = q64;
  __syncthreads();
#pragma unroll
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (static_cast<int>(threadIdx.x) < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) block_q[blockIdx.x] = red[0];
}

// Launch 2: neg[i] = its strip's segments by block, then every strip's
// column partial by strip; block 0 also writes sum_q = 2 * the blocks' q.
template <typename T>
__global__ void __launch_bounds__(kThreads)
repulsion_rows(const double2* __restrict__ col_part,
               const double2* __restrict__ row_part,
               const double* __restrict__ block_q, Plan p,
               typename Vec<T>::two* __restrict__ neg,
               double* __restrict__ sum_q) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < p.n) {
    const long long strip = i / kStrip;
    const long long b_first = items_before(strip, p.chunks) / p.per;
    const long long b_last = (items_before(strip + 1, p.chunks) - 1) / p.per;
    double x = 0.0, yv = 0.0;
    for (long long b = b_first; b <= b_last; ++b) {
      const double2 v = row_part[(b + strip) * kStrip + (i - strip * kStrip)];
      x += v.x;
      yv += v.y;
    }
    for (long long s = 0; s <= strip; ++s) {
      const long long j = i - s * kStrip;  // column i within strip s's columns
      const double2 v = col_part[(items_before(s, p.chunks) + j / kChunk) * kChunk + j % kChunk];
      x += v.x;
      yv += v.y;
    }
    neg[i] = Vec<T>::make(static_cast<T>(x), static_cast<T>(yv));
  }
  if (blockIdx.x == 0) {
    __shared__ double red[kThreads];
    double s = 0.0;
    for (int b = threadIdx.x; b < p.blocks; b += kThreads) s += block_q[b];
    red[threadIdx.x] = s;
    __syncthreads();
#pragma unroll
    for (int w = kThreads / 2; w > 0; w >>= 1) {
      if (static_cast<int>(threadIdx.x) < w) red[threadIdx.x] += red[threadIdx.x + w];
      __syncthreads();
    }
    if (threadIdx.x == 0) *sum_q = 2.0 * red[0];
  }
}

// The current device's SM count (asked once a device), or a negative
// cudaError_t.
int current_sms() {
  static std::atomic<int> cached[kMaxDevices];  // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const bool cacheable = dev >= 0 && dev < kMaxDevices;
  if (cacheable) {
    const int sms = cached[dev].load(std::memory_order_relaxed);
    if (sms > 0) return sms;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (sms <= 0) return -static_cast<int>(cudaErrorInvalidValue);
  if (cacheable) cached[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

template <typename T>
int launch(const void* y, void* neg, void* sum_q, double* scratch,
           const Plan& p, cudaStream_t stream) {
  using V2 = typename Vec<T>::two;
  if (reinterpret_cast<uintptr_t>(y) % sizeof(V2) ||
      reinterpret_cast<uintptr_t>(neg) % sizeof(V2) ||
      reinterpret_cast<uintptr_t>(scratch) % sizeof(double2)) {
    return cudaErrorInvalidValue;
  }
  double2* col_part = reinterpret_cast<double2*>(scratch);
  double2* row_part = reinterpret_cast<double2*>(scratch + col_part_len(p));
  double* block_q = scratch + col_part_len(p) + row_part_len(p);
  repulsion_pairs<T><<<p.blocks, kThreads, 0, stream>>>(
      static_cast<const V2*>(y), p, col_part, row_part, block_q);
  const long long row_blocks = (p.n + kThreads - 1) / kThreads;
  repulsion_rows<T><<<static_cast<unsigned int>(row_blocks), kThreads, 0, stream>>>(
      col_part, row_part, block_q, p, static_cast<V2*>(neg),
      static_cast<double*>(sum_q));
  return static_cast<int>(cudaGetLastError());
}

// n within what the kernels index with 32-bit offsets inside a strip.
bool valid_n(long long n) { return n >= 2 && n <= 0x7fffffffLL - kStrip; }

}  // namespace

// The float64 elements of scratch that a call on n >= 2 rows takes on the
// current device, or a negative cudaError_t.
extern "C" long long hipac_tsne_repulsion_scratch(long long n) {
  if (!valid_n(n)) return -static_cast<long long>(cudaErrorInvalidValue);
  const int sms = current_sms();
  return sms < 0 ? sms : scratch_len(make_plan(n, sms));
}

// y: (n, 2) contiguous, float32 (is_double = 0) or float64 (1); neg: (n, 2) of
// y's type; sum_q: one float64; scratch: scratch_elems float64, at least what
// hipac_tsne_repulsion_scratch(n) gives on this device, 16-byte aligned.
// 2 <= n. Two launches on `stream`. Returns a cudaError_t as int (0 =
// launched).
extern "C" int hipac_tsne_repulsion(const void* y, void* neg, void* sum_q,
                                    void* scratch, long long scratch_elems,
                                    long long n, int is_double, void* stream) {
  if (!valid_n(n)) return cudaErrorInvalidValue;
  const int sms = current_sms();
  if (sms < 0) return -sms;
  const Plan p = make_plan(n, sms);
  if (scratch_elems < scratch_len(p)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* part = static_cast<double*>(scratch);
  return is_double ? launch<double>(y, neg, sum_q, part, p, s)
                   : launch<float>(y, neg, sum_q, part, p, s);
}
