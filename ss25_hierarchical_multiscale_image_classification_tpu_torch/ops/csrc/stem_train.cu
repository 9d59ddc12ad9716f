// The training stem after conv1, for sm_90a: batch-statistics BatchNorm
// (flax's running statistics), ReLU and the 3x3 stride-2 maxpool with -inf
// padding, forward and backward, over conv1's bf16 output with 64 channels
// in NHWC memory (channels-last).
//
// The JAX package has no kernel for it: XLA fuses the stem of its training
// step. In PyTorch the same chain is eight passes over the largest plane of
// ResNet18 (BN statistics, BN, ReLU and maxpool forward; maxpool, ReLU and
// BN backward in two), and autograd keeps the BN output and int64 pool
// indices, 10 bytes an element beside the 2 of the plane. Every pass is
// bound by bytes, so the design moves fewer:
//
//   forward   stats: read x once; per-channel mean and biased variance by
//                    Welford/Chan merges (6.4 M elements a channel cancel
//                    badly in a sum of squares), the blocks' partials merged
//                    in double by the last block to take a ticket, which
//                    also moves the running statistics (momentum toward the
//                    biased variance, as flax does).
//             pool:  read x, write the pooled bf16 plane and one uint8 window
//                    position a pooled element (the first maximum in
//                    row-major window order, max_pool2d's tie rule).
//   backward  reduce: read x, dy and the codes; route each dy to the element
//                    its code names (up to four windows an element, summed
//                    in float32 in max_pool2d's order, rounded to bf16),
//                    mask by the recomputed bf16 ReLU output, and sum g and
//                    g * xhat per channel (the last block writes dbeta and
//                    dgamma).
//             apply: read them again and write dx = gamma * invstd * (g -
//                    sum(g)/n - xhat * sum(g * xhat)/n) in bf16.
//
// Nothing but x, the codes and the statistics is kept between forward and
// backward. A thread owns 8 channels (one 16-byte load) of one pooled column
// and walks a band of kBand pooled rows: the last input row of a window is
// the first of the next one's, so it stays in registers, and the column a
// window shares with its neighbour comes from L1. Every sum is taken in a
// fixed order: two calls on the same input give the same bits.
//
// Built by ops/build.py (nvcc, plain C entry points, no PyTorch headers).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kC = 64;                 // channels of the stem
constexpr int kVec = 8;                // channels a thread: one 16-byte load
constexpr int kGroups = kC / kVec;     // threads a pixel
constexpr int kThreads = 256;
constexpr int kLanes = kThreads / kGroups;  // pixels a block step
constexpr int kUnroll = 16;            // pixels a statistics thread loads at once
constexpr int kChunk = kLanes * kUnroll;
constexpr int kBand = 8;               // pooled rows a thread walks
// The pool kernel fits in 64 registers without spilling: four blocks a
// multiprocessor run it a quarter faster than the compiler's 92 registers.
constexpr int kPoolBlocksPerSM = 4;
constexpr int kQuarters = kThreads / kC;

__device__ __forceinline__ void unpack8(const uint4 raw, float (&f)[kVec]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

__device__ __forceinline__ uint4 pack8(const float (&f)[kVec]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The channel parameters a thread needs, for its 8 channels.
struct Params {
  float mean[kVec], invstd[kVec], scale[kVec], beta[kVec];
};

__device__ __forceinline__ void load_params(const float* __restrict__ stats,
                                            const float* __restrict__ gamma,
                                            const float* __restrict__ beta,
                                            int cg, Params& p) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int c = cg * kVec + j;
    p.mean[j] = stats[c];
    p.invstd[j] = stats[kC + c];
    p.scale[j] = p.invstd[j] * gamma[c];
    p.beta[j] = beta[c];
  }
}

// bf16(BN(x)) of 8 channels of one pixel, as float (exact bf16 values).
__device__ __forceinline__ void bn8(const float (&f)[kVec], const Params& p,
                                    float (&y)[kVec]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    y[j] = bf16_round(fmaf(f[j] - p.mean[j], p.scale[j], p.beta[j]));
}

// ---------------------------------------------------------------------------
// forward: statistics
// ---------------------------------------------------------------------------

// Chan's merge of (nb, mb, m2b) into (n, m, m2).
__device__ __forceinline__ void chan(double& n, double& m, double& m2,
                                     double nb, double mb, double m2b) {
  if (nb == 0.0) return;
  const double nn = n + nb, d = mb - m;
  m += d * (nb / nn);
  m2 += m2b + d * d * (n * nb / nn);
  n = nn;
}

__global__ void __launch_bounds__(kThreads)
hipac_stem_train_stats(const uint4* __restrict__ x, long long rows,
                       float* __restrict__ part, int* __restrict__ ticket,
                       float eps, float momentum, float* __restrict__ stats,
                       float* __restrict__ running_mean,
                       float* __restrict__ running_var) {
  __shared__ float s_mean[kLanes][kC];
  __shared__ float s_m2[kLanes][kC];
  __shared__ float s_n[kLanes];
  __shared__ double s_q[3][kQuarters][kC];
  __shared__ bool last;
  const int tid = threadIdx.x, cg = tid % kGroups, lane = tid / kGroups;

  float n = 0.f, mean[kVec], m2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) mean[j] = m2[j] = 0.f;
  const long long chunks = (rows + kChunk - 1) / kChunk;
  for (long long q = blockIdx.x; q < chunks; q += gridDim.x) {
    const long long base = q * kChunk + lane;
    const long long left = rows - base;  // pixels from this thread's first on
    const int k = left <= 0 ? 0 : (left >= kChunk ? kUnroll
                                    : static_cast<int>((left + kLanes - 1) / kLanes));
    if (k == 0) continue;
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      raw[u] = u < k ? __ldg(x + (base + u * kLanes) * kGroups + cg)
                     : make_uint4(0, 0, 0, 0);
    // the chunk's mean, then its sum of squared deviations from it
    float cm[kVec], cm2[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) cm[j] = cm2[j] = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u < k) {
        float f[kVec];
        unpack8(raw[u], f);
#pragma unroll
        for (int j = 0; j < kVec; ++j) cm[j] += f[j];
      }
    }
    const float inv_k = 1.f / static_cast<float>(k);
#pragma unroll
    for (int j = 0; j < kVec; ++j) cm[j] *= inv_k;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u < k) {
        float f[kVec];
        unpack8(raw[u], f);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float d = f[j] - cm[j];
          cm2[j] = fmaf(d, d, cm2[j]);
        }
      }
    }
    const float nn = n + static_cast<float>(k);
    const float wb = static_cast<float>(k) / nn, wab = n * wb;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float d = cm[j] - mean[j];
      mean[j] = fmaf(d, wb, mean[j]);
      m2[j] += cm2[j] + d * d * wab;
    }
    n = nn;
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    s_mean[lane][cg * kVec + j] = mean[j];
    s_m2[lane][cg * kVec + j] = m2[j];
  }
  if (cg == 0) s_n[lane] = n;
  __syncthreads();
  if (tid < kC) {  // the block's partial of channel tid, lanes in order
    double bn = 0.0, bm = 0.0, bm2 = 0.0;
    for (int l = 0; l < kLanes; ++l)
      chan(bn, bm, bm2, s_n[l], s_mean[l][tid], s_m2[l][tid]);
    float* mine = part + static_cast<long long>(blockIdx.x) * (2 * kC + 1);
    mine[tid] = static_cast<float>(bm);
    mine[kC + tid] = static_cast<float>(bm2);
    if (tid == 0) mine[2 * kC] = static_cast<float>(bn);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;

  // the last block merges the partials: a quarter of the blocks a thread,
  // then the four quarters in order
  __threadfence();
  const int c = tid % kC, quarter = tid / kC;
  double tn = 0.0, tm = 0.0, tm2 = 0.0;
  for (unsigned int b = quarter; b < gridDim.x; b += kQuarters) {
    const float* pb = part + static_cast<long long>(b) * (2 * kC + 1);
    chan(tn, tm, tm2, __ldcg(pb + 2 * kC), __ldcg(pb + c), __ldcg(pb + kC + c));
  }
  s_q[0][quarter][c] = tn;
  s_q[1][quarter][c] = tm;
  s_q[2][quarter][c] = tm2;
  __syncthreads();
  if (tid < kC) {
    double an = 0.0, am = 0.0, am2 = 0.0;
    for (int qq = 0; qq < kQuarters; ++qq)
      chan(an, am, am2, s_q[0][qq][tid], s_q[1][qq][tid], s_q[2][qq][tid]);
    const float m = static_cast<float>(am);
    const float var = static_cast<float>(am2 / an);
    stats[tid] = m;
    stats[kC + tid] = 1.f / sqrtf(var + eps);
    stats[2 * kC + tid] = var;
    running_mean[tid] = fmaf(momentum, m, running_mean[tid] * (1.f - momentum));
    running_var[tid] = fmaf(momentum, var, running_var[tid] * (1.f - momentum));
    if (tid == 0) *ticket = 0;  // ready for the next call
  }
}

// ---------------------------------------------------------------------------
// forward: BN, ReLU, pool
// ---------------------------------------------------------------------------

struct Plane {
  int h, w, ho, wo, bands;
};

// Thread item i → (image, first pooled row, pooled column, channel group).
__device__ __forceinline__ void item(long long i, const Plane& g, long long& img,
                                     int& oy0, int& ox, int& cg) {
  cg = static_cast<int>(i % kGroups);
  long long rest = i / kGroups;
  ox = static_cast<int>(rest % g.wo);
  rest /= g.wo;
  oy0 = static_cast<int>(rest % g.bands) * kBand;
  img = rest / g.bands;
}

__device__ __forceinline__ void relu8(float (&y)[kVec]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) y[j] = y[j] < 0.f ? 0.f : y[j];  // NaN stays
}

__device__ __forceinline__ void take(const float (&r)[kVec], int k,
                                     float (&best)[kVec], int (&code)[kVec]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (r[j] > best[j] || r[j] != r[j]) {  // max_pool2d's rule: first maximum
      best[j] = r[j];
      code[j] = k;
    }
  }
}

__global__ void __launch_bounds__(kThreads, kPoolBlocksPerSM)
hipac_stem_train_pool(const uint4* __restrict__ x, const float* __restrict__ stats,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, uint4* __restrict__ out,
                      uint2* __restrict__ codes, long long items, Plane g) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i >= items) return;
  long long img;
  int oy0, ox, cg;
  item(i, g, img, oy0, ox, cg);
  Params p;
  load_params(stats, gamma, beta, cg, p);
  const uint4* xi = x + img * g.h * g.w * kGroups + cg;
  const int ix = 2 * ox;
  const bool has[3] = {ox > 0, true, ix + 1 < g.w};
  auto at = [&](int iy, int t) {
    return __ldg(xi + (static_cast<long long>(iy) * g.w + ix - 1 + t) * kGroups);
  };
  auto row = [&](int iy, int t, float (&r)[kVec]) {
    float f[kVec];
    unpack8(at(iy, t), f);
    bn8(f, p, r);
    relu8(r);
  };
  // the window's first row: the last row of the window above, kept packed
  uint4 top[3] = {};
  bool top_in = oy0 > 0;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (top_in && has[t]) {
      float r[kVec];
      row(2 * oy0 - 1, t, r);
      top[t] = pack8(r);
    }
  }
  const int oy1 = min(g.ho, oy0 + kBand);
  for (int oy = oy0; oy < oy1; ++oy) {
    float best[kVec];
    int code[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      best[j] = __int_as_float(0xff800000);  // -inf
      code[j] = 0;
    }
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      if (top_in && has[t]) {
        float r[kVec];
        unpack8(top[t], r);
        take(r, t, best, code);
      }
    }
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      if (has[t]) {
        float r[kVec];
        row(2 * oy, t, r);
        take(r, 3 + t, best, code);
      }
    }
    top_in = 2 * oy + 1 < g.h;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      if (top_in && has[t]) {
        float r[kVec];
        row(2 * oy + 1, t, r);
        take(r, 6 + t, best, code);
        top[t] = pack8(r);
      }
    }
    const long long o = ((img * g.ho + oy) * g.wo + ox) * kGroups + cg;
    out[o] = pack8(best);
    codes[o] = make_uint2(
        code[0] | code[1] << 8 | code[2] << 16 | code[3] << 24,
        code[4] | code[5] << 8 | code[6] << 16 | code[7] << 24);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

__device__ __forceinline__ int code_of(const uint2 k, int j) {
  return ((j < 4 ? k.x : k.y) >> (8 * (j & 3))) & 0xff;
}

// g += dy where the window's code names position `pos` (dy kept packed).
__device__ __forceinline__ void route(const uint2 k, const uint4 raw, int pos,
                                      float (&g)[kVec]) {
  float d[kVec];
  unpack8(raw, d);
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (code_of(k, j) == pos) g[j] += d[j];
}

struct Sums {
  float g[kVec], gx[kVec];
};

// One input pixel's gradient g (routed, float32): round and mask it, then
// either add to the sums (reduce) or write dx (apply).
template <bool kApply>
__device__ __forceinline__ void finish(const uint4* __restrict__ src,
                                       uint4* __restrict__ dst,
                                       const float (&g)[kVec], const Params& p,
                                       const float (&mg)[kVec],
                                       const float (&mgx)[kVec], Sums& s) {
  float f[kVec], y[kVec];
  unpack8(__ldg(src), f);
  bn8(f, p, y);
  float dx[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float gm = y[j] > 0.f ? bf16_round(g[j]) : 0.f;
    const float xh = (f[j] - p.mean[j]) * p.invstd[j];
    if (kApply) {
      dx[j] = p.scale[j] * (gm - mg[j] - xh * mgx[j]);
    } else {
      s.g[j] += gm;
      s.gx[j] = fmaf(gm, xh, s.gx[j]);
    }
  }
  if (kApply) *dst = pack8(dx);
}

template <bool kApply>
__device__ void backward_item(long long i, const uint4* __restrict__ x,
                              const uint4* __restrict__ dy,
                              const uint2* __restrict__ codes, const Plane& g,
                              const Params& p, const float (&mg)[kVec],
                              const float (&mgx)[kVec], uint4* __restrict__ dx,
                              Sums& s) {
  long long img;
  int oy0, ox, cg;
  item(i, g, img, oy0, ox, cg);
  const long long plane = img * g.h * g.w * kGroups + cg;
  const long long pooled = img * g.ho * g.wo * kGroups + cg;
  const int ix = 2 * ox;
  const bool right = ix + 1 < g.w, next_col = ox + 1 < g.wo;
  const uint2 none = make_uint2(0xffffffffu, 0xffffffffu);
  auto window = [&](int oy, int oxx, uint4& d, uint2& k) {
    const long long o = pooled + (static_cast<long long>(oy) * g.wo + oxx) * kGroups;
    d = __ldg(dy + o);
    k = __ldg(codes + o);
  };
  // windows (oy, ox) and (oy, ox + 1); then those of the row below
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4 d0, d1 = zero, d2 = zero, d3 = zero;
  uint2 k0, k1 = none, k2 = none, k3 = none;
  window(oy0, ox, d0, k0);
  if (next_col) window(oy0, ox + 1, d1, k1);
  const int oy1 = min(g.ho, oy0 + kBand);
  for (int oy = oy0; oy < oy1; ++oy) {
    const bool below = oy + 1 < g.ho;
    k2 = k3 = none;
    if (below) {
      window(oy + 1, ox, d2, k2);
      if (next_col) window(oy + 1, ox + 1, d3, k3);
    }
    const long long r0 = plane + (static_cast<long long>(2 * oy) * g.w + ix) * kGroups;
    const long long r1 = r0 + static_cast<long long>(g.w) * kGroups;
    float acc[kVec];
    // (2oy, 2ox): window (oy, ox) only
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
    route(k0, d0, 4, acc);
    finish<kApply>(x + r0, dx + r0, acc, p, mg, mgx, s);
    if (right) {  // (2oy, 2ox + 1): windows (oy, ox), (oy, ox + 1)
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
      route(k0, d0, 5, acc);
      route(k1, d1, 3, acc);
      finish<kApply>(x + r0 + kGroups, dx + r0 + kGroups, acc, p, mg, mgx, s);
    }
    if (2 * oy + 1 < g.h) {
      // (2oy + 1, 2ox): windows (oy, ox), (oy + 1, ox)
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
      route(k0, d0, 7, acc);
      route(k2, d2, 1, acc);
      finish<kApply>(x + r1, dx + r1, acc, p, mg, mgx, s);
      if (right) {  // (2oy + 1, 2ox + 1): all four windows
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
        route(k0, d0, 8, acc);
        route(k1, d1, 6, acc);
        route(k2, d2, 2, acc);
        route(k3, d3, 0, acc);
        finish<kApply>(x + r1 + kGroups, dx + r1 + kGroups, acc, p, mg, mgx, s);
      }
    }
    d0 = d2;
    d1 = d3;
    k0 = k2;
    k1 = k3;
  }
}

// Pass 1: the sums of g and g * xhat per channel. A grid of resident blocks
// walks the items; each block's sums go to `part`, and the last block to
// take a ticket adds them in block order (double) into sums = (dbeta,
// dgamma).
__global__ void __launch_bounds__(kThreads)
hipac_stem_train_reduce(const uint4* __restrict__ x, const uint4* __restrict__ dy,
                        const uint2* __restrict__ codes,
                        const float* __restrict__ stats,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta, long long items, Plane g,
                        float* __restrict__ part, int* __restrict__ ticket,
                        float* __restrict__ sums) {
  __shared__ float s_sum[2][kLanes][kC];
  __shared__ bool last;
  const int tid = threadIdx.x, cg = tid % kGroups, lane = tid / kGroups;
  Params p;
  load_params(stats, gamma, beta, cg, p);
  const float zero[kVec] = {};
  Sums s;
#pragma unroll
  for (int j = 0; j < kVec; ++j) s.g[j] = s.gx[j] = 0.f;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + tid;
       i < items; i += stride)
    backward_item<false>(i, x, dy, codes, g, p, zero, zero, nullptr, s);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    s_sum[0][lane][cg * kVec + j] = s.g[j];
    s_sum[1][lane][cg * kVec + j] = s.gx[j];
  }
  __syncthreads();
  if (tid < 2 * kC) {  // the block's sums, lanes in order
    const int which = tid / kC, c = tid % kC;
    float t = 0.f;
    for (int l = 0; l < kLanes; ++l) t += s_sum[which][l][c];
    part[static_cast<long long>(blockIdx.x) * 2 * kC + tid] = t;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid < 2 * kC) {
    double t = 0.0;
    for (unsigned int b = 0; b < gridDim.x; ++b)
      t += __ldcg(part + static_cast<long long>(b) * 2 * kC + tid);
    sums[tid] = static_cast<float>(t);
    if (tid == 0) *ticket = 0;  // ready for the next call
  }
}

// Pass 2: dx.
__global__ void __launch_bounds__(kThreads)
hipac_stem_train_apply(const uint4* __restrict__ x, const uint4* __restrict__ dy,
                       const uint2* __restrict__ codes,
                       const float* __restrict__ stats,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const float* __restrict__ sums, float inv_n,
                       long long items, Plane g, uint4* __restrict__ dx) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i >= items) return;
  const int cg = static_cast<int>(i % kGroups);
  Params p;
  load_params(stats, gamma, beta, cg, p);
  float mg[kVec], mgx[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    mg[j] = sums[cg * kVec + j] * inv_n;
    mgx[j] = sums[kC + cg * kVec + j] * inv_n;
  }
  Sums unused;
  backward_item<true>(i, x, dy, codes, g, p, mg, mgx, dx, unused);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The blocks of `kernel` that the current device holds at once, at most
// `capacity` (the partials the caller made room for): a reducing kernel
// launches one wave, each block walking an equal share.
// Asked once a device and kernel.
template <typename Kernel>
int resident_blocks(Kernel kernel, int capacity) {
  constexpr int kDevices = 64;
  static int held[kDevices] = {};  // a race writes the same value
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  int wave = dev < kDevices ? held[dev] : 0;
  if (wave == 0) {
    int sms = 0, per = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, 0) !=
            cudaSuccess) {
      return -1;
    }
    wave = per > 0 ? per * sms : 1;
    if (dev < kDevices) held[dev] = wave;
  }
  return wave < capacity ? wave : capacity;
}

int plane_of(long long b, int h, int w, Plane* g, long long* items) {
  if (b <= 0 || h < 1 || w < 1) return cudaErrorInvalidValue;
  g->h = h;
  g->w = w;
  g->ho = (h - 1) / 2 + 1;
  g->wo = (w - 1) / 2 + 1;
  g->bands = (g->ho + kBand - 1) / kBand;
  *items = b * g->bands * g->wo * kGroups;
  if ((*items + kThreads - 1) / kThreads > 0x7fffffffLL) return cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// Forward. x: (b, h, w, 64) bf16 contiguous (conv1's output, channels-last);
// gamma, beta, running_mean, running_var: (64,) float32; out: (b, ho, wo,
// 64) bf16 and codes: (b, ho, wo, 64) uint8 with ho = (h - 1) / 2 + 1, wo =
// (w - 1) / 2 + 1; stats: (3, 64) float32, written (mean, invstd, biased
// variance); part: blocks * 129 float32 scratch (the statistics kernel
// launches as many blocks as the device holds at once, at most `blocks`);
// ticket: one int32, 0, left 0. The running statistics move in place.
// Returns a cudaError_t as int (0 = both kernels launched).
int hipac_stem_train_fwd(const void* x, const void* gamma, const void* beta,
                         void* running_mean, void* running_var, void* out,
                         void* codes, void* stats, void* part, void* ticket,
                         long long b, int h, int w, int blocks, float eps,
                         float momentum, void* stream) {
  Plane g;
  long long items;
  if (int rc = plane_of(b, h, w, &g, &items)) return rc;
  if (blocks < 1 || !aligned16(x) || !aligned16(out) ||
      reinterpret_cast<uintptr_t>(codes) % 8) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = resident_blocks(hipac_stem_train_stats, blocks);
  if (grid < 1) return static_cast<int>(cudaGetLastError());
  hipac_stem_train_stats<<<grid, kThreads, 0, s>>>(
      static_cast<const uint4*>(x), b * h * w, static_cast<float*>(part),
      static_cast<int*>(ticket), eps, momentum, static_cast<float*>(stats),
      static_cast<float*>(running_mean), static_cast<float*>(running_var));
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  hipac_stem_train_pool<<<static_cast<unsigned int>((items + kThreads - 1) / kThreads),
                          kThreads, 0, s>>>(
      static_cast<const uint4*>(x), static_cast<const float*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<uint4*>(out), static_cast<uint2*>(codes), items, g);
  return static_cast<int>(cudaGetLastError());
}

// Backward. x, codes, stats, gamma, beta as the forward left them; dy: (b,
// ho, wo, 64) bf16 contiguous; dx: (b, h, w, 64) bf16; sums: (2, 64) float32,
// written (dbeta, dgamma); part: blocks * 128 float32 scratch (at most
// `blocks` blocks, as in the forward); ticket as in the forward. Returns a
// cudaError_t as int (0 = both kernels launched).
int hipac_stem_train_bwd(const void* x, const void* dy, const void* codes,
                         const void* stats, const void* gamma, const void* beta,
                         void* dx, void* sums, void* part, void* ticket,
                         long long b, int h, int w, int blocks, void* stream) {
  Plane g;
  long long items;
  if (int rc = plane_of(b, h, w, &g, &items)) return rc;
  if (blocks < 1 || !aligned16(x) || !aligned16(dy) || !aligned16(dx) ||
      reinterpret_cast<uintptr_t>(codes) % 8) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = resident_blocks(hipac_stem_train_reduce, blocks);
  if (grid < 1) return static_cast<int>(cudaGetLastError());
  hipac_stem_train_reduce<<<grid, kThreads, 0, s>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(dy),
      static_cast<const uint2*>(codes), static_cast<const float*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), items,
      g, static_cast<float*>(part), static_cast<int*>(ticket),
      static_cast<float*>(sums));
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  const float inv_n = static_cast<float>(1.0 / (static_cast<double>(b) * h * w));
  hipac_stem_train_apply<<<static_cast<unsigned int>((items + kThreads - 1) / kThreads),
                           kThreads, 0, s>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(dy),
      static_cast<const uint2*>(codes), static_cast<const float*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(sums), inv_n, items, g, static_cast<uint4*>(dx));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
