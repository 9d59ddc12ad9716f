// Masked MIL attention pooling over instance bags, for sm_90a.
//
// Replaces the JAX package's Pallas kernel
// ss25_hierarchical_multiscale_image_classification_tpu/ops/pallas/mil_pool.py
// ::_kernel (line 33, driven by mil_attention_pool_pallas, line 81). Same
// function, not the same blocks: the TPU grid runs one program per bag and
// carries an online (m, l, acc) over the bag's instance blocks in order. The
// inference path pools one bag at a time (B = 1), and one block per bag would
// leave all but one of the card's 132 SMs idle, so here the instances are
// split across blocks and the online state is merged in a second pass.
//
// What it computes, for h (B, K, D) float32 row-major, mask (B, K) bytes
// (non-zero = real instance), V (D, H), vb (H,) and w (H,) float32:
//   a_k   = w . tanh(h_k V + vb), or -1e30 where mask_k is 0;
//   bag_b = sum_k exp(a_k - m) h_k / max(sum_k exp(a_k - m), 1e-30),
//           m = max_k a_k,
// exactly the Pallas kernel's recurrence once unrolled: a masked slot keeps
// the weight exp(-1e30 - m), which is 0 when the bag has a real instance and
// 1 when it has none, so a fully masked bag is the mean of its K rows (zero
// padding included), as the Pallas kernel and the flax module give it.
// Every instance k < K takes part; nothing past K exists, so the caller pads
// nothing and the ragged last block is masked here.
//
// What bounds it: float32 FMA throughput on h V, 2 K D H operations a bag
// (K = 4096, D = 512, H = 128: 0.54 GFLOP), against K D 4 bytes of h read
// twice (8 MB, the second time from L2). The tanh, the scores and the
// weighted sum are O(K (H + D)).
//
// Design, two kernels, deterministic (no atomics, fixed summation orders):
// 1. mil_pool_partial: grid (ceil(K / 32), B), 256 threads. A block owns 32
//    instances of one bag. It stages those rows of h in depth chunks of 32
//    and V in 32 x 128 tiles through shared memory, the next chunk's global
//    loads in flight in registers while the current one is multiplied; each
//    thread keeps a 2 x 8 register micro-tile of h V (rows 2 ty + {0, 1},
//    columns 4 tx + {0..3} and 64 + 4 tx + {0..3}, so that a quarter-warp's
//    float4 reads of a V row are conflict-free). Per 128-wide slice of H it
//    adds bias, takes tanh, multiplies by w and sums the 16 threads of a row
//    with warp shuffles. With the 32 scores it forms the block's (m, l) and,
//    re-reading the rows from L2, acc[D] = sum_r exp(a_r - m) h_r, and
//    writes (m, l, acc) to a workspace the wrapper allocates.
// 2. mil_pool_merge: grid (B, ceil(D / 32)), 256 threads. Reduces the
//    blocks' m to the bag maximum M and sum l_b exp(m_b - M) to L in a fixed
//    tree; then each of the 8 warps sums acc_b[d] exp(m_b - M) over every
//    8th partial block for 32 columns d (coalesced rows), and the 8 warp
//    sums are added in order: bag[d] = that / max(L, 1e-30).
// Plain float32 FMA, no tensor cores and no TF32: the tests hold it to a
// float32 plain version. wgmma, TMA staging and fusing the merge are later
// work.
//
// Bound with ctypes: a plain C entry point, launched on the caller's stream,
// allocating nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;   // instances of a partial block
constexpr int kDK = 32;   // depth of a staged chunk
constexpr int kHC = 128;  // width of a slice of H
constexpr int kLDH = kDK + 1;  // padded row of the staged h chunk
constexpr int kHLoads = kBK * kDK / kThreads;  // h values a thread stages
constexpr int kVLoads = kDK * kHC / kThreads;  // V values a thread stages
constexpr int kMergeWarps = 8;
constexpr int kMaxD = 4096;
constexpr int kMaxH = 512;
constexpr float kMasked = -1e30f;  // as the Pallas kernel

static_assert(kThreads == 256 && kBK == 32 && kHC == 128,
              "the 16 x 16 thread grid of 2 x 8 micro-tiles assumes these");

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
    mil_pool_partial(const float* __restrict__ h,
                     const unsigned char* __restrict__ mask,
                     const float* __restrict__ v, const float* __restrict__ vb,
                     const float* __restrict__ w, int K, int D, int H,
                     int nblk, float* __restrict__ ws_m,
                     float* __restrict__ ws_l, float* __restrict__ ws_acc) {
  __shared__ float Hs[kBK * kLDH];                  // Hs[r][k]
  __shared__ __align__(16) float Vs[kDK * kHC];     // Vs[k][c]
  __shared__ float score[kBK];
  __shared__ float prob[kBK];

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int bag = blockIdx.y;
  const int row0 = blockIdx.x * kBK;
  const int nrows = min(kBK, K - row0);
  const float* hb = h + ((int64_t)bag * K + row0) * D;

  // element i of this thread's share of a chunk: h row e / kDK, depth
  // e % kDK; V depth e / kHC, column e % kHC (e = threadIdx.x + i kThreads:
  // neighbouring threads read neighbouring addresses)
  float hreg[kHLoads], vreg[kVLoads];
  auto fetch = [&](int k0, int hc0) {
#pragma unroll
    for (int i = 0; i < kHLoads; ++i) {
      const int e = threadIdx.x + i * kThreads, r = e / kDK, k = k0 + e % kDK;
      hreg[i] = (r < nrows && k < D) ? hb[(int64_t)r * D + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVLoads; ++i) {
      const int e = threadIdx.x + i * kThreads, k = k0 + e / kHC,
                c = hc0 + e % kHC;
      vreg[i] = (k < D && c < H) ? v[(int64_t)k * H + c] : 0.f;
    }
  };

  float a[2] = {0.f, 0.f};  // this thread's rows' scores (same in all tx)
  for (int hc0 = 0; hc0 < H; hc0 += kHC) {
    float acc[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    fetch(0, hc0);
    for (int k0 = 0; k0 < D; k0 += kDK) {
      __syncthreads();  // every reader of the previous chunk is done
#pragma unroll
      for (int i = 0; i < kHLoads; ++i) {
        const int e = threadIdx.x + i * kThreads;
        Hs[(e / kDK) * kLDH + e % kDK] = hreg[i];
      }
#pragma unroll
      for (int i = 0; i < kVLoads; ++i) Vs[threadIdx.x + i * kThreads] = vreg[i];
      __syncthreads();
      if (k0 + kDK < D) fetch(k0 + kDK, hc0);  // in flight while we multiply
#pragma unroll 8
      for (int k = 0; k < kDK; ++k) {
        const float h0 = Hs[(2 * ty) * kLDH + k];
        const float h1 = Hs[(2 * ty + 1) * kLDH + k];
        const float4 v0 = *reinterpret_cast<const float4*>(Vs + k * kHC + 4 * tx);
        const float4 v1 =
            *reinterpret_cast<const float4*>(Vs + k * kHC + 64 + 4 * tx);
        const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[0][j] = fmaf(h0, vv[j], acc[0][j]);
          acc[1][j] = fmaf(h1, vv[j], acc[1][j]);
        }
      }
    }

    // tanh(hV + b) . w over this slice's columns, summed over the 16 lanes
    // of a row (columns past H have w = 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = hc0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
        if (c < H) s = fmaf(tanhf(acc[i][j] + vb[c]), w[c], s);
      }
      a[i] += half_warp_sum(s);
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * ty + i;
      if (r < nrows)
        score[r] = mask[(int64_t)bag * K + row0 + r] ? a[i] : kMasked;
    }
  }
  __syncthreads();

  // the block's online state: every thread forms the same m and l
  float m = kMasked;
  for (int r = 0; r < nrows; ++r) m = fmaxf(m, score[r]);
  if (threadIdx.x < nrows) prob[threadIdx.x] = expf(score[threadIdx.x] - m);
  __syncthreads();
  const int64_t slot = (int64_t)bag * nblk + blockIdx.x;
  if (threadIdx.x == 0) {
    float l = 0.f;
    for (int r = 0; r < nrows; ++r) l += prob[r];
    ws_m[slot] = m;
    ws_l[slot] = l;
  }
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float s = 0.f;
    for (int r = 0; r < nrows; ++r) s = fmaf(prob[r], hb[(int64_t)r * D + d], s);
    ws_acc[slot * D + d] = s;
  }
}

__global__ void __launch_bounds__(kMergeWarps * 32)
    mil_pool_merge(const float* __restrict__ ws_m,
                   const float* __restrict__ ws_l,
                   const float* __restrict__ ws_acc, int nblk, int D,
                   float* __restrict__ out) {
  __shared__ float red[kMergeWarps * 32];
  __shared__ float stat[2];  // M, L
  const int bag = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* mb = ws_m + (int64_t)bag * nblk;
  const float* lb = ws_l + (int64_t)bag * nblk;

  float m = kMasked;
  for (int b = threadIdx.x; b < nblk; b += kMergeWarps * 32)
    m = fmaxf(m, mb[b]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float M = red[0];
    for (int i = 1; i < kMergeWarps; ++i) M = fmaxf(M, red[i]);
    stat[0] = M;
  }
  __syncthreads();
  const float M = stat[0];

  float l = 0.f;
  for (int b = threadIdx.x; b < nblk; b += kMergeWarps * 32)
    l = fmaf(lb[b], expf(mb[b] - M), l);
  l = warp_sum(l);
  if (lane == 0) red[warp] = l;
  __syncthreads();
  if (threadIdx.x == 0) {
    float L = red[0];
    for (int i = 1; i < kMergeWarps; ++i) L += red[i];
    stat[1] = fmaxf(L, 1e-30f);
  }
  __syncthreads();

  const int d = blockIdx.y * 32 + lane;
  float s = 0.f;
  if (d < D) {
    const float* acc = ws_acc + (int64_t)bag * nblk * D + d;
#pragma unroll 4
    for (int b = warp; b < nblk; b += kMergeWarps)
      s = fmaf(acc[(int64_t)b * D], expf(mb[b] - M), s);
  }
  red[threadIdx.x] = s;
  __syncthreads();
  if (warp == 0 && d < D) {
    float t = red[lane];
    for (int i = 1; i < kMergeWarps; ++i) t += red[i * 32 + lane];
    out[(int64_t)bag * D + d] = t / stat[1];
  }
}

}  // namespace

// ws_m, ws_l: (B, ceil(K / 32)); ws_acc: (B, ceil(K / 32), D); out: (B, D).
extern "C" int hipac_mil_attention_pool(const float* h,
                                        const unsigned char* mask,
                                        const float* v, const float* vb,
                                        const float* w, long long b,
                                        long long k, long long d, long long hd,
                                        float* ws_m, float* ws_l,
                                        float* ws_acc, float* out,
                                        void* stream) {
  if (b < 1 || k < 1 || d < 1 || hd < 1 || d > kMaxD || hd > kMaxH ||
      b > 65535 || k > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int nblk = (int)((k + kBK - 1) / kBK);
  cudaStream_t s = (cudaStream_t)stream;
  mil_pool_partial<<<dim3((unsigned)nblk, (unsigned)b), kThreads, 0, s>>>(
      h, mask, v, vb, w, (int)k, (int)d, (int)hd, nblk, ws_m, ws_l, ws_acc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mil_pool_merge<<<dim3((unsigned)b, (unsigned)((d + 31) / 32)),
                   kMergeWarps * 32, 0, s>>>(ws_m, ws_l, ws_acc, nblk, (int)d,
                                             out);
  return (int)cudaGetLastError();
}
