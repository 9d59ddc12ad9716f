// Streaming NT-Xent loss rows and their gradient, for sm_90a.
//
// Replaces the JAX package's Pallas kernels
// ss25_hierarchical_multiscale_image_classification_tpu/ops/pallas/nt_xent.py
// ::_fwd_kernel (line 63, driven by _run_fwd) and ::_bwd_kernel (line 157,
// driven by _run_bwd), joined there by a custom VJP and here by the
// torch.autograd.Function in ops/nt_xent.py. Same function, not the same
// blocks: the TPU grid carries (m, l) and the dZ accumulator in scratch from
// one sequential column step to the next; Hopper blocks run in no order, so
// each block here owns a block of rows and loops over every column tile
// itself.
//
// What they compute, for z (n, d) float32 row-major (rows already
// L2-normalised), pos_idx (n,) int32 (the positive partner of each row, or
// < 0 for a dead row), with s_rc = (z_r . z_c) * inv_tau:
//   masked:  s_rc = -1e30 where c == r or pos_idx[c] < 0 (dead column);
//   forward: m_r = max_c s_rc, l_r = sum_c exp(s_rc - m_r),
//            loss_r = -s_{r,pos_r} + m_r + log l_r for a live row, 0 for a
//            dead one;
//   backward, with p_rc = exp(s_rc - m_r) / l_r (0 where masked or either
//            row is dead) and g the upstream gradient (0 on dead rows):
//            dz_r = inv_tau * sum_c [g_r (p_rc - 1{c = pos_r})
//                                    + g_c (p_cr - 1{r = pos_c})] z_c,
//            the (A + A^T) Z / tau of the Pallas kernel; s is symmetric, so
//            p_cr comes from the same score with the column row's (m, l).
// Columns past n take no part at all; any n >= 1 and d >= 1 are taken, and
// ragged edges are masked here (zero-filled tiles), so the caller pads
// nothing.
//
// What bounds them: float32 FMA throughput once n is large. The forward is
// n*n*d FMAs (2N = 32768, D = 128: ~137 GFLOP), the backward twice that
// (the scores are recomputed, then the coefficients multiply Z again).
// At the training path's 2N = 1024, D = 128 the forward is ~0.13 GFLOP and
// the launch and the 16 row blocks' latency bound it, not arithmetic.
//
// Design: 256 threads own a 64 x 64 tile of scores as 4 x 4 register
// micro-tiles; z is staged through shared memory in depth chunks of 32,
// transposed so that each thread reads its 4 rows and 4 columns as two
// float4 loads per depth step (16 FMAs per 2 shared loads). Each thread
// keeps its own online (m, l) over the columns it sees and the 16 threads
// of a row merge theirs with warp shuffles once at the end, so the column
// loop has no reductions. The backward writes each 64-row x 128-wide block
// of dz once, from registers (grid = row blocks x 128-wide slices of d,
// each slice recomputing the scores it needs): no atomics, and the result
// does not depend on the order blocks run in. Plain float32 FMA, no tensor
// cores: mma/wgmma in TF32 or bf16, TMA staging and a split over columns
// for small n are left to later work.
//
// Bound with ctypes: plain C entry points, launched on the caller's stream,
// allocating nothing; each returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBR = 64;   // rows of a block
constexpr int kBC = 64;   // columns of a score tile
constexpr int kDK = 32;   // depth of a staged chunk of z
constexpr int kLD = 68;   // padded row of a transposed chunk (float4-aligned)
constexpr int kDO = 128;  // width of the dz slice a backward block writes
constexpr int kLDO = kDO + 4;
constexpr float kMasked = -1e30f;  // as the Pallas kernel: exp(kMasked - m) = 0

static_assert(kThreads == 256 && kBR == 64 && kBC == 64,
              "the 16 x 16 thread grid of 4 x 4 micro-tiles assumes these");
static_assert(2 * kDK * kLD >= kDK * kLDO, "the dz slice reuses the z chunks");

// rows [row0, row0 + 64) x depth [k0, k0 + 32) of z into dst[k][r], zero
// outside the matrix
__device__ __forceinline__ void stage_chunk(const float* __restrict__ z,
                                            int n, int d, int row0, int k0,
                                            float* dst) {
  for (int e = threadIdx.x; e < kBR * kDK; e += kThreads) {
    const int r = e / kDK, k = e % kDK;
    const int row = row0 + r, kk = k0 + k;
    dst[k * kLD + r] =
        (row < n && kk < d) ? z[(int64_t)row * d + kk] : 0.f;
  }
}

// acc[i][j] = z_{row0 + 4 ty + i} . z_{col0 + 4 tx + j}
__device__ __forceinline__ void score_tile(const float* __restrict__ z, int n,
                                           int d, int row0, int col0,
                                           float* As, float* Bs,
                                           float (&acc)[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kDK) {
    __syncthreads();  // every reader of the previous chunk is done
    stage_chunk(z, n, d, row0, k0, As);
    stage_chunk(z, n, d, col0, k0, Bs);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kDK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(As + k * kLD + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(Bs + k * kLD + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// sum and max over the 16 lanes that share a row (one half of a warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    nt_xent_fwd_kernel(const float* __restrict__ z,
                       const int* __restrict__ pos_idx, int n, int d,
                       float inv_tau, float* __restrict__ loss,
                       float* __restrict__ m_out, float* __restrict__ l_out) {
  __shared__ __align__(16) float As[kDK * kLD];
  __shared__ __align__(16) float Bs[kDK * kLD];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int row0 = blockIdx.x * kBR;

  int row[4], pos[4];
  float m[4], l[4], ps[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = row0 + 4 * ty + i;
    pos[i] = row[i] < n ? pos_idx[row[i]] : -1;
    m[i] = kMasked;
    l[i] = 0.f;
    ps[i] = 0.f;
  }

  for (int col0 = 0; col0 < n; col0 += kBC) {
    float acc[4][4];
    score_tile(z, n, d, row0, col0, As, Bs, acc);
    int col[4];
    bool in[4], dead[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      col[j] = col0 + 4 * tx + j;
      in[j] = col[j] < n;
      dead[j] = in[j] && pos_idx[col[j]] < 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float s[4];
      float mt = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = (col[j] == row[i] || dead[j]) ? kMasked : acc[i][j] * inv_tau;
        if (!in[j]) s[j] = -INFINITY;  // past the matrix: no part in m or l
        if (col[j] == pos[i]) ps[i] += s[j];
        mt = fmaxf(mt, s[j]);
      }
      float lt = l[i] * expf(m[i] - mt);
#pragma unroll
      for (int j = 0; j < 4; ++j) lt += expf(s[j] - mt);
      m[i] = mt;
      l[i] = lt;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float mr = row_max(m[i]);
    const float lr = row_sum(l[i] * expf(m[i] - mr));
    const float pr = row_sum(ps[i]);
    if (tx == 0 && row[i] < n) {
      loss[row[i]] = pos[i] >= 0 ? -pr + mr + logf(lr) : 0.f;
      m_out[row[i]] = mr;
      l_out[row[i]] = lr;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    nt_xent_bwd_kernel(const float* __restrict__ z,
                       const int* __restrict__ pos_idx,
                       const float* __restrict__ m_in,
                       const float* __restrict__ l_in,
                       const float* __restrict__ g_in, int n, int d,
                       float inv_tau, float* __restrict__ dz) {
  // the two z chunks of the scores, reused as the 32 x 128 slice of z_C
  // that the coefficients multiply
  __shared__ __align__(16) float buf[2 * kDK * kLD];
  __shared__ __align__(16) float Ct[kBC * kLD];  // coefficients, Ct[c][r]
  float* As = buf;
  float* Bs = buf + kDK * kLD;
  float* Zs = buf;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int row0 = blockIdx.x * kBR;
  const int d0 = blockIdx.y * kDO;

  int row[4], pos_r[4];
  float m_r[4], l_r[4], g_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = row0 + 4 * ty + i;
    const bool in = row[i] < n;
    pos_r[i] = in ? pos_idx[row[i]] : -1;
    m_r[i] = in ? m_in[row[i]] : 0.f;
    l_r[i] = in ? l_in[row[i]] : 1.f;
    g_r[i] = in && pos_r[i] >= 0 ? g_in[row[i]] : 0.f;
  }
  float out[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) out[i][j] = 0.f;

  for (int col0 = 0; col0 < n; col0 += kBC) {
    float acc[4][4];
    score_tile(z, n, d, row0, col0, As, Bs, acc);
    int col[4], pos_c[4];
    float m_c[4], l_c[4], g_c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      col[j] = col0 + 4 * tx + j;
      const bool in = col[j] < n;
      pos_c[j] = in ? pos_idx[col[j]] : -1;
      m_c[j] = in ? m_in[col[j]] : 0.f;
      l_c[j] = in ? l_in[col[j]] : 1.f;
      g_c[j] = in && pos_c[j] >= 0 ? g_in[col[j]] : 0.f;
    }
    float coef[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool masked = col[j] == row[i] || pos_c[j] < 0 || pos_r[i] < 0;
        const float s = acc[i][j] * inv_tau;
        const float p_rc = masked ? 0.f : expf(s - m_r[i]) / l_r[i];
        const float p_cr = masked ? 0.f : expf(s - m_c[j]) / l_c[j];
        coef[i][j] = g_r[i] * (p_rc - (col[j] == pos_r[i] ? 1.f : 0.f)) +
                     g_c[j] * (p_cr - (row[i] == pos_c[j] ? 1.f : 0.f));
      }
    // Ct's readers of the previous tile passed score_tile's first barrier
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Ct + (4 * tx + j) * kLD + 4 * ty) =
          make_float4(coef[0][j], coef[1][j], coef[2][j], coef[3][j]);

    for (int c0 = 0; c0 < kBC; c0 += kDK) {
      __syncthreads();  // scores' chunks read, Ct written, last Zs read
      for (int e = threadIdx.x; e < kDK * kDO; e += kThreads) {
        const int c = e / kDO, k = e % kDO;
        const int zr = col0 + c0 + c, zk = d0 + k;
        Zs[c * kLDO + k] =
            (zr < n && zk < d) ? z[(int64_t)zr * d + zk] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kDK; ++c) {
        const float4 cf =
            *reinterpret_cast<const float4*>(Ct + (c0 + c) * kLD + 4 * ty);
        const float4 z0 =
            *reinterpret_cast<const float4*>(Zs + c * kLDO + 4 * tx);
        const float4 z1 =
            *reinterpret_cast<const float4*>(Zs + c * kLDO + 64 + 4 * tx);
        const float cv[4] = {cf.x, cf.y, cf.z, cf.w};
        const float zv[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) out[i][j] = fmaf(cv[i], zv[j], out[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row[i] >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = d0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (k < d) dz[(int64_t)row[i] * d + k] = out[i][j] * inv_tau;
    }
  }
}

}  // namespace

extern "C" int hipac_nt_xent_fwd(const float* z, const int* pos_idx,
                                 long long n_rows, long long d, float inv_tau,
                                 float* loss, float* m, float* l,
                                 void* stream) {
  if (n_rows < 1 || d < 1 || n_rows > INT32_MAX || d > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n_rows + kBR - 1) / kBR));
  nt_xent_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      z, pos_idx, (int)n_rows, (int)d, inv_tau, loss, m, l);
  return (int)cudaGetLastError();
}

extern "C" int hipac_nt_xent_bwd(const float* z, const int* pos_idx,
                                 const float* m, const float* l,
                                 const float* g, long long n_rows, long long d,
                                 float inv_tau, float* dz, void* stream) {
  if (n_rows < 1 || d < 1 || n_rows > INT32_MAX || d > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n_rows + kBR - 1) / kBR),
                  (unsigned)((d + kDO - 1) / kDO));
  nt_xent_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      z, pos_idx, m, l, g, (int)n_rows, (int)d, inv_tau, dz);
  return (int)cudaGetLastError();
}
