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
// Design of the forward: 256 threads own a 64 x 64 tile of scores as 4 x 4
// register micro-tiles; z is staged through shared memory in depth chunks of
// 32, transposed so that each thread reads its 4 rows and 4 columns as two
// float4 loads per depth step (16 FMAs per 2 shared loads). Each thread
// keeps its own online (m, l) over the columns it sees and the 16 threads
// of a row merge theirs with warp shuffles once at the end, so the column
// loop has no reductions. The backward (further down) splits the columns
// of a row block over a cluster and sums the partials in a fixed order. No
// atomics, and neither result depends on the order blocks run in. Plain
// float32 FMA, no tensor cores: TF32 products miss the gradient's bound.
//
// Bound with ctypes: plain C entry points, launched on the caller's stream,
// allocating nothing; each returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "int8_wgmma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace hipac_int8;  // mbarriers, bulk copies

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

// ---- backward: a column split over a thread-block cluster ----
//
// Grid: (row block of 64 rows x column split, slice of kDO columns of dz).
// The splits of one row block form a cluster (at most 8 blocks, portable);
// each block walks its own run of 64-wide column tiles and keeps a 64 x 128
// partial dz in registers (4 rows x 8 columns a thread). At the end each
// block puts its partial into its shared memory and, after cluster.sync(),
// rank k sums rows k * 64 / splits .. of every rank's partial, in rank order,
// through distributed shared memory and writes them: no atomics, the same
// order on every call, so two calls give the same bits.
//
// Data: z is read in depth chunks of kKC (= kDO) columns. For d <= kKC there
// is one chunk: the block's 64 rows land once (one bulk copy) and stay, and
// each column tile lands by one bulk copy (its rows are contiguous) into a
// 2-deep mbarrier ring; it serves both the scores and, through the
// coefficients, the product for dz. For d > kKC each ring stage holds a
// chunk of the rows and of the tile (a bulk copy a row); the chunk of this
// block's dz slice comes last, so the product reads it from the same stage.
// The copy of the stage after next is issued as soon as a stage is free, so
// copies run under the products. Chunks are stored unpadded, and lane tx
// walks a chunk's depth starting at float4 tx (mod the chunk's width): the
// 16 lanes that read 16 different rows of the tile hit 16 different bank
// groups.
//
// Coefficients: lse = m + log l per row and per column, p = exp(s - lse):
// one exponential each and no division (two exponentials and two IEEE
// divisions a score before).
//
// The first design gave each of the ceil(n / 64) x ceil(d / 128) blocks all
// column tiles (16 blocks on 132 SMs at the path's 2N = 1024) and staged the
// block's own rows again for every tile, through four block barriers per
// 32-deep chunk (PERF.md).

constexpr int kKC = kDO;  // depth chunk of z in shared memory (floats)

// Rows [r0, r0 + rows) x columns [c0, c0 + cw) of z (pitch d) into dst
// (pitch kc), reporting to `bar`: one copy when the rows are contiguous.
__device__ __forceinline__ void copy_rows(float* dst, const float* z, int d,
                                          int r0, int rows, int c0, int cw,
                                          int kc, uint64_t* bar) {
  if (cw == d) {
    bulk_copy_g2s(dst, z + static_cast<int64_t>(r0) * d,
                  static_cast<uint32_t>(rows) * d * 4, bar);
    return;
  }
  for (int r = 0; r < rows; ++r) {
    bulk_copy_g2s(dst + r * kc, z + static_cast<int64_t>(r0 + r) * d + c0,
                  static_cast<uint32_t>(cw) * 4, bar);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    nt_xent_bwd_kernel(const float* __restrict__ z,
                       const int* __restrict__ pos_idx,
                       const float* __restrict__ m_in,
                       const float* __restrict__ l_in,
                       const float* __restrict__ g_in, int n, int d,
                       float inv_tau, float* __restrict__ dz, int splits) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[2], rbar;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int row0 = (blockIdx.x / splits) * kBR;
  const int ds = blockIdx.y;  // this block's slice of dz = depth chunk ds
  const int nch = (d + kKC - 1) / kKC;
  const int kc = min(d, kKC);
  const int rows_r = min(kBR, n - row0);
  const bool resident = nch == 1;
  float* zr_res = smem;  // 64 x kc when resident
  float* ring = smem + (resident ? kBR * kc : 0);
  const int stage = (resident ? 1 : 2) * kBR * kc;  // floats of a stage
  const int ring_floats = max(2 * stage, kBR * kLDO);
  float* Ct = ring + ring_floats;  // coefficients, Ct[c][r]
  const int tiles = (n + kBC - 1) / kBC;
  const int t_begin = rank * tiles / splits, t_end = (rank + 1) * tiles / splits;
  const int units = (t_end - t_begin) * nch;

  // unit u: tile t_begin + u / nch, chunk chunk_of(u % nch) (slice ds last)
  auto chunk_of = [&](int j) { return j == nch - 1 ? ds : (j < ds ? j : j + 1); };
  auto issue = [&](int u) {
    float* st = ring + (u & 1) * stage;
    const int col0 = (t_begin + u / nch) * kBC;
    const int c = chunk_of(u % nch);
    const int cw = min(kKC, d - c * kKC);
    const int rows_c = min(kBC, n - col0);
    mbar_arrive_expect_tx(&full[u & 1], static_cast<uint32_t>(
        (rows_c + (resident ? 0 : rows_r)) * cw * 4));
    if (!resident) copy_rows(st, z, d, row0, rows_r, c * kKC, cw, kc, &full[u & 1]);
    copy_rows(st + (resident ? 0 : kBR * kc), z, d, col0, rows_c, c * kKC, cw,
              kc, &full[u & 1]);
  };

  // rows past n and past a ragged tile read as zeros (their coefficients
  // are 0, and 0 * a stale finite value is 0)
  for (int e = tid; e < (resident ? kBR * kc : 0) + 2 * stage; e += kThreads)
    smem[e] = 0.f;
  fence_async_proxy();
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init(&rbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    if (resident) {
      mbar_arrive_expect_tx(&rbar, static_cast<uint32_t>(rows_r) * d * 4);
      copy_rows(zr_res, z, d, row0, rows_r, 0, d, kc, &rbar);
    }
    for (int u = 0; u < 2 && u < units; ++u) issue(u);
  }

  int row[4], pos_r[4];
  float lse_r[4], g_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = row0 + 4 * ty + i;
    const bool in = row[i] < n;
    pos_r[i] = in ? pos_idx[row[i]] : -1;
    lse_r[i] = in ? m_in[row[i]] + logf(l_in[row[i]]) : 0.f;
    g_r[i] = in && pos_r[i] >= 0 ? g_in[row[i]] : 0.f;
  }
  float out[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) out[i][j] = 0.f;
  if (resident) mbar_wait(&rbar, 0);

  float acc[4][4];
  for (int u = 0; u < units; ++u) {
    const float* st = ring + (u & 1) * stage;
    const float* zr = resident ? zr_res : st;
    const float* zc = resident ? st : st + kBR * kc;
    const int j = u % nch;
    const int c = chunk_of(j);
    const int nq = min(kKC, d - c * kKC) / 4;  // float4s of this chunk's rows
    if (j == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
    }
    mbar_wait(&full[u & 1], static_cast<uint32_t>((u >> 1) & 1));
    int q = tx % nq;
    for (int step = 0; step < nq; ++step) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(zr + (4 * ty + i) * kc + 4 * q);
        b[i] = *reinterpret_cast<const float4*>(zc + (4 * tx + i) * kc + 4 * q);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float s = fmaf(a[i].x, b[jj].x, acc[i][jj]);
          s = fmaf(a[i].y, b[jj].y, s);
          s = fmaf(a[i].z, b[jj].z, s);
          acc[i][jj] = fmaf(a[i].w, b[jj].w, s);
        }
      q = q + 1 == nq ? 0 : q + 1;
    }

    if (j == nch - 1) {  // the tile's scores are complete; zc is chunk ds
      const int col0 = (t_begin + u / nch) * kBC;
      int col[4], pos_c[4];
      float lse_c[4], g_c[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        col[jj] = col0 + 4 * tx + jj;
        const bool in = col[jj] < n;
        pos_c[jj] = in ? pos_idx[col[jj]] : -1;
        lse_c[jj] = in ? m_in[col[jj]] + logf(l_in[col[jj]]) : 0.f;
        g_c[jj] = in && pos_c[jj] >= 0 ? g_in[col[jj]] : 0.f;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float cf[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool masked =
              col[jj] == row[i] || pos_c[jj] < 0 || pos_r[i] < 0;
          const float s = acc[i][jj] * inv_tau;
          const float p_rc = masked ? 0.f : expf(s - lse_r[i]);
          const float p_cr = masked ? 0.f : expf(s - lse_c[jj]);
          cf[i] = g_r[i] * (p_rc - (col[jj] == pos_r[i] ? 1.f : 0.f)) +
                  g_c[jj] * (p_cr - (row[i] == pos_c[jj] ? 1.f : 0.f));
        }
        *reinterpret_cast<float4*>(Ct + (4 * tx + jj) * kLD + 4 * ty) =
            make_float4(cf[0], cf[1], cf[2], cf[3]);
      }
      __syncthreads();  // Ct complete
#pragma unroll 4
      for (int cc = 0; cc < kBC; ++cc) {
        const float4 cf = *reinterpret_cast<const float4*>(Ct + cc * kLD + 4 * ty);
        const float4 z0 = *reinterpret_cast<const float4*>(zc + cc * kc + 4 * tx);
        const float4 z1 = kc > 64 ? *reinterpret_cast<const float4*>(zc + cc * kc + 64 + 4 * tx)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        const float cv[4] = {cf.x, cf.y, cf.z, cf.w};
        const float zv[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) out[i][jj] = fmaf(cv[i], zv[jj], out[i][jj]);
      }
    }
    __syncthreads();  // every thread is past this stage (and Ct)
    if (tid == 0 && u + 2 < units) issue(u + 2);
  }

  // the partial into this block's shared memory, then the cluster's sum
  float* red = ring;  // 64 x kLDO; every copy has landed and been read
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* rp = red + (4 * ty + i) * kLDO;
    *reinterpret_cast<float4*>(rp + 4 * tx) =
        make_float4(out[i][0], out[i][1], out[i][2], out[i][3]);
    *reinterpret_cast<float4*>(rp + 64 + 4 * tx) =
        make_float4(out[i][4], out[i][5], out[i][6], out[i][7]);
  }
  cluster.sync();
  const int share = kBR / splits;
  const int cw = min(kDO, d - ds * kDO);
  for (int e = tid; e < share * (kDO / 4); e += kThreads) {
    const int r = rank * share + e / (kDO / 4), c4 = e % (kDO / 4);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < splits; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(red + r * kLDO + 4 * c4, k));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    if (row0 + r < n && 4 * c4 < cw) {
      *reinterpret_cast<float4*>(dz + static_cast<int64_t>(row0 + r) * d +
                                 ds * kDO + 4 * c4) =
          make_float4(s.x * inv_tau, s.y * inv_tau, s.z * inv_tau,
                      s.w * inv_tau);
    }
  }
  // no block leaves while another may still read its partial
  cluster.sync();
}

// Dynamic shared memory of a backward block for rows of width d.
inline size_t bwd_smem(int d) {
  const int nch = (d + kKC - 1) / kKC;
  const int kc = d < kKC ? d : kKC;
  const int stage = (nch == 1 ? 1 : 2) * kBR * kc;
  const int ring = 2 * stage > kBR * kLDO ? 2 * stage : kBR * kLDO;
  return sizeof(float) * ((nch == 1 ? kBR * kc : 0) + ring + kBC * kLD);
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

// z: (n_rows, d) float32, d a multiple of 4, 16-byte aligned; dz alike.
// splits: blocks a row block's columns are split over, one cluster (1, 2, 4
// or 8; ops/nt_xent.py::bwd_splits).
extern "C" int hipac_nt_xent_bwd(const float* z, const int* pos_idx,
                                 const float* m, const float* l,
                                 const float* g, long long n_rows, long long d,
                                 float inv_tau, float* dz, int splits,
                                 void* stream) {
  if (n_rows < 1 || d < 1 || n_rows > INT32_MAX || d > INT32_MAX || d % 4 ||
      (splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
      reinterpret_cast<uintptr_t>(z) % 16 || reinterpret_cast<uintptr_t>(dz) % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem((int)d);
  cudaError_t err = cudaFuncSetAttribute(
      nt_xent_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n_rows + kBR - 1) / kBR * splits),
                     (unsigned)((d + kDO - 1) / kDO));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, nt_xent_bwd_kernel, z, pos_idx, m, l, g,
                           (int)n_rows, (int)d, inv_tau, dz, splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
