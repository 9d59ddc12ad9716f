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
// the launch and the blocks' latency bound it, not arithmetic.
//
// Both kernels split the 2N columns of a block of rows over a thread-block
// cluster of 1, 2, 4 or 8 blocks (ops/nt_xent.py::fwd_splits, bwd_splits),
// keep the block's rows resident in shared memory, bring column tiles by
// bulk copy into a 2-deep mbarrier ring, and merge the splits' partials in
// rank order through distributed shared memory. No atomics, and neither
// result depends on the order blocks run in: two calls give the same bits.
// Plain float32 FMA, no tensor cores: TF32 products miss the bounds.
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
constexpr int kLD = 68;   // padded row of the backward's coefficients (float4-aligned)
constexpr int kDO = 128;  // width of the dz slice a backward block writes
constexpr int kLDO = kDO + 4;
constexpr float kMasked = -1e30f;  // as the Pallas kernel: exp(kMasked - m) = 0

static_assert(kThreads == 256 && kBR == 64 && kBC == 64,
              "the 16 x 16 thread grid of 4 x 4 micro-tiles assumes these");

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

// ---- forward: a column split over a thread-block cluster ----
//
// Grid: row blocks of kB = 16 T rows x column splits; the splits of one row
// block form a cluster. Each block walks its own run of kB-wide column
// tiles with a T x T register tile a thread (T = 4: 64 x 64 tiles, the
// training path's shape; T = 8: 128 x 128, for long batches of D <= 128,
// 16 FMAs per float4 loaded instead of 8). Thread (ty, tx) owns rows
// ty + 16 i and columns tx + 16 j: rows are staged with a pitch of
// kc + 4 or kc + 8 floats (an odd number of float4s), so the 16 rows a
// half-warp reads at one depth fall in 8 different bank groups, and every
// thread walks the depth in the same order (no stagger is needed). For
// d <= kKC the block's rows land once (one bulk copy a row) and stay; else
// each ring stage holds a depth chunk of the rows and of the tile. Each
// thread keeps an online (m, l) and the positive's score for its T rows
// over the columns it sees, masked as the header says; the 16 threads of a
// row merge theirs by shuffles, and rank k of the cluster merges the
// splits' (m, l, ps) of its rows in rank order:
//   M = max_k m_k, L = sum_k l_k exp(m_k - M), loss = -sum_k ps_k + M + log L.
//
// The first design gave each of the ceil(n / 64) blocks all column
// tiles (16 blocks on 132 SMs at the path's 2N = 1024) and staged the
// block's own rows again for every tile through two block barriers per
// 32-deep chunk (PERF.md).

constexpr int kKC = kDO;  // depth chunk of z in shared memory (floats)

// Row pitch of a staged chunk of kc floats in the forward: an odd number of
// float4s.
__host__ __device__ inline int fwd_pitch(int kc) { return kc + ((kc / 4) % 2 ? 8 : 4); }

// Dynamic shared memory of a forward block (T x T tiles) for rows of width d.
__host__ __device__ inline size_t fwd_smem(int t, int d) {
  const int kb = 16 * t;
  const int kc = d < kKC ? d : kKC;
  const int lp = fwd_pitch(kc);
  const bool resident = d <= kKC;
  const int stage = (resident ? 1 : 2) * kb * lp;
  return sizeof(float) * ((resident ? kb * lp : 0) + 2 * stage + 3 * kb);
}

template <int T>
__global__ void __launch_bounds__(kThreads, 1)
    nt_xent_fwd_kernel(const float* __restrict__ z,
                       const int* __restrict__ pos_idx, int n, int d,
                       float inv_tau, float* __restrict__ loss,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       int splits) {
  constexpr int kB = 16 * T;  // rows of a block, columns of a tile
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[2], rbar;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ty = tid / 16, tx = tid % 16;
  const int row0 = (blockIdx.x / splits) * kB;
  const int nch = (d + kKC - 1) / kKC;
  const int kc = min(d, kKC);
  const int lp = fwd_pitch(kc);
  const int rows_r = min(kB, n - row0);
  const bool resident = nch == 1;
  float* zr_res = smem;  // kB x lp when resident
  float* ring = smem + (resident ? kB * lp : 0);
  const int stage = (resident ? 1 : 2) * kB * lp;  // floats of a stage
  float* red = ring + 2 * stage;  // kB x (m, l, ps) of this block
  const int tiles = (n + kB - 1) / kB;
  const int t_begin = rank * tiles / splits, t_end = (rank + 1) * tiles / splits;
  const int units = (t_end - t_begin) * nch;

  // rows [r0, r0 + rows) x depth [c0, c0 + cw) of z into dst (pitch lp),
  // one bulk copy a row, by the lanes of warp 0
  auto copy_rows = [&](float* dst, int r0, int rows, int c0, int cw,
                       uint64_t* bar) {
    for (int r = lane; r < rows; r += 32)
      bulk_copy_g2s(dst + r * lp, z + static_cast<int64_t>(r0 + r) * d + c0,
                    static_cast<uint32_t>(cw) * 4, bar);
  };
  // unit u: tile t_begin + u / nch, depth chunk u % nch
  auto issue = [&](int u) {
    float* st = ring + (u & 1) * stage;
    const int col0 = (t_begin + u / nch) * kB;
    const int c = u % nch;
    const int cw = min(kKC, d - c * kKC);
    const int rows_c = min(kB, n - col0);
    if (lane == 0)
      mbar_arrive_expect_tx(&full[u & 1], static_cast<uint32_t>(
          (rows_c + (resident ? 0 : rows_r)) * cw * 4));
    __syncwarp();
    if (!resident) copy_rows(st, row0, rows_r, c * kKC, cw, &full[u & 1]);
    copy_rows(st + (resident ? 0 : kB * lp), col0, rows_c, c * kKC, cw,
              &full[u & 1]);
  };

  // rows past n and past a ragged tile read as zeros (their scores are
  // masked or never written)
  for (int e = tid; e < (resident ? kB * lp : 0) + 2 * stage; e += kThreads)
    smem[e] = 0.f;
  fence_async_proxy();
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init(&rbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (warp == 0) {
    if (resident) {
      if (lane == 0)
        mbar_arrive_expect_tx(&rbar, static_cast<uint32_t>(rows_r) * d * 4);
      __syncwarp();
      copy_rows(zr_res, row0, rows_r, 0, d, &rbar);
    }
    for (int u = 0; u < 2 && u < units; ++u) issue(u);
  }

  int row[T], pos[T];
  float m[T], l[T], ps[T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    row[i] = row0 + ty + 16 * i;
    pos[i] = row[i] < n ? pos_idx[row[i]] : -1;
    m[i] = kMasked;
    l[i] = 0.f;
    ps[i] = 0.f;
  }
  if (resident) mbar_wait(&rbar, 0);

  float acc[T][T];
  for (int u = 0; u < units; ++u) {
    const float* st = ring + (u & 1) * stage;
    const float* zr = resident ? zr_res : st;
    const float* zc = resident ? st : st + kB * lp;
    const int j = u % nch;
    const int nq = min(kKC, d - j * kKC) / 4;  // float4s of this chunk's rows
    if (j == 0) {
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int jj = 0; jj < T; ++jj) acc[i][jj] = 0.f;
    }
    mbar_wait(&full[u & 1], static_cast<uint32_t>((u >> 1) & 1));
    for (int q = 0; q < nq; ++q) {
      float4 a[T];
#pragma unroll
      for (int i = 0; i < T; ++i)
        a[i] = *reinterpret_cast<const float4*>(zr + (ty + 16 * i) * lp + 4 * q);
#pragma unroll
      for (int jj = 0; jj < T; ++jj) {
        const float4 b =
            *reinterpret_cast<const float4*>(zc + (tx + 16 * jj) * lp + 4 * q);
#pragma unroll
        for (int i = 0; i < T; ++i) {
          float s = fmaf(a[i].x, b.x, acc[i][jj]);
          s = fmaf(a[i].y, b.y, s);
          s = fmaf(a[i].z, b.z, s);
          acc[i][jj] = fmaf(a[i].w, b.w, s);
        }
      }
    }

    if (j == nch - 1) {  // the tile's scores are complete
      const int col0 = (t_begin + u / nch) * kB;
      int col[T];
      bool in[T], dead[T];
#pragma unroll
      for (int jj = 0; jj < T; ++jj) {
        col[jj] = col0 + tx + 16 * jj;
        in[jj] = col[jj] < n;
        dead[jj] = in[jj] && pos_idx[col[jj]] < 0;
      }
#pragma unroll
      for (int i = 0; i < T; ++i) {
        float s[T];
        float mt = m[i];
#pragma unroll
        for (int jj = 0; jj < T; ++jj) {
          s[jj] = (col[jj] == row[i] || dead[jj]) ? kMasked : acc[i][jj] * inv_tau;
          if (!in[jj]) s[jj] = -INFINITY;  // past the matrix: no part in m or l
          if (col[jj] == pos[i]) ps[i] += s[jj];
          mt = fmaxf(mt, s[jj]);
        }
        float lt = l[i] * expf(m[i] - mt);
#pragma unroll
        for (int jj = 0; jj < T; ++jj) lt += expf(s[jj] - mt);
        m[i] = mt;
        l[i] = lt;
      }
    }
    __syncthreads();  // every thread is past this stage
    if (warp == 0 && u + 2 < units) issue(u + 2);
  }

  // the 16 threads of a row, then the cluster's splits in rank order
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const float mr = row_max(m[i]);
    const float lr = row_sum(l[i] * expf(m[i] - mr));
    const float pr = row_sum(ps[i]);
    if (tx == 0) {
      float* rp = red + 3 * (ty + 16 * i);
      rp[0] = mr;
      rp[1] = lr;
      rp[2] = pr;
    }
  }
  cluster.sync();
  const int share = kB / splits;
  for (int r = rank * share + tid; r < (rank + 1) * share; r += kThreads) {
    float M = kMasked;
    for (int k = 0; k < splits; ++k)
      M = fmaxf(M, *cluster.map_shared_rank(red + 3 * r, k));
    float L = 0.f, PS = 0.f;
    for (int k = 0; k < splits; ++k) {
      const float* rp = cluster.map_shared_rank(red + 3 * r, k);
      L = fmaf(rp[1], expf(rp[0] - M), L);
      PS += rp[2];
    }
    const int gr = row0 + r;
    if (gr < n) {
      loss[gr] = pos_idx[gr] >= 0 ? -PS + M + logf(L) : 0.f;
      m_out[gr] = M;
      l_out[gr] = L;
    }
  }
  // no block leaves while another may still read its partials
  cluster.sync();
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

// z: (n_rows, d) float32, d a multiple of 4, 16-byte aligned. tile: rows of
// a block and columns of a tile, 64 or 128 (128 only for d <= 128);
// splits: blocks a row block's columns are split over, one cluster (1, 2, 4
// or 8). Both from ops/nt_xent.py::fwd_tile and fwd_splits.
extern "C" int hipac_nt_xent_fwd(const float* z, const int* pos_idx,
                                 long long n_rows, long long d, float inv_tau,
                                 float* loss, float* m, float* l, int tile,
                                 int splits, void* stream) {
  if (n_rows < 1 || d < 1 || n_rows > INT32_MAX || d > INT32_MAX || d % 4 ||
      (tile != 64 && !(tile == 128 && d <= kKC)) ||
      (splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
      reinterpret_cast<uintptr_t>(z) % 16)
    return (int)cudaErrorInvalidValue;
  const int t = tile / 16;
  auto kernel = t == 8 ? nt_xent_fwd_kernel<8> : nt_xent_fwd_kernel<4>;
  const size_t smem = fwd_smem(t, (int)d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n_rows + tile - 1) / tile * splits));
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
  err = cudaLaunchKernelEx(&cfg, kernel, z, pos_idx, (int)n_rows, (int)d,
                           inv_tau, loss, m, l, splits);
  if (err != cudaSuccess) return (int)err;
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
