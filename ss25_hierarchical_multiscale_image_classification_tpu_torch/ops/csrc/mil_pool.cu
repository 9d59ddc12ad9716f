// Masked MIL attention pooling over instance bags, for sm_90a.
//
// Replaces the JAX package's Pallas kernel
// ss25_hierarchical_multiscale_image_classification_tpu/ops/pallas/mil_pool.py
// ::_kernel (line 33, driven by mil_attention_pool_pallas, line 81). Same
// function, not the same blocks: the TPU grid runs one program per bag and
// carries an online (m, l, acc) over the bag's instance blocks in order. The
// inference path pools one bag at a time (B = 1), and one block per bag would
// leave all but one of the card's 132 SMs idle, so here a bag's instances
// are split into runs, one per cluster of blocks, and the runs' online states
// are merged at the end of the same launch.
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
// nothing in K and the ragged last tile is masked here.
//
// What bounds it: the products h V, 2 K D H operations a bag (K = 4096,
// D = 512, H = 128: 0.54 GFLOP; 8.1 us at the 67 TFLOP/s float32 peak, 3.3
// us as three TF32 products at 495 TFLOP/s), against K D 4 bytes of h read
// once (8 MB, 2.5 us). The tanh, the scores and the weighted sum are
// O(K (H + D)).
//
// Design, one launch, deterministic (no atomics in any sum, fixed orders):
// - A cluster of `cs` blocks (1, 2, 4 or 8) owns a run of 64-instance tiles
//   of one bag; the bag's runs are as many as fill one wave of clusters
//   (ops/mil_pool.py::pool_runs). Rank r of the cluster owns the depth slice
//   [r ds, (r + 1) ds) of D: it keeps V's rows of that slice resident in
//   shared memory for its whole run (at D = 512, H = 128 and cs = 4, 68 KB
//   of the 256 KB V), and its slice of each tile's h rows arrives by bulk
//   copies (one a row, issued by lanes of all 8 warps) into a 2-deep
//   mbarrier ring. So h crosses HBM once, and V once per cluster.
// - Each block forms its slice's partial pre-activations of the 64 x 128
//   tile (a slice of H at a time) on the tensor cores in 3xTF32: every
//   operand x = hi + lo (hi = x rounded to TF32, lo = x - hi) and lo*hi +
//   hi*lo + hi*hi, by `mma.sync.m16n8k8` (warp tiles of 32 x 32), each 16
//   depths' products added to the running sums in float32. Plain TF32 keeps
//   ~3 decimal digits; this keeps float32's (as close to a float64
//   reference as the float32 plain version, measured on the card).
// - Rank r then sums the cs partials of its 64 / cs rows in rank order,
//   read through distributed shared memory, adds the bias, takes tanh,
//   multiplies by w and sums over H (shuffles in a fixed tree), and writes
//   each finished score into every rank's shared memory.
// - Every rank forms the same online (m, l) from the 64 scores and updates
//   acc over its own depth slice from the h tile still in shared memory: a_k
//   and the weighted sum use the same copy of h.
// - Each block writes its run's partial (m, l, acc of its slice) to a
//   workspace and takes a ticket; the last block of the bag merges the runs
//   in index order: M = max m_c, L = sum_c l_c exp(m_c - M), bag = sum_c
//   acc_c exp(m_c - M) / max(L, 1e-30), and resets the bag's ticket to 0.
// - Where a rank's slice of V does not fit beside the ring (large D H), the
//   same kernel reads V from device memory (through L1/L2) inside the product
//   loop, and where the h tile does not fit twice the ring has one stage:
//   chosen by shape (ops/mil_pool.py::pool_layout), not by a flag.
// Two cluster barriers a tile order the exchange. Per tile the products take
// about half the time; the exchange, the scores and the weighted sum the
// rest (PERF.md).
//
// The first design gave each 32 instances a block that read all of V
// through shared memory, read its h rows twice and left the merge to a
// second launch of 16 blocks (PERF.md).
//
// Bound with ctypes: plain C entry points, launched on the caller's stream,
// allocating nothing; each returns a cudaError_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "int8_wgmma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace hipac_int8;  // mbarriers, bulk copies

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTR = 64;        // instances of a tile
constexpr int kHS = 128;       // width of a slice of H
constexpr int kLDX = kHS + 4;  // padded row of the exchange buffer
constexpr int kMaxD = 4096;
constexpr int kMaxH = 512;
constexpr int kMaxRuns = 256;              // runs (partials) of one bag
constexpr int kMaxDs = 512;                // depth slice of a rank, at most
constexpr int kAcc = kMaxDs / kThreads;    // acc columns a thread, at most
constexpr int kSmemCap = 227 * 1024;       // dynamic shared memory a block
constexpr float kMasked = -1e30f;          // as the Pallas kernel

static_assert(kThreads == 256 && kTR == 64 && kHS == 128,
              "the 2 x 4 grid of 32 x 32 warp tiles assumes these");

// Row pitch of a staged h slice: 16-byte aligned, and rows 1 apart 4 banks
// apart at ds = 128, so the 8 x 4 lanes of an A fragment load hit 32 banks.
__host__ __device__ inline int h_pitch(int ds) { return ds + (ds % 8 ? 8 : 4); }

// Row pitch of the resident V slice: rows 1 apart 8 banks apart, so the 4 x 8
// lanes of a B fragment load hit 32 different banks (H a multiple of 32).
__host__ __device__ inline int v_pitch(int h) { return h + 8; }

// Dynamic shared memory of a block, in bytes: [V slice] ring X (vb, w)
// (scores, probabilities, own scores, mask) merge weights.
__host__ __device__ inline int pool_smem(int ds, int h, int resident,
                                         int stages) {
  return 4 * ((resident ? ds * v_pitch(h) : 0) + stages * kTR * h_pitch(ds) +
              kTR * kLDX + 2 * h + 4 * kTR + kMaxRuns);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// x = hi + lo for TF32 products: hi = x rounded to the nearest TF32 (10
// mantissa bits, ties away from zero, as cvt.rna.tf32.f32 but in two integer
// operations: x is finite), lo = x - hi exactly in float32; the tensor cores
// read lo's top 19 bits (its own rounding error is 2^-11 of lo, itself at
// most 2^-11 of x).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c (16 x 8, float32) += a (16 x 8, TF32, row) * b (8 x 8, TF32, col); lane
// (g, t) = (lane / 4, lane % 4) holds a: (g, t) (g + 8, t) (g, t + 4)
// (g + 8, t + 4); b: (t, g) (t + 4, g); c: (g, 2t) (g, 2t + 1) (g + 8, 2t)
// (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c = a * b (c's old value unused).
__device__ __forceinline__ void mma_tf32_first(float (&c)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
    mil_pool_kernel(const float* __restrict__ h,
                    const unsigned char* __restrict__ mask,
                    const float* __restrict__ v, const float* __restrict__ vb,
                    const float* __restrict__ w, int K, int D, int H, int cs,
                    int ds, int runs, int stages, float* __restrict__ ws_m,
                    float* __restrict__ ws_l, float* __restrict__ ws_acc,
                    int* __restrict__ tickets, float* __restrict__ out) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[2], vbar;
  __shared__ int last;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bag = blockIdx.x / (cs * runs);
  const int run = (blockIdx.x / cs) % runs;
  const int tiles = (K + kTR - 1) / kTR;
  const int t_begin = static_cast<int>(static_cast<int64_t>(run) * tiles / runs);
  const int t_end = static_cast<int>(static_cast<int64_t>(run + 1) * tiles / runs);
  const int units = t_end - t_begin;
  const int d0 = rank * ds;
  const int dw = max(0, min(ds, D - d0));  // this rank's depth, a multiple of 4
  const int hp = h_pitch(ds);
  const int stage = kTR * hp;

  const int vp = v_pitch(H);
  float* vs = smem;  // V[d0 .. d0 + dw) x H (pitch vp), when resident
  float* ring = smem + (kResident ? ds * vp : 0);
  float* X = ring + stages * stage;   // this block's 64 x 128 partial
  float* vbw = X + kTR * kLDX;        // vb, then w
  float* sall = vbw + 2 * H;          // the tile's 64 scores
  float* prob = sall + kTR;           // exp(a - m) of the tile's rows
  float* sown = prob + kTR;           // running scores of this rank's rows
  float* msk = sown + kTR;            // the tile's mask, 1 or 0
  float* mw = msk + kTR;              // merge weights (last block only)
  __shared__ float stat[2];           // the tile's (m, sum of exp(a - m))
  const float* hbag = h + static_cast<int64_t>(bag) * K * D;

  // tile u of the run into stage u % stages, its rows' slice of depth by
  // one bulk copy a row: thread 0 announces the bytes, then (after a block
  // barrier) lanes 0-7 of the 8 warps issue a row each
  auto announce = [&](int u) {
    const int rows = min(kTR, K - (t_begin + u) * kTR);
    mbar_arrive_expect_tx(&full[u % stages], static_cast<uint32_t>(rows * dw * 4));
  };
  auto issue = [&](int u) {
    const int row0 = (t_begin + u) * kTR;
    const int r = warp + kWarps * lane;
    if (dw > 0 && lane < kTR / kWarps && r < K - row0)
      bulk_copy_g2s(ring + (u % stages) * stage + r * hp,
                    hbag + static_cast<int64_t>(row0 + r) * D + d0,
                    static_cast<uint32_t>(dw) * 4, &full[u % stages]);
  };

  for (int e = tid; e < stages * stage; e += kThreads) ring[e] = 0.f;
  for (int e = tid; e < H; e += kThreads) {
    vbw[e] = vb[e];
    vbw[H + e] = w[e];
  }
  fence_async_proxy();
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init(&vbar, 1);
    mbar_init_fence();
    if (kResident) mbar_arrive_expect_tx(&vbar, static_cast<uint32_t>(dw) * H * 4);
    for (int u = 0; u < stages && u < units; ++u) announce(u);
  }
  __syncthreads();
  if (kResident) {  // V's rows of this slice, one bulk copy a row
    for (int r = tid; r < dw; r += kThreads)
      bulk_copy_g2s(vs + r * vp, v + static_cast<int64_t>(d0 + r) * H,
                    static_cast<uint32_t>(H) * 4, &vbar);
  }
  for (int u = 0; u < stages && u < units; ++u) issue(u);

  float m_run = kMasked, l_run = 0.f;
  float acc_d[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc_d[i] = 0.f;
  if (kResident) mbar_wait(&vbar, 0);

  const int own = kTR / cs;  // rows this rank forms the scores of
  const int cs_log = __ffs(cs) - 1;
  for (int u = 0; u < units; ++u) {
    const int s = u % stages;
    const float* hs = ring + s * stage;
    const int row0 = (t_begin + u) * kTR;
    const int rows = min(kTR, K - row0);
    // the tile's mask, read while the products run
    const bool real = tid < rows && mask[static_cast<int64_t>(bag) * K + row0 + tid];
    mbar_wait(&full[s], static_cast<uint32_t>((u / stages) & 1));

    for (int hc0 = 0; hc0 < H; hc0 += kHS) {
      if (hc0 > 0) cluster.sync();  // every owner has read the last slice
      // the 64 x 128 partial of this slice on the tensor cores, 3xTF32:
      // warp (wm, wn) owns rows 32 wm .. and columns 32 wn .. as 2 x 4
      // m16n8k8 tiles; each operand x = hi + lo (split_tf32), and lo*hi +
      // hi*lo + hi*hi keeps float32 accuracy
      float pc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) pc[mt][nt][e] = 0.f;
      const int g = lane >> 2, t4 = lane & 3;
      const int wm = warp >> 2, wn = warp & 3;
      const float* ha = hs + (32 * wm + g) * hp + t4;
      // the A (h) and B (V) fragments of depths k .. k + 7, split
      auto fragments = [&](int k, uint32_t (&ah)[2][4], uint32_t (&al)[2][4],
                           uint32_t (&bh)[4][2], uint32_t (&bl)[4][2]) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* hr = ha + 16 * mt * hp + k;  // zeros past dw
          split_tf32(hr[0], ah[mt][0], al[mt][0]);
          split_tf32(hr[8 * hp], ah[mt][1], al[mt][1]);
          split_tf32(hr[4], ah[mt][2], al[mt][2]);
          split_tf32(hr[8 * hp + 4], ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = hc0 + 32 * wn + 8 * nt + g;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kk = k + t4 + 4 * e;
            float x = 0.f;
            if (col < H && kk < dw)
              x = kResident ? vs[kk * vp + col]
                            : __ldg(v + static_cast<int64_t>(d0 + kk) * H + col);
            split_tf32(x, bh[nt][e], bl[nt][e]);
          }
        }
      };
      // 16 depths at a time: their three products a tile on the tensor
      // cores (small terms first), then added to the running sums in
      // float32 (rounded to nearest), so that the tensor cores' own
      // accumulation stays within 16 depths
      for (int k = 0; k < dw; k += 16) {
        float t[2][4][4];
        uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
        fragments(k, ah, al, bh, bl);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            mma_tf32_first(t[mt][nt], al[mt], bh[nt]);
            mma_tf32(t[mt][nt], ah[mt], bl[nt]);
            mma_tf32(t[mt][nt], ah[mt], bh[nt]);
          }
        if (k + 8 < dw) {  // the same for every lane
          fragments(k + 8, ah, al, bh, bl);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              mma_tf32(t[mt][nt], al[mt], bh[nt]);
              mma_tf32(t[mt][nt], ah[mt], bl[nt]);
              mma_tf32(t[mt][nt], ah[mt], bh[nt]);
            }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) pc[mt][nt][e] += t[mt][nt][e];
      }
      // the partial into this block's X, read by the rows' owners
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          float* xr = X + (32 * wm + 16 * mt + 8 * hi + g) * kLDX + 32 * wn + 2 * t4;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            *reinterpret_cast<float2*>(xr + 8 * nt) =
                make_float2(pc[mt][nt][2 * hi], pc[mt][nt][2 * hi + 1]);
        }
      if (hc0 == 0 && tid < kTR) msk[tid] = real ? 1.f : 0.f;
      cluster.sync();  // every rank's partial of this slice is in its X

      // rows rank * own + lr of this rank (warp w: lr = w, w + 8, ...; 8 /
      // cs of them): the cs ranks' partials, all 8 loads in flight at once,
      // summed in rank order; then w . tanh(. + vb) over this slice's
      // columns (lane: 4 columns), summed by shuffles; the finished score
      // goes to every rank
      const int c = hc0 + 4 * lane;
      float4 vb4 = make_float4(0.f, 0.f, 0.f, 0.f), w4 = vb4;
      if (c < H) {
        vb4 = *reinterpret_cast<const float4*>(vbw + c);
        w4 = *reinterpret_cast<const float4*>(vbw + H + c);
      }
      float4 part[kWarps];  // (row j, rank q) at j * cs + q: own / 8 * cs = 8
#pragma unroll
      for (int e = 0; e < kWarps; ++e) {
        const int j = e >> cs_log, q = e & (cs - 1);
        part[e] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(
            X + (rank * own + warp + kWarps * j) * kLDX + 4 * lane, q));
      }
      // each row's sum over the ranks into this block's own rows of X
      // (which only this block reads)
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int e = 0; e < kWarps; ++e) {
        t.x += part[e].x;
        t.y += part[e].y;
        t.z += part[e].z;
        t.w += part[e].w;
        if ((e & (cs - 1)) == cs - 1) {
          *reinterpret_cast<float4*>(
              X + (rank * own + warp + kWarps * (e >> cs_log)) * kLDX + 4 * lane) = t;
          t = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      const bool last_slice = hc0 + kHS >= H;
#pragma unroll 1
      for (int lr = warp; lr < own; lr += kWarps) {
        const float4 x = *reinterpret_cast<const float4*>(
            X + (rank * own + lr) * kLDX + 4 * lane);
        float sc = 0.f;
        if (c < H) {
          sc = tanhf(x.x + vb4.x) * w4.x;
          sc = fmaf(tanhf(x.y + vb4.y), w4.y, sc);
          sc = fmaf(tanhf(x.z + vb4.z), w4.z, sc);
          sc = fmaf(tanhf(x.w + vb4.w), w4.w, sc);
        }
        sc = warp_sum(sc) + (hc0 == 0 ? 0.f : sown[lr]);
        if (lane == 0) {
          if (!last_slice) {
            sown[lr] = sc;
          } else {
            const int r = rank * own + lr;
            const float a = msk[r] != 0.f ? sc : kMasked;
            for (int q = 0; q < cs; ++q) *cluster.map_shared_rank(sall + r, q) = a;
          }
        }
      }
    }
    cluster.sync();  // the tile's scores are everywhere; X is free again

    // the online state, formed once by warp 0 (rows lane and lane + 32, a
    // fixed shuffle tree) and read by every thread
    if (warp == 0) {
      const float a0 = lane < rows ? sall[lane] : -INFINITY;
      const float a1 = lane + 32 < rows ? sall[lane + 32] : -INFINITY;
      const float mt = fmaxf(warp_max(fmaxf(a0, a1)), m_run);
      const float p0 = expf(a0 - mt), p1 = expf(a1 - mt);
      prob[lane] = p0;
      prob[lane + 32] = p1;
      const float lt = warp_sum(p0 + p1);
      if (lane == 0) {
        stat[0] = mt;
        stat[1] = lt;
      }
    }
    __syncthreads();
    const float mt = stat[0];
    const float scale = expf(m_run - mt);
    l_run = fmaf(l_run, scale, stat[1]);
    m_run = mt;
    // acc over this rank's depth slice, four partial sums a column
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int d = tid + i * kThreads;
      if (d < dw) {
        const float* hd = hs + d;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        int r = 0;
        for (; r + 4 <= rows; r += 4) {
          s0 = fmaf(prob[r], hd[r * hp], s0);
          s1 = fmaf(prob[r + 1], hd[(r + 1) * hp], s1);
          s2 = fmaf(prob[r + 2], hd[(r + 2) * hp], s2);
          s3 = fmaf(prob[r + 3], hd[(r + 3) * hp], s3);
        }
        for (; r < rows; ++r) s0 = fmaf(prob[r], hd[r * hp], s0);
        acc_d[i] = fmaf(acc_d[i], scale, (s0 + s1) + (s2 + s3));
      }
    }
    const bool next = u + stages < units;
    if (tid == 0 && next) announce(u + stages);
    __syncthreads();  // every thread is done with this stage, prob and stat
    if (next) issue(u + stages);
  }
  // no block leaves while another may still read its scores
  cluster.sync();

  // the run's partial, then the bag's ticket
  const int64_t slot = static_cast<int64_t>(bag) * runs + run;
  if (rank == 0 && tid == 0) {
    ws_m[slot] = m_run;
    ws_l[slot] = l_run;
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int d = tid + i * kThreads;
    if (d < dw) ws_acc[slot * D + d0 + d] = acc_d[i];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + bag, 1) == runs * cs - 1;
  __syncthreads();
  if (!last) return;

  // the last block of the bag merges its runs in index order
  __threadfence();
  const float* mb = ws_m + static_cast<int64_t>(bag) * runs;
  const float* lb = ws_l + static_cast<int64_t>(bag) * runs;
  if (tid == 0) {
    float M = kMasked;
    for (int q = 0; q < runs; ++q) M = fmaxf(M, __ldcg(mb + q));
    prob[0] = M;
  }
  __syncthreads();
  for (int q = tid; q < runs; q += kThreads) mw[q] = expf(__ldcg(mb + q) - prob[0]);
  __syncthreads();
  if (tid == 0) {
    float L = 0.f;
    for (int q = 0; q < runs; ++q) L = fmaf(__ldcg(lb + q), mw[q], L);
    prob[1] = fmaxf(L, 1e-30f);
    tickets[bag] = 0;  // ready for the next call
  }
  __syncthreads();
  const float* ab = ws_acc + static_cast<int64_t>(bag) * runs * D;
  for (int d = tid; d < D; d += kThreads) {
    float sum = 0.f;
    for (int q = 0; q < runs; ++q)
      sum = fmaf(__ldcg(ab + static_cast<int64_t>(q) * D + d), mw[q], sum);
    out[static_cast<int64_t>(bag) * D + d] = sum / prob[1];
  }
}

// Launch configuration of a layout; cudaErrorInvalidValue if it is not one.
int configure(long long b, long long d, long long hd, int cs, int runs,
              int resident, int stages, cudaLaunchConfig_t* cfg,
              cudaLaunchAttribute* attr, int* ds_out) {
  if (b < 1 || d < 4 || hd < 4 || d > kMaxD || hd > kMaxH || b > 65535 ||
      d % 4 || hd % 4 || (cs != 1 && cs != 2 && cs != 4 && cs != 8) ||
      runs < 1 || runs > kMaxRuns || (stages != 1 && stages != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  int ds = static_cast<int>((d + cs - 1) / cs);
  ds = (ds + 3) / 4 * 4;
  if (ds > kAcc * kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = pool_smem(ds, static_cast<int>(hd), resident, stages);
  if (smem > kSmemCap) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      resident ? mil_pool_kernel<true> : mil_pool_kernel<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *cfg = {};
  cfg->gridDim = dim3(static_cast<unsigned>(b * runs * cs));
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cs);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  *ds_out = ds;
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// h: (b, k, d) float32, d a multiple of 4; v: (d, hd), hd a multiple of 4;
// vb, w: (hd,); mask: (b, k) bytes; h and v 16-byte aligned.
// cs, resident, stages: ops/mil_pool.py::pool_layout; runs: pool_runs.
// ws_m, ws_l: (b, runs); ws_acc: (b, runs, d); tickets: (b,) int32, all 0
// (the kernel leaves them 0); out: (b, d).
extern "C" int hipac_mil_attention_pool(
    const float* h, const unsigned char* mask, const float* v, const float* vb,
    const float* w, long long b, long long k, long long d, long long hd,
    int cs, int runs, int resident, int stages, float* ws_m, float* ws_l,
    float* ws_acc, int* tickets, float* out, void* stream) {
  if (k < 1 || k > INT32_MAX || runs > (k + kTR - 1) / kTR ||
      reinterpret_cast<uintptr_t>(h) % 16 || reinterpret_cast<uintptr_t>(v) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int ds = 0;
  const int rc = configure(b, d, hd, cs, runs, resident, stages, &cfg, &attr, &ds);
  if (rc != cudaSuccess) return rc;
  cfg.stream = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, resident ? mil_pool_kernel<true> : mil_pool_kernel<false>, h, mask,
      v, vb, w, static_cast<int>(k), static_cast<int>(d), static_cast<int>(hd),
      cs, ds, runs, stages, ws_m, ws_l, ws_acc, tickets, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of a layout the current card runs at once.
extern "C" int hipac_mil_pool_active_clusters(long long d, long long hd,
                                              int cs, int resident, int stages,
                                              int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int ds = 0;
  const int rc = configure(1, d, hd, cs, 1, resident, stages, &cfg, &attr, &ds);
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, resident ? mil_pool_kernel<true> : mil_pool_kernel<false>, &cfg));
}
