// Fused int8 ResNet stage 1: both 64-channel BasicBlocks (four 3x3 int8
// convolutions with int32 accumulation, each followed by dequantize + bias
// (+ residual) + ReLU + requantize) in one launch, for sm_90a.
//
// Replaces the TPU kernel of the JAX package's ops/pallas/int8_block.py
// (`fused_stage1_int8`, body `_kernel`, `_conv3x3`, `_requant`): the input
// plane is read from device memory once and the output plane written once;
// the three intermediate planes never leave the chip.
//
// What bounds it: operations (4 x 2 x 576 x 64 per pixel = 4,608 int8
// operations per byte moved, against ~590 for the card).
//
// Design. The TPU kernel holds one whole padded image and its intermediate in
// fast memory per grid step; an SM's 227 KB of shared memory does not hold two
// such planes (56 x 56 x 64 int8 is 200.7 KB). Here a thread-block cluster
// holds an image: each of its (up to eight) blocks owns a slab of R output
// rows at full width of all three planes (input, intermediate, block output;
// three slabs of R + 2 rows in shared memory that take turns, one zero column
// each side, pixel pitch 80 bytes against bank conflicts). After each
// convolution a `cluster.sync()` lets every block copy its two halo rows (the
// neighbours' edge rows) out of the neighbours' shared memory, so no row is
// computed twice. Rows outside the image are forced to zero after their
// requantization: the reference zero-pads every intermediate plane. Each
// convolution is the implicit GEMM of int8_wgmma.cuh: four warpgroups take
// tiles of 64 flat pixels of the slab, `wgmma.m64n64k32` with A fragments
// read by `ldmatrix` in place (a tap is the tile shifted by whole pixels) and
// B read by the tensor cores from the convolution's 36 KB weight image, which
// the host packed in core-matrix order and one bulk copy lands. Two weight
// buffers with an `mbarrier` each: the weights of convolution k + 2 arrive
// while k + 1 runs. The scales, the biases and the pixel offsets of the flat
// tiles sit in shared memory (no division and no device-memory read in the
// epilogue), the requantization takes one branch per eight values
// (int8_mma.cuh), and the result slab is written with 16-byte stores. What
// is left at (512, 56, 56, 64), in this order: the epilogues, which no
// product overlaps (the four warpgroups multiply together and then
// requantize together); the products themselves (an n64 product reads as
// many shared-memory bytes for A as for B); `cluster.sync()` with the halo
// copy; the set-up of a block.
//
// The first design gave each block a band of 7 output rows and computed the
// halo rows of every convolution again (R + 6, + 4, + 2 rows: 1.43x the
// arithmetic) on `mma.sync.m16n8k32` with 32-pixel warp tiles, and stopped
// between convolutions to fetch the weights: 2.39-2.55 ms at (512, 56, 56,
// 64) on an NVIDIA H100 80GB HBM3 at 700 W; before that, B fragments from
// device memory took 1.7x as long. This design's first version (scales and
// biases from device memory, a division per pixel, a branch per value) took
// 1.93 ms; a version that ran the tiles without halo rows before a split
// cluster barrier was slower than this one (the second block-wide barrier
// per convolution cost more than the wait it hid) (PERF.md).
//
// Built by ops/build.py (nvcc, plain C entry point, no PyTorch headers).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "int8_wgmma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace hipac_int8;

constexpr int kC = 64;          // channels in and out
constexpr int kPix = 80;        // bytes between two pixels of a slab
constexpr int kSteps = 18;      // K steps of 32 bytes: 2 channel halves x 9 taps
constexpr int kWBytes = 9 * kC * kC;  // one convolution's weight image
constexpr int kThreads = 512;   // four warpgroups a block
constexpr int kMaxCluster = 8;  // the largest portable cluster
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

// One 3x3 convolution over this block's slab. `src` holds rows + 2 rows (its
// halo rows first and last), `dst` receives rows 1 .. rows, whose first is
// image row `img_row0`; both are padded slabs of (w + 2) pixels a row with
// the plane's column x at pixel x + 1. `res` (or null) is a slab aligned with
// `dst`. `msc` and `bias` are the convolution's scales and biases in shared
// memory. `wsm` holds the convolution's weight image, `a_off` the A offset of
// each K step, `pix_off[m]` the pixel index in a slab of the window of flat
// pixel m (its top-left; a table, because an integer division has a latency
// of some 200 cycles).
__device__ __forceinline__ void conv_slab(
    const int8_t* src, int8_t* dst, const int8_t* res, int rows, int img_row0,
    int h, int w, const int8_t* wsm, const int* a_off, const int* pix_off,
    const float* msc, const float* bias, float res_scale, float s_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, wg_warp = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int wp = w + 2;
  const int m_total = rows * w;
  const int tiles = (m_total + 63) / 64;
  // flat pixels from here on lie in rows outside the image
  const int m_inside = img_row0 >= h ? 0 : (h - img_row0 < rows ? (h - img_row0) * w : m_total);
  const float inv_s = __frcp_rn(s_out);
  const uint64_t b_desc = wgmma_desc(wsm);
  for (int tile = wg; tile < tiles; tile += kThreads / 128) {
    const int m0 = tile * 64 + wg_warp * 16;
    // this lane's ldmatrix row: pixel (lane & 7) + 8 * bit 3 of the lane of
    // the warp's 16, at k offset 16 * bit 4; the window's top-left is src
    // pixel (r, x)
    const int ml = m0 + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int a_base =
        pix_off[ml < m_total ? ml : 0] * kPix + 16 * (lane >> 4);
    int acc[32];
    wg_mma_steps<64, kSteps>(acc, src + a_base, a_off, kSteps, b_desc, true);
    wg_mma_finish(acc);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + g + 8 * hf;
      if (m >= m_total) continue;
      const bool inside = m < m_inside;
      const int centre = (pix_off[m] + wp + 1) * kPix;
#pragma unroll
      for (int ng = 0; ng < 8; ng += 4) {  // four 8-channel tiles at a time
        int q[8] = {};  // a row outside the image is zero
        if (inside) {
          float y[8];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ch = (ng + j) * 8 + 2 * t;
            const float2 ms = *reinterpret_cast<const float2*>(msc + ch);
            const float2 bs = *reinterpret_cast<const float2*>(bias + ch);
            float y0 = dequant(acc[(ng + j) * 4 + 2 * hf], ms.x, bs.x);
            float y1 = dequant(acc[(ng + j) * 4 + 2 * hf + 1], ms.y, bs.y);
            if (res != nullptr) {
              const unsigned int rr =
                  *reinterpret_cast<const unsigned short*>(res + centre + ch) ^
                  0x8080u;
              y0 = __fadd_rn(y0, __fmul_rn(biased_byte_to_float(rr & 0xFFu),
                                           res_scale));
              y1 = __fadd_rn(y1, __fmul_rn(biased_byte_to_float(rr >> 8),
                                           res_scale));
            }
            y[2 * j] = y0;
            y[2 * j + 1] = y1;
          }
          requant_group(y, s_out, inv_s, 0.0f, q);  // the clip is the ReLU
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          *reinterpret_cast<char2*>(dst + centre + (ng + j) * 8 + 2 * t) =
              make_char2(static_cast<signed char>(q[2 * j]),
                         static_cast<signed char>(q[2 * j + 1]));
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_stage1_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                    const float* __restrict__ msc, const float* __restrict__ bias,
                    const float* __restrict__ scal, int8_t* __restrict__ out,
                    int h, int w, int rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t wbar[2];
  __shared__ int a_off[kSteps];
  // the four convolutions' scales and biases (from device memory they came
  // from L2 for every value and took most of the epilogue)
  __shared__ __align__(8) float msc_sm[4 * kC], bias_sm[4 * kC];
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int wp = w + 2;
  const int rowb = wp * kPix;
  const int slab_bytes = (rows + 2) * rowb;
  int8_t* wbuf = reinterpret_cast<int8_t*>(smem_raw);  // two weight images
  int8_t* slab0 = wbuf + 2 * kWBytes;
  int8_t* slab1 = slab0 + slab_bytes;
  int8_t* slab2 = slab1 + slab_bytes;
  int* pix_off = reinterpret_cast<int*>(slab2 + slab_bytes);
  const int tid = threadIdx.x;
  const long long img = blockIdx.x / ranks;
  const int r0 = rank * rows;  // this block's first image row
  const int8_t* xin = x + img * h * w * kC;
  int8_t* xout = out + img * h * w * kC;

  for (int m = tid; m < rows * w; m += kThreads) {
    pix_off[m] = (m / w) * wp + m % w;
  }
  if (tid < 4 * kC) {
    msc_sm[tid] = msc[tid];
    bias_sm[tid] = bias[tid];
  }
  if (tid < kSteps) {
    const int tap = tid % 9;
    a_off[tid] = ((tap / 3) * wp + tap % 3) * kPix + (tid / 9) * 32;
  }
  // the weights of the first two convolutions are on their way while the
  // slabs are set up
  auto fetch_weights = [&](int conv) {
    mbar_arrive_expect_tx(&wbar[conv & 1], kWBytes);
    bulk_copy_g2s(wbuf + (conv & 1) * kWBytes, wt + conv * kWBytes, kWBytes,
                  &wbar[conv & 1]);
  };
  if (tid == 0) {
    mbar_init(&wbar[0], 1);
    mbar_init(&wbar[1], 1);
    mbar_init_fence();
    fetch_weights(0);
    fetch_weights(1);
  }
  // the input rows are on their way (rows outside the image stay zero: the
  // convolution's padding) while the rest is zeroed once: the pad columns
  // stay zero, and so do halo rows outside the image
  const int warp = tid >> 5, lane = tid & 31;
  const int row16 = rowb / 16;
  for (int j = warp; j < rows + 2; j += kThreads / 32) {  // a warp a row
    const int iy = r0 - 1 + j;
    const bool inside = iy >= 0 && iy < h;
    if (inside) {
      for (int i = lane; i < w * 4; i += 32) {
        cp_async_16(slab0 + j * rowb + kPix + (i >> 2) * kPix + (i & 3) * 16,
                    xin + (static_cast<long long>(iy) * w) * kC + i * 16);
      }
    }
    for (int i = lane; i < row16; i += 32) {
      const int px = i / (kPix / 16);
      if (!inside || px == 0 || px == wp - 1) {
        reinterpret_cast<uint4*>(slab0 + j * rowb)[i] =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  for (int e = tid; e < 2 * slab_bytes / 16; e += kThreads) {
    reinterpret_cast<uint4*>(slab1)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_wait_all();
  __syncthreads();

  const float s_x = scal[0], s_y1_b0 = scal[1], s_o_b0 = scal[2];
  const float s_y1_b1 = scal[3], s_o_b1 = scal[4];
  // block 0: y1 = requant(conv1(x)); x1 = requant(conv2(y1) + x * s_x)
  // block 1: the input's slab takes y1, the first y1's the result
  int8_t* const srcs[4] = {slab0, slab1, slab2, slab0};
  int8_t* const dsts[4] = {slab1, slab2, slab0, slab1};
  const int8_t* const ress[4] = {nullptr, slab0, nullptr, slab2};
  const float res_scales[4] = {0.0f, s_x, 0.0f, s_o_b0};
  const float out_scales[4] = {s_y1_b0, s_o_b0, s_y1_b1, s_o_b1};
#pragma unroll
  for (int conv = 0; conv < 4; ++conv) {
    mbar_wait(&wbar[conv & 1], (conv >> 1) & 1);
    conv_slab(srcs[conv], dsts[conv], ress[conv], rows, r0, h, w,
              wbuf + (conv & 1) * kWBytes, a_off, pix_off, msc_sm + conv * kC,
              bias_sm + conv * kC, res_scales[conv], out_scales[conv]);
    if (conv == 3) break;
    // every block of the image has written its rows of this plane, and every
    // warp here is past its reads of the weights: the weights after next take
    // their place, and the neighbours' edge rows become this slab's halo rows
    cluster.sync();
    if (tid == 0 && conv + 2 < 4) fetch_weights(conv + 2);
    int8_t* dst = dsts[conv];
    if (rank > 0) {
      const uint4* above = reinterpret_cast<const uint4*>(
          cluster.map_shared_rank(dst + rows * rowb, rank - 1));
      for (int e = tid; e < row16; e += kThreads) {
        reinterpret_cast<uint4*>(dst)[e] = above[e];
      }
    }
    if (rank + 1 < ranks) {
      const uint4* below = reinterpret_cast<const uint4*>(
          cluster.map_shared_rank(dst + rowb, rank + 1));
      for (int e = tid; e < row16; e += kThreads) {
        reinterpret_cast<uint4*>(dst + (rows + 1) * rowb)[e] = below[e];
      }
    }
    __syncthreads();
  }
  __syncthreads();

  for (int j = warp; j < rows && r0 + j < h; j += kThreads / 32) {
    for (int i = lane; i < w * 4; i += 32) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          slab1 + (j + 1) * rowb + kPix + (i >> 2) * kPix + (i & 3) * 16);
      *reinterpret_cast<uint4*>(
          xout + (static_cast<long long>(r0 + j) * w) * kC + i * 16) = v;
    }
  }
  // no block leaves while a neighbour may still read its halo rows
  cluster.sync();
}

// Shared memory of a block that owns `rows` rows of a plane `w` wide: two
// weight images, three slabs of rows + 2 rows, and the pixel table.
inline long long slab_smem(int w, int rows) {
  return 2LL * kWBytes + 3LL * (rows + 2) * (w + 2) * kPix + 4LL * rows * w;
}

int configure(int h, int w, int rows, int cluster, long long b,
              cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  if (b <= 0 || h < 1 || w < 1 || rows < 1 || cluster < 1 ||
      cluster > kMaxCluster || static_cast<long long>(rows) * cluster < h ||
      b * cluster > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const long long smem = slab_smem(w, rows);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_stage1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned int>(b * cluster));
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = static_cast<size_t>(smem);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned int>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// x: (b, h, w, 64) int8 contiguous. wt: (4, 36864) int8, per convolution the
// shared-memory image [ci / 32][ky * 3 + kx][o / 8][2][8][16]
// (pack_stage1_kernels of ops/int8_block.py). msc, bias: (4, 64) float32.
// scal: (5,) float32 on the device, [s_x, s_y1_b0, s_o_b0, s_y1_b1, s_o_b1].
// out: (b, h, w, 64) int8. A cluster of `cluster` blocks (at most 8) takes an
// image, `rows` rows a block (rows * cluster >= h); the slabs must fit shared
// memory. Returns a cudaError_t as int (0 = launched).
extern "C" int hipac_fused_stage1_int8(const void* x, const void* wt,
                                       const void* msc, const void* bias,
                                       const void* scal, void* out, long long b,
                                       int h, int w, int rows, int cluster,
                                       void* stream) {
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wt) % 16 ||
      reinterpret_cast<uintptr_t>(msc) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int rc = configure(h, w, rows, cluster, b, &cfg, &attr);
  if (rc != cudaSuccess) return rc;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, fused_stage1_kernel, static_cast<const int8_t*>(x),
      static_cast<const int8_t*>(wt), static_cast<const float*>(msc),
      static_cast<const float*>(bias), static_cast<const float*>(scal),
      static_cast<int8_t*>(out), h, w, rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many such clusters the card runs at once (cudaOccupancyMaxActiveClusters)
// into *clusters. Returns a cudaError_t as int.
extern "C" int hipac_fused_stage1_int8_active_clusters(int h, int w, int rows,
                                                       int cluster,
                                                       int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int rc = configure(h, w, rows, cluster, 1, &cfg, &attr);
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, fused_stage1_kernel, &cfg));
}
