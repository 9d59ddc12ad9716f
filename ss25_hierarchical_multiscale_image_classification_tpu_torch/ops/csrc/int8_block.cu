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
// such planes. Here a block of sixteen warps takes a band of R output rows of
// one image at full width. It loads R + 8 input rows (one zero column each
// side), and computes convolution 1 on R + 6 rows, 2 on R + 4 (residual from
// the input band), 3 on R + 2 and 4 on R (residual from convolution 2's
// band), through three int8 bands in shared memory that take turns. The halo
// rows are computed again by the neighbouring band (1.43x the arithmetic at
// R = 7). A halo row that lies outside the image is forced to zero after its
// requantization: the reference zero-pads every intermediate plane, so such a
// row is 0 and not the convolution of zeros plus a bias. Each convolution is
// the implicit GEMM of int8_conv.cu: `mma.sync.m16n8k32` on A fragments read
// with `ldmatrix` from the band as contiguous windows (pixel pitch 80 bytes
// against bank conflicts) and B fragments read with `ldmatrix` from the
// convolution's 36 KB of weights [o][ky][kx][ci], which are copied to shared
// memory before each convolution (row pitch 592 bytes). The result band is
// staged in shared memory and written with 16-byte stores. The first version
// read its B fragments from device memory through L1, eight cache lines per
// load instruction, and took 1.7x as long (PERF.md).
//
// Built by ops/build.py (nvcc, plain C entry point, no PyTorch headers).

#include <cuda_runtime.h>

#include <cstdint>

#include "int8_mma.cuh"

namespace {

using hipac_int8::cp_async_16;
using hipac_int8::cp_async_wait_all;
using hipac_int8::dequant;
using hipac_int8::ldmatrix_x4;
using hipac_int8::mma_s8;
using hipac_int8::requant;

constexpr int kC = 64;         // channels in and out
constexpr int kPix = 80;       // bytes between two pixels of a band
constexpr int kK = 9 * kC;     // weights per output channel
constexpr int kWPitch = kK + 16;  // bytes per output channel in shared memory
constexpr int kWBytes = kC * kWPitch;
constexpr int kThreads = 512;   // sixteen warps a block
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

// The weights of one convolution, (64, 576) [o][ky][kx][ci] in device memory,
// on their way to shared memory at a pitch of kWPitch bytes.
__device__ __forceinline__ void copy_weights_async(const int8_t* __restrict__ wt,
                                                   int8_t* wsm) {
  constexpr int kPieces = kK / 16;
  for (int e = threadIdx.x; e < kC * kPieces; e += blockDim.x) {
    const int n = e / kPieces, piece = e % kPieces;
    cp_async_16(wsm + n * kWPitch + piece * 16, wt + n * kK + piece * 16);
  }
}

// One 3x3 convolution over a band. `src` holds rows_out + 2 rows, `dst`
// receives rows_out rows whose first is image row `img_row0`; both are padded
// bands of `rowb` bytes a row with the plane's column x at pixel x + 1. `res`
// (or null) is a band whose row r + 2 lines up with dst row r. `wsm` holds
// the convolution's weights (copy_weights_async).
__device__ __forceinline__ void conv_band(
    const int8_t* src, int8_t* dst, const int8_t* res, int rows_out,
    int img_row0, int h, int w, int rowb, const int8_t* wsm,
    const float* __restrict__ msc, const float* __restrict__ bias,
    float res_scale, float s_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m_total = rows_out * w;
  const int tiles = (m_total + 31) / 32;
  const float inv_s = __frcp_rn(s_out);
  // the B rows this lane addresses for ldmatrix: channel (lane & 7) + 8 * bit
  // 4 of the lane (of a pair of 8-channel tiles) at k offset 16 * bit 3
  const int8_t* bbase = wsm + ((lane & 7) + 8 * (lane >> 4)) * kWPitch +
                        16 * ((lane >> 3) & 1);
  for (int tile = warp; tile < tiles; tile += warps) {
    int base[2][2];  // this thread's output pixels: rows g and g + 8
    int row[2][2];
    int abase[2];    // the A row this lane addresses for ldmatrix
    bool active[2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      active[mi] = tile * 32 + mi * 16 < m_total;  // the same for the warp
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = tile * 32 + mi * 16 + g + 8 * hf;
        const bool ok = m < m_total;
        const int mm = ok ? m : 0;
        const int r = mm / w, x = mm % w;
        base[mi][hf] = r * rowb + x * kPix;
        row[mi][hf] = ok ? r : -1;
      }
      // row (lane & 7) + 8 * bit 3 of the lane, at k offset 16 * bit 4
      const int m = tile * 32 + mi * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
      const int mm = m < m_total ? m : 0;
      abase[mi] = (mm / w) * rowb + (mm % w) * kPix + 16 * (lane >> 4);
    }
    int acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mi][nt][j] = 0;
      }
    }
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int aoff = ky * rowb + kx * kPix + kk * 32;
          const int woff = (ky * 3 + kx) * kC + kk * 32;
          uint32_t bf[8][2];
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t r4[4];
            ldmatrix_x4(r4, bbase + np * 16 * kWPitch + woff);
            bf[2 * np][0] = r4[0];
            bf[2 * np][1] = r4[1];
            bf[2 * np + 1][0] = r4[2];
            bf[2 * np + 1][1] = r4[3];
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            if (active[mi]) {
              uint32_t af[4];
              ldmatrix_x4(af, src + abase[mi] + aoff);
#pragma unroll
              for (int nt = 0; nt < 8; ++nt) mma_s8(acc[mi][nt], af, bf[nt]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = row[mi][hf];
        if (r < 0) continue;
        const int img_row = img_row0 + r;
        const bool inside = img_row >= 0 && img_row < h;
        // the window's top-left is src pixel (r, x); the output is dst pixel
        // (r, x + 1)
        const int centre = base[mi][hf] + kPix;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int ch = nt * 8 + 2 * t;
          char2 q = make_char2(0, 0);
          if (inside) {
            const float2 ms = *reinterpret_cast<const float2*>(msc + ch);
            const float2 bs = *reinterpret_cast<const float2*>(bias + ch);
            float y0 = dequant(acc[mi][nt][2 * hf], ms.x, bs.x);
            float y1 = dequant(acc[mi][nt][2 * hf + 1], ms.y, bs.y);
            if (res != nullptr) {
              const char2 rr = *reinterpret_cast<const char2*>(
                  res + 2 * rowb + centre + ch);
              y0 = __fadd_rn(y0, __fmul_rn(__int2float_rn(rr.x), res_scale));
              y1 = __fadd_rn(y1, __fmul_rn(__int2float_rn(rr.y), res_scale));
            }
            q.x = static_cast<signed char>(requant(fmaxf(y0, 0.0f), s_out, inv_s));
            q.y = static_cast<signed char>(requant(fmaxf(y1, 0.0f), s_out, inv_s));
          }
          *reinterpret_cast<char2*>(dst + centre + ch) = q;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_stage1_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                    const float* __restrict__ msc, const float* __restrict__ bias,
                    const float* __restrict__ scal, int8_t* __restrict__ out,
                    int h, int w, int band_rows, int bands) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rowb = (w + 2) * kPix;
  int8_t* buf0 = reinterpret_cast<int8_t*>(smem_raw);  // band_rows + 8 rows
  int8_t* buf1 = buf0 + (band_rows + 8) * rowb;        // band_rows + 6 rows
  int8_t* buf2 = buf1 + (band_rows + 6) * rowb;        // band_rows + 4 rows
  int8_t* wsm = buf2 + (band_rows + 4) * rowb;         // one conv's weights
  const int tid = threadIdx.x;
  const long long img = blockIdx.x / bands;
  const int r0 = (blockIdx.x % bands) * band_rows;
  const int8_t* xin = x + img * h * w * kC;
  int8_t* xout = out + img * h * w * kC;

  // zero everything once: the pad columns of every band stay zero, and the
  // input band's rows outside the image are the convolution's zero padding
  const int total16 = (3 * band_rows + 18) * rowb / 16;
  for (int e = tid; e < total16; e += blockDim.x) {
    reinterpret_cast<uint4*>(smem_raw)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  copy_weights_async(wt, wsm);
  const int in_rows = band_rows + 8;
  for (int e = tid; e < in_rows * w * 4; e += blockDim.x) {
    const int j = e / (w * 4), rem = e % (w * 4);
    const int px = rem >> 2, q = rem & 3;
    const int iy = r0 - 4 + j;
    if (iy >= 0 && iy < h) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          xin + (static_cast<long long>(iy) * w + px) * kC + q * 16));
      *reinterpret_cast<uint4*>(buf0 + j * rowb + (px + 1) * kPix + q * 16) = v;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const float s_x = scal[0], s_y1_b0 = scal[1], s_o_b0 = scal[2];
  const float s_y1_b1 = scal[3], s_o_b1 = scal[4];
  // after each convolution every warp is past its reads of the weights and
  // of the source band: the next convolution's weights take their place
  auto next_weights = [&](int conv) {
    __syncthreads();
    copy_weights_async(wt + conv * kC * kK, wsm);
    cp_async_wait_all();
    __syncthreads();
  };
  // block 0: y1 = requant(conv1(x)); x1 = requant(conv2(y1) + x * s_x)
  conv_band(buf0, buf1, nullptr, band_rows + 6, r0 - 3, h, w, rowb, wsm, msc,
            bias, 0.0f, s_y1_b0);
  next_weights(1);
  conv_band(buf1, buf2, buf0, band_rows + 4, r0 - 2, h, w, rowb, wsm, msc + kC,
            bias + kC, s_x, s_o_b0);
  next_weights(2);
  // block 1: the input band's space takes y1, the first y1's the result
  conv_band(buf2, buf0, nullptr, band_rows + 2, r0 - 1, h, w, rowb, wsm,
            msc + 2 * kC, bias + 2 * kC, 0.0f, s_y1_b1);
  next_weights(3);
  conv_band(buf0, buf1, buf2, band_rows, r0, h, w, rowb, wsm, msc + 3 * kC,
            bias + 3 * kC, s_o_b0, s_o_b1);
  __syncthreads();

  for (int e = tid; e < band_rows * w * 4; e += blockDim.x) {
    const int j = e / (w * 4), rem = e % (w * 4);
    const int px = rem >> 2, q = rem & 3;
    const int oy = r0 + j;
    if (oy < h) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(buf1 + j * rowb + (px + 1) * kPix + q * 16);
      *reinterpret_cast<uint4*>(xout + (static_cast<long long>(oy) * w + px) * kC +
                                q * 16) = v;
    }
  }
}

// Bytes of shared memory a block needs for a band of `band_rows` output rows
// of a plane `w` wide: bands of band_rows + 8, + 6 and + 4 rows, and one
// convolution's weights.
inline long long band_smem(int w, int band_rows) {
  return static_cast<long long>(3 * band_rows + 18) * (w + 2) * kPix + kWBytes;
}

}  // namespace

// x: (b, h, w, 64) int8 contiguous. wt: (4, 64, 576) int8, per convolution
// [o][ky][kx][ci]. msc, bias: (4, 64) float32. scal: (5,) float32 on the
// device, [s_x, s_y1_b0, s_o_b0, s_y1_b1, s_o_b1]. out: (b, h, w, 64) int8.
// band_rows output rows per block; the bands must fit shared memory. Returns
// a cudaError_t as int (0 = launched).
extern "C" int hipac_fused_stage1_int8(const void* x, const void* wt,
                                       const void* msc, const void* bias,
                                       const void* scal, void* out, long long b,
                                       int h, int w, int band_rows,
                                       void* stream) {
  if (b <= 0 || h < 1 || w < 1 || band_rows < 1) {
    return cudaErrorInvalidValue;
  }
  const long long smem = band_smem(w, band_rows);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wt) % 16 ||
      reinterpret_cast<uintptr_t>(msc) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return cudaErrorInvalidValue;
  }
  const int bands = (h + band_rows - 1) / band_rows;
  const long long blocks = b * bands;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_stage1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_stage1_kernel<<<static_cast<unsigned int>(blocks), kThreads,
                        static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
      static_cast<const float*>(msc), static_cast<const float*>(bias),
      static_cast<const float*>(scal), static_cast<int8_t*>(out), h, w,
      band_rows, bands);
  return static_cast<int>(cudaGetLastError());
}
