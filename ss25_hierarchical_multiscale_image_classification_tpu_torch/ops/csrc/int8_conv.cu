// int8 convolution with int32 accumulation and the requantization epilogue:
// every convolution of the int8 (w8a8) ResNet18 forward, for sm_90a.
//
// Stands for `_convq` + `_requant` of the JAX package's models/quantized.py
// (`lax.conv_general_dilated` on int8 operands with an int32 result, whose
// epilogue XLA fuses); PyTorch has no int8 convolution on CUDA, so this is
// the port's own kernel, and the generalisation of the fused stage-1 kernel
// (ops/pallas/int8_block.py, here int8_block.cu) to any stride, kernel size
// and width.
//
//   acc  = conv(x int8 NHWC, w int8)                       exact, int32
//   y    = float(acc) * mscale[c] + bias[c or (oy, ox, c)] (+ residual)
//   out  = relu?(y) as float32, or clip(rint(relu?(y) / s_out), +-127) as int8
//
// What bounds it: operations. A 3x3 convolution at 64..512 channels does
// 1,152..9,216 int8 operations per output byte, far above the card's ~590
// operations per byte of device memory (1,979 TOP/s dense int8 over 3.35
// TB/s); only the stem (K = 192 with 3/4 real) and the 1x1 downsamples come
// near the memory side.
//
// Design (a simple implicit GEMM on `mma.sync.m16n8k32`, no `wgmma`): a block
// of four warps owns a tile of up to 128 output pixels (a band of output rows
// of one image, or a few whole small images) by 64 output channels. It walks
// the input channels in chunks of 64. Per chunk it copies to shared memory,
// with 16-byte `cp.async` copies, the input patch (the band's rows,
// zero-padded as the convolution pads; pixel pitch 80 bytes) and the
// chunk's weights of its 64 channels (laid out [o][ky][kx][ci] in device
// memory; row pitch 16 bytes more than the row). Both pitches are odd
// multiples of 16 bytes, so the eight rows of a fragment fall into different
// banks. For a fixed kernel row the taps of an output pixel are a contiguous
// window of the patch, so there is no im2col buffer: one `ldmatrix.x4` reads
// the A fragments of 16 pixels x 32 channels, one the B fragments of 16
// output channels. Each warp accumulates 32 pixels x 64 channels in 64
// registers. The stems (12 input channels after space-to-depth, or 3 padded
// to 4) take the same path with the whole kernel row as one window,
// zero-padded in the weights to a multiple of 32; their pixels are not
// 16-byte aligned, so their patch is copied and their A fragments are read
// in 32-bit words. A convolution of a single chunk (the stems, 64 input
// channels) keeps its weights in shared memory over up to eight consecutive
// tiles of a block.
//
// The first version read its B fragments straight from device memory through
// L1 (eight cache lines per load instruction) and filled the patch in 32-bit
// words with four integer divisions each: 1.5-2x slower; a version on
// `__dp4a` (CUDA cores) was 2-3x slower than this one (both in PERF.md).
//
// Built by ops/build.py (nvcc, plain C entry point, no PyTorch headers).

#include <cuda_runtime.h>

#include <cstdint>

#include "int8_mma.cuh"

namespace {

using hipac_int8::cp_async_16;
using hipac_int8::cp_async_wait_all;
using hipac_int8::dequant;
using hipac_int8::ld_global_u32;
using hipac_int8::ld_shared_u32;
using hipac_int8::ldmatrix_x4;
using hipac_int8::mma_s8;
using hipac_int8::requant;

constexpr int kThreads = 128;  // four warps, 32 pixels each
constexpr int kTileM = 128;    // output pixels per block, at most
constexpr int kTileN = 64;     // output channels per block
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

struct ConvArgs {
  const int8_t* x;
  const int8_t* w;
  const float* mscale;
  const float* bias;
  const float* s_out;
  const void* residual;
  const float* res_scale;
  void* out;
  long long bias_px;  // floats between two pixels of the bias (0: a vector)
  int res_kind;       // 0 none, 1 float32, 2 int8 times *res_scale
  int out_f32, relu;
  int b, h, w_in, cin, ho, wo, cout;
  int kh, kwe, ks;  // kernel rows; windows per row; 32-byte steps per window
  int cc, pix;      // channels per chunk; bytes between two patch pixels
  int krow, ktot;   // weight bytes per kernel row and per output channel
  int wkx;          // weight bytes between two windows of a row
  int stride, pad_top, pad_left;
  int rows, ipb, bands;  // output rows and images per tile; bands per image
  int seg, rowb;         // patch rows per image; bytes per patch row
  int wpitch;            // bytes per output channel of the weights in shared
  int patch_bytes;       // the patch's share of the shared memory
  int tiles, tpb;        // tiles in all; consecutive tiles per block
};

// One tile: up to 128 output pixels (tile = image group * bands + band) by the
// 64 output channels from n0. `fresh_weights`: the weights in shared memory
// are not this convolution's first chunk yet.
template <bool kStem>
__device__ __forceinline__ void conv_tile(const ConvArgs& p, int tile, int n0,
                                          bool fresh_weights, int8_t* patch,
                                          int8_t* wsm) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int grp = tile / p.bands, band = tile % p.bands;
  const int img0 = grp * p.ipb, r0 = band * p.rows;
  const int px_per_img = p.rows * p.wo;
  const int tile_px = p.ipb * px_per_img;

  // byte offset in the patch of the window of tile pixel m (its first tap)
  auto pixel_base = [&](int m) {
    const int mm = m < tile_px ? m : 0;
    const int s = mm / px_per_img, rem = mm % px_per_img;
    const int oyl = rem / p.wo, ox = rem % p.wo;
    return (s * p.seg + oyl * p.stride) * p.rowb + ox * p.stride * p.pix;
  };

  // this thread's output pixels: m-tile mi, rows g (hf = 0) and g + 8 (hf = 1)
  long long opix[2][2];
  bool active[2];
  // the A rows this lane addresses: for ldmatrix, row (lane & 7) + 8 * bit 3
  // of the lane at k offset 16 * bit 4; for 32-bit loads, rows g and g + 8
  int abase[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    active[mi] = warp * 32 + mi * 16 < tile_px;  // the same for the warp
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = warp * 32 + mi * 16 + g + 8 * hf;
      bool ok = m < tile_px;
      const int mm = ok ? m : 0;
      const int s = mm / px_per_img, rem = mm % px_per_img;
      const int oyl = rem / p.wo, ox = rem % p.wo;
      const int oy = r0 + oyl, img = img0 + s;
      ok = ok && img < p.b && oy < p.ho;
      opix[mi][hf] =
          ok ? (static_cast<long long>(img) * p.ho + oy) * p.wo + ox : -1;
      abase[mi][hf] = pixel_base(m);
    }
    if constexpr (!kStem) {
      abase[mi][0] = pixel_base(warp * 32 + mi * 16 + (lane & 7) +
                                8 * ((lane >> 3) & 1)) +
                     16 * (lane >> 4);
    }
  }
  // the B rows this lane addresses for ldmatrix: channel (lane & 7) + 8 * bit
  // 4 of the lane (of a pair of 8-channel tiles) at k offset 16 * bit 3
  const int bbase = ((lane & 7) + 8 * (lane >> 4)) * p.wpitch +
                    16 * ((lane >> 3) & 1);

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][nt][j] = 0;
    }
  }

  const int nrows = p.ipb * p.seg;
  const int iy_first = r0 * p.stride - p.pad_top;
  const int slab = p.ks * 32;          // weight bytes of one window
  const int slab16 = p.ks * 2;         // its 16-byte pieces
  const int row16 = p.kh * p.kwe * slab16;  // pieces per output channel

  for (int c0 = 0; c0 < p.cin; c0 += p.cc) {
    __syncthreads();  // every warp is past its reads of the last chunk
    // the chunk's weights of this block's 64 output channels; a convolution
    // of one chunk keeps them from tile to tile
    if (fresh_weights || p.cin > p.cc) {
      for (int e = tid; e < kTileN * row16; e += kThreads) {
        const int n = e / row16, piece = e % row16;
        const int sl = piece / slab16, q = piece % slab16;
        const int ky = sl / p.kwe, kx = sl % p.kwe;
        cp_async_16(wsm + n * p.wpitch + sl * slab + q * 16,
                    p.w + static_cast<long long>(n0 + n) * p.ktot + ky * p.krow +
                        kx * p.wkx + c0 + q * 16);
      }
    }
    // the chunk's input patch; outside the plane or the batch it is zero
    if (kStem) {
      // a patch row is the input row's bytes behind pad_left zero pixels
      const int rw = p.rowb / 4;  // words per patch row
      const int lead = p.pad_left * p.pix / 4, row_words = p.w_in * p.pix / 4;
      for (int row = warp; row < nrows; row += kThreads / 32) {
        const int s = row / p.seg, j = row % p.seg;
        const int img = img0 + s, iy = iy_first + j;
        const bool row_ok = img < p.b && iy >= 0 && iy < p.h;
        const int8_t* src =
            p.x + (static_cast<long long>(img) * p.h + iy) * p.w_in * p.cin;
        uint32_t* dst = reinterpret_cast<uint32_t*>(patch + row * p.rowb);
        for (int wd = lane; wd < rw; wd += 32) {
          const int at = wd - lead;
          dst[wd] = row_ok && at >= 0 && at < row_words
                        ? ld_global_u32(src + at * 4)
                        : 0u;
        }
      }
    } else {
      const int wp16 = (p.rowb / p.pix) * 4;  // 16-byte pieces of whole pixels
      for (int row = warp; row < nrows; row += kThreads / 32) {
        const int s = row / p.seg, j = row % p.seg;
        const int img = img0 + s, iy = iy_first + j;
        const bool row_ok = img < p.b && iy >= 0 && iy < p.h;
        const int8_t* src =
            p.x + (static_cast<long long>(img) * p.h + iy) * p.w_in * p.cin + c0;
        int8_t* dst = patch + row * p.rowb;
        for (int i = lane; i < wp16; i += 32) {
          const int pp = i >> 2, q = i & 3;
          const int ix = pp - p.pad_left;
          int8_t* d = dst + pp * p.pix + q * 16;
          if (row_ok && ix >= 0 && ix < p.w_in) {
            cp_async_16(d, src + static_cast<long long>(ix) * p.cin + q * 16);
          } else {
            *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();

    for (int ky = 0; ky < p.kh; ++ky) {
      for (int kx = 0; kx < p.kwe; ++kx) {
#pragma unroll 2
        for (int kk = 0; kk < p.ks; ++kk) {
          const int aoff = ky * p.rowb + kx * p.pix + kk * 32;
          const int8_t* wk = wsm + (ky * p.kwe + kx) * slab + kk * 32;
          uint32_t bf[8][2];
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t r[4];
            ldmatrix_x4(r, wk + bbase + np * 16 * p.wpitch);
            bf[2 * np][0] = r[0];
            bf[2 * np][1] = r[1];
            bf[2 * np + 1][0] = r[2];
            bf[2 * np + 1][1] = r[3];
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            if (active[mi]) {
              uint32_t af[4];
              if constexpr (kStem) {
                const int8_t* a0 = patch + abase[mi][0] + aoff + t * 4;
                const int8_t* a1 = patch + abase[mi][1] + aoff + t * 4;
                af[0] = ld_shared_u32(a0);
                af[1] = ld_shared_u32(a1);
                af[2] = ld_shared_u32(a0 + 16);
                af[3] = ld_shared_u32(a1 + 16);
              } else {
                ldmatrix_x4(af, patch + abase[mi][0] + aoff);
              }
#pragma unroll
              for (int nt = 0; nt < 8; ++nt) mma_s8(acc[mi][nt], af, bf[nt]);
            }
          }
        }
      }
    }
  }

  const float s_out = p.out_f32 ? 1.0f : *p.s_out;
  const float inv_s = __frcp_rn(s_out);
  const float rs = p.res_kind == 2 ? *p.res_scale : 0.0f;
  const long long plane = static_cast<long long>(p.ho) * p.wo;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long o = opix[mi][hf];
      if (o < 0) continue;
      const float* bias_px = p.bias + (o % plane) * p.bias_px;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int ch = n0 + nt * 8 + 2 * t;
        const float2 ms = *reinterpret_cast<const float2*>(p.mscale + ch);
        const float2 bs = *reinterpret_cast<const float2*>(bias_px + ch);
        float y0 = dequant(acc[mi][nt][2 * hf], ms.x, bs.x);
        float y1 = dequant(acc[mi][nt][2 * hf + 1], ms.y, bs.y);
        const long long at = o * p.cout + ch;
        if (p.res_kind == 1) {
          const float2 r = *reinterpret_cast<const float2*>(
              static_cast<const float*>(p.residual) + at);
          y0 = __fadd_rn(y0, r.x);
          y1 = __fadd_rn(y1, r.y);
        } else if (p.res_kind == 2) {
          const char2 r = *reinterpret_cast<const char2*>(
              static_cast<const int8_t*>(p.residual) + at);
          y0 = __fadd_rn(y0, __fmul_rn(__int2float_rn(r.x), rs));
          y1 = __fadd_rn(y1, __fmul_rn(__int2float_rn(r.y), rs));
        }
        if (p.relu) {
          y0 = fmaxf(y0, 0.0f);
          y1 = fmaxf(y1, 0.0f);
        }
        if (p.out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) =
              make_float2(y0, y1);
        } else {
          char2 q;
          q.x = static_cast<signed char>(requant(y0, s_out, inv_s));
          q.y = static_cast<signed char>(requant(y1, s_out, inv_s));
          *reinterpret_cast<char2*>(static_cast<int8_t*>(p.out) + at) = q;
        }
      }
    }
  }
}

template <bool kStem>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const ConvArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* patch = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* wsm = patch + p.patch_bytes;
  const int n0 = blockIdx.y * kTileN;
  for (int tt = 0; tt < p.tpb; ++tt) {
    const int tile = blockIdx.x * p.tpb + tt;
    if (tile >= p.tiles) break;  // the same for the whole block
    conv_tile<kStem>(p, tile, n0, tt == 0, patch, wsm);
  }
}

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

}  // namespace

// x: (b, h, w, cin) int8 contiguous, cin a multiple of 64 or one of 4, 8, 12,
// 16 (a stem; 3 channels are padded to 4 by the caller). wt: the weights as
// [cout][kh][krow] int8 with krow = kw * cin for cin a multiple of 64 (that is
// [o][ky][kx][ci]) and kw * cin rounded up to a multiple of 32, zero-filled,
// for a stem. mscale: (cout,) float32. bias: (cout,) float32, or with
// bias_map = 1 (ho, wo, cout). s_out: one float32 on the device (unused with
// out_f32 = 1). residual: null (res_kind 0), (b, ho, wo, cout) float32
// (res_kind 1), or int8 (res_kind 2) multiplied by the float32 *res_scale.
// out: (b, ho, wo, cout) int8, or float32 with out_f32 = 1. cout a multiple of
// 64, wo at most 128. Returns a cudaError_t as int (0 = launched).
extern "C" int hipac_int8_conv_requant(
    const void* x, const void* wt, const void* mscale, const void* bias,
    int bias_map, const void* s_out, const void* residual, int res_kind,
    const void* res_scale, void* out, int out_f32, int relu, long long b, int h,
    int w, int cin, int cout, int kh, int kw, int stride, int pad_top,
    int pad_left, int ho, int wo, void* stream) {
  const bool stem = cin < 64;
  if (b <= 0 || b > 0x7fffffffLL || h < 1 || w < 1 || ho < 1 || wo < 1 ||
      wo > kTileM || kh < 1 || kw < 1 || stride < 1 || pad_top < 0 ||
      pad_left < 0 || cout < kTileN || cout % kTileN || res_kind < 0 ||
      res_kind > 2) {
    return cudaErrorInvalidValue;
  }
  if (stem ? (cin % 4 != 0 || cin < 4 || cin > 16) : cin % 64 != 0) {
    return cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(wt) % 16 ||
      reinterpret_cast<uintptr_t>(mscale) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(residual) % 16 ||
      (!out_f32 && s_out == nullptr) || (res_kind == 2 && res_scale == nullptr) ||
      (res_kind != 0 && residual == nullptr)) {
    return cudaErrorInvalidValue;
  }
  ConvArgs p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(wt);
  p.mscale = static_cast<const float*>(mscale);
  p.bias = static_cast<const float*>(bias);
  p.s_out = static_cast<const float*>(s_out);
  p.residual = residual;
  p.res_scale = static_cast<const float*>(res_scale);
  p.out = out;
  p.bias_px = bias_map ? cout : 0;
  p.res_kind = res_kind;
  p.out_f32 = out_f32;
  p.relu = relu;
  p.b = static_cast<int>(b);
  p.h = h;
  p.w_in = w;
  p.cin = cin;
  p.ho = ho;
  p.wo = wo;
  p.cout = cout;
  p.kh = kh;
  if (stem) {  // the whole kernel row is one window of the patch row
    p.krow = round_up(kw * cin, 32);
    p.kwe = 1;
    p.ks = p.krow / 32;
    p.cc = cin;
    p.pix = cin;
    p.wkx = 0;
  } else {
    p.krow = kw * cin;
    p.kwe = kw;
    p.ks = 2;
    p.cc = 64;
    p.pix = 80;
    p.wkx = cin;
  }
  p.ktot = kh * p.krow;
  p.stride = stride;
  p.pad_top = pad_top;
  p.pad_left = pad_left;
  if (ho * wo >= kTileM) {
    p.ipb = 1;
    p.rows = kTileM / wo;
    if (p.rows < 1) p.rows = 1;
    if (p.rows > ho) p.rows = ho;
  } else {
    p.rows = ho;
    p.ipb = kTileM / (ho * wo);
  }
  p.bands = (ho + p.rows - 1) / p.rows;
  p.seg = (p.rows - 1) * stride + kh;
  const int wp = (wo - 1) * stride + kw;
  p.rowb = round_up(wp * p.pix + 32, 16);
  const long long groups = (b + p.ipb - 1) / p.ipb;
  const long long tiles = groups * p.bands;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.tiles = static_cast<int>(tiles);
  // a convolution of one chunk loads its weights once per block: give a
  // block up to eight tiles while the grid still fills the card many times
  p.tpb = 1;
  if (cin <= p.cc) {
    const long long fill = tiles * (cout / kTileN) / (132 * 8);
    p.tpb = static_cast<int>(fill < 1 ? 1 : (fill > 8 ? 8 : fill));
  }
  const long long blocks = (tiles + p.tpb - 1) / p.tpb;
  p.wpitch = kh * p.kwe * p.ks * 32 + 16;
  p.patch_bytes = p.ipb * p.seg * p.rowb;
  const size_t smem = static_cast<size_t>(p.patch_bytes) + kTileN * p.wpitch;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = stem ? int8_conv_kernel<true> : int8_conv_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>(cout / kTileN));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
