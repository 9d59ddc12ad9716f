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
// near the memory side. In practice, on this card, the float32 epilogue
// (some 13 instructions a value for 64 values a thread) and the issue of the
// patch copies weigh as much as the products.
//
// Design, one implementation per shape class, chosen by the input channels:
//
// * C_in a multiple of 64 (every stage convolution and downsample): an
//   implicit GEMM on `wgmma` (int8_wgmma.cuh). A block of two warpgroups owns
//   a tile of up to 128 output pixels (a band of output rows of one image, or
//   a few whole small images) by 128 output channels (64 where C_out is not a
//   multiple of 128), so the input patch is fetched once per 128 channels.
//   Two rings in shared memory feed it, each stage with an `mbarrier`: the
//   weights in chunks of 32 input channels (two to four stages; the host
//   packed each chunk as the image the tensor cores read, so one bulk copy
//   lands it), the input patch in chunks of 64 (two stages; 16-byte
//   `cp.async` that report to the stage's barrier, padding as copies of zero
//   bytes; four lanes a pixel, which halves the cache lines an instruction
//   touches against 32-channel stages). While the warpgroups multiply chunk
//   c, the copies of the next chunks are in flight. The patch is pixel-major
//   at a pitch of 80 bytes (an odd multiple of 16: the eight rows of an A
//   fragment fall into different banks); with a stride the columns are split
//   by their residue so that neighbouring output pixels stay neighbours.
//   Every index that needs an integer division (pixel to patch offset and
//   output offset, patch row to input row, column slot to input column) is
//   tabulated once per tile in shared memory. The int8 result is staged in
//   shared memory (the rings are free by then) and written as whole 16-byte
//   pieces. Two blocks share an SM.
// * a stem (12 input channels after space-to-depth, or 3 padded to 4; one
//   chunk of K = 192/256): fill- and epilogue-bound, it keeps the first
//   design's `mma.sync.m16n8k32` mainloop (the whole kernel row as one window
//   of the patch row, A fragments read in 32-bit words because its pixels are
//   not 16-byte aligned, the weights kept in shared memory over up to eight
//   tiles of a block), now on eight warps of 16 pixels, with the tile's rows
//   of the bias map copied to shared memory during the products, and the
//   staged 16-byte stores.
// * both: the block's scales and biases sit in shared memory, and the
//   requantization takes one branch per eight values (int8_mma.cuh).
//
// The first design ran every shape on `mma.sync` from one shared-memory
// buffer (fill, wait, multiply, wait; 128 pixels x 64 channels a block;
// 2-byte stores): the 16 convolutions of a B = 512 forward took 9.2-10.2 ms,
// 0.49-0.70 ms for a 3x3 stage convolution (170-240 TOP/s), 2.20-2.31 ms for
// the stem, on an NVIDIA H100 80GB HBM3 at 700 W; before that, B fragments
// from device memory were 1.5-2x slower and `__dp4a` 2-3x slower again. This
// design's first version (`wgmma`, one ring, a division per copy and pixel,
// scales and biases from device memory, a branch per value) took 7.6 ms for
// the 16 (all in PERF.md).
//
// Built by ops/build.py (nvcc, plain C entry point, no PyTorch headers).

#include <cuda_runtime.h>

#include <cstdint>

#include "int8_wgmma.cuh"

namespace {

using namespace hipac_int8;

constexpr int kTileM = 128;       // output pixels per block, at most
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90
constexpr int kMaxStages = 4;
constexpr int kMaxTaps = 64;
constexpr int kChunk = 32;        // input channels per stage of the weights
constexpr int kPatchChunk = 64;   // input channels per stage of the patch
constexpr int kPix = 80;          // bytes between two patch pixels of a stage
constexpr int kWgThreads = 256;   // two warpgroups
constexpr int kStemThreads = 256;  // eight warps, 16 pixels each
// floats between two pixels of a staged bias map: 64 and 8 more, so that the
// 8-byte reads of a half-warp (four pixels by four channel pairs) fall into
// different banks
constexpr int kBiasPitch = 72;

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
  int kh, kw;
  int stride, pad_top, pad_left;
  int rows, ipb, bands;  // output rows and images per tile; bands per image
  int seg, rowb;         // patch rows per image; bytes per patch row
  int patch_bytes;       // the patch's share of the shared memory
  int tiles;
  // the stem: 32-byte steps per kernel row; weight bytes per kernel row and
  // per output channel in device and in shared memory; tiles per block
  int ks, krow, ktot, wpitch, tpb;
  // the rings: column slots per residue class and in all; bytes per stage
  // of the weights; their stages; where the patch's two stages start;
  // blocks of output channels
  int per, nslots, wbytes, nstage, patch_off, nblk;
  int tab_off;  // where the per-tile tables start in the shared memory
  int bias_off;  // where the stem stages its tile's rows of a bias map, or 0
};

struct Tile {
  int img0, r0, px_per_img, tile_px;
};

__device__ __forceinline__ Tile tile_of(const ConvArgs& p, int tile) {
  Tile t;
  t.img0 = (tile / p.bands) * p.ipb;
  t.r0 = (tile % p.bands) * p.rows;
  t.px_per_img = p.rows * p.wo;
  t.tile_px = p.ipb * t.px_per_img;
  return t;
}

// Per tile, computed once by the block's first 128 threads (an integer
// division by a runtime number has a latency of some 200 cycles; the first
// version divided per pixel, per patch row and per copy, which cost 6 % of
// the 16 convolutions' time): for tile pixel m
//   opix[m]   its index in the batch's output planes, or -1 outside the tile,
//             the batch or the plane
//   oplane[m] its index in one output plane (for a bias map)
//   abase[m]  the byte offset in the patch of its window (its first tap)
struct TileTables {
  long long* opix;
  int* oplane;
  int* abase;
};

// `pix`: bytes between two patch pixels; `col_step`: patch pixels between the
// windows of two neighbouring output pixels. Followed by a block-wide barrier.
__device__ __forceinline__ void fill_tile_tables(const ConvArgs& p,
                                                 const Tile& t,
                                                 const TileTables& tab, int pix,
                                                 int col_step) {
  const int m = threadIdx.x;
  if (m >= kTileM) return;
  const bool in_tile = m < t.tile_px;
  const int mm = in_tile ? m : 0;
  const int s = mm / t.px_per_img, rem = mm % t.px_per_img;
  const int oyl = rem / p.wo, ox = rem % p.wo;
  const int oy = t.r0 + oyl, img = t.img0 + s;
  tab.abase[m] = (s * p.seg + oyl * p.stride) * p.rowb + ox * col_step * pix;
  tab.oplane[m] = oy * p.wo + ox;
  tab.opix[m] = in_tile && img < p.b && oy < p.ho
                    ? (static_cast<long long>(img) * p.ho + oy) * p.wo + ox
                    : -1;
}

// The epilogue of one warp's 16 tile pixels from m0 (rows g and g + 8) by
// kNT * 8 channels from n0, whose sums `c` holds in the `mma` layout: float32
// results go to device memory, int8 results to the staging tile `stg`
// (pixel-major, kNT * 8 + 16 bytes a pixel). `ms_sm`: the block's kNT * 8
// dequantization scales in shared memory. `bias_sm`: its biases there,
// `bias_pitch` floats a tile pixel (0: one vector; kBiasPitch: the staged
// rows of a bias map), or null for a bias map read from device memory. (Read
// per value from device memory, scales and biases came from L2 each time and
// took most of the epilogue.)
template <int kNT>
__device__ __forceinline__ void requant_rows(const ConvArgs& p,
                                             const TileTables& tab,
                                             const int (&c)[kNT * 4], int m0,
                                             int n0, int8_t* stg,
                                             const float* ms_sm,
                                             const float* bias_sm,
                                             int bias_pitch) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float s_out = p.out_f32 ? 1.0f : *p.s_out;
  const float inv_s = __frcp_rn(s_out);
  const float rs = p.res_kind == 2 ? *p.res_scale : 0.0f;
  const float lo = p.relu ? 0.0f : -127.0f;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int m = m0 + g + 8 * hf;
    const long long o = tab.opix[m];
    if (o < 0) continue;
    const float* bias_px = bias_sm != nullptr
                               ? bias_sm + m * bias_pitch
                               : p.bias + tab.oplane[m] * p.bias_px + n0;
    int8_t* stg_px = stg + m * (kNT * 8 + 16);
#pragma unroll
    for (int ng = 0; ng < kNT; ng += 4) {  // four 8-channel tiles at a time
      float y[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nt = ng + j;
        const int cl = nt * 8 + 2 * t, ch = n0 + cl;
        const float2 ms = *reinterpret_cast<const float2*>(ms_sm + cl);
        const float2 bs =
            bias_sm != nullptr
                ? *reinterpret_cast<const float2*>(bias_px + cl)
                : __ldg(reinterpret_cast<const float2*>(bias_px + cl));
        float y0 = dequant(c[nt * 4 + 2 * hf], ms.x, bs.x);
        float y1 = dequant(c[nt * 4 + 2 * hf + 1], ms.y, bs.y);
        const long long at = o * p.cout + ch;
        if (p.res_kind == 1) {
          const float2 r = __ldg(reinterpret_cast<const float2*>(
              static_cast<const float*>(p.residual) + at));
          y0 = __fadd_rn(y0, r.x);
          y1 = __fadd_rn(y1, r.y);
        } else if (p.res_kind == 2) {
          const unsigned int r =
              __ldg(reinterpret_cast<const unsigned short*>(
                  static_cast<const int8_t*>(p.residual) + at)) ^ 0x8080u;
          y0 = __fadd_rn(y0, __fmul_rn(biased_byte_to_float(r & 0xFFu), rs));
          y1 = __fadd_rn(y1, __fmul_rn(biased_byte_to_float(r >> 8), rs));
        }
        if (p.out_f32) {
          if (p.relu) {
            y0 = fmaxf(y0, 0.0f);
            y1 = fmaxf(y1, 0.0f);
          }
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) =
              make_float2(y0, y1);
        }
        y[2 * j] = y0;
        y[2 * j + 1] = y1;
      }
      if (!p.out_f32) {
        int q[8];
        requant_group(y, s_out, inv_s, lo, q);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          *reinterpret_cast<char2*>(stg_px + (ng + j) * 8 + 2 * t) =
              make_char2(static_cast<signed char>(q[2 * j]),
                         static_cast<signed char>(q[2 * j + 1]));
        }
      }
    }
  }
}

// The staged int8 tile to device memory, 16 bytes a store. Between block-wide
// barriers: after every requant_rows, before the staging space is reused.
template <int kNT>
__device__ __forceinline__ void store_staged(const ConvArgs& p, const Tile& tl,
                                             const TileTables& tab, int n0,
                                             const int8_t* stg) {
  constexpr int kPieces = kNT * 8 / 16;
  for (int e = threadIdx.x; e < tl.tile_px * kPieces; e += blockDim.x) {
    const int m = e / kPieces, piece = e % kPieces;
    const long long o = tab.opix[m];
    if (o < 0) continue;
    *reinterpret_cast<uint4*>(static_cast<int8_t*>(p.out) + o * p.cout + n0 +
                              piece * 16) =
        *reinterpret_cast<const uint4*>(stg + m * (kNT * 8 + 16) + piece * 16);
  }
}

// ---------------------------------------------------------------------------
// C_in a multiple of 64: wgmma from a ring of stages
// ---------------------------------------------------------------------------

// kTaps: kh * kw, or 0 for any (then the products do not overlap their loads)
template <int kN, int kTaps>
__global__ void __launch_bounds__(kWgThreads, 2)
int8_conv_wgmma_kernel(const ConvArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t wfull[kMaxStages], pfull[2];
  __shared__ int tap_off[kMaxTaps];
  __shared__ __align__(8) float ms_sm[kN], bs_sm[kN];
  int8_t* ring = reinterpret_cast<int8_t*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nb = blockIdx.x % p.nblk, n0 = nb * kN;
  const Tile tl = tile_of(p, blockIdx.x / p.nblk);
  const int taps = kTaps ? kTaps : p.kh * p.kw;
  const int nchunks = p.cin / kChunk;

  if (tid < kN) {
    ms_sm[tid] = p.mscale[n0 + tid];
    bs_sm[tid] = p.bias_px ? 0.0f : p.bias[n0 + tid];
  }
  if (tid < taps) {
    const int ky = tid / p.kw, kx = tid % p.kw;
    tap_off[tid] =
        ky * p.rowb + ((kx % p.stride) * p.per + kx / p.stride) * kPix;
  }
  // the tile's tables (fill_tile_tables), then per patch row its byte offset
  // in x (-1: zero padding, -2: a row no tap reads) and per column slot its
  // input column (-1: zero padding)
  const int nrows = p.ipb * p.seg;
  TileTables tab;
  tab.opix = reinterpret_cast<long long*>(smem_raw + p.tab_off);
  long long* row_off = tab.opix + kTileM;
  tab.oplane = reinterpret_cast<int*>(row_off + nrows);
  tab.abase = tab.oplane + kTileM;
  int* slot_ix = tab.abase + kTileM;
  fill_tile_tables(p, tl, tab, kPix, 1);
  for (int row = tid; row < nrows; row += kWgThreads) {
    const int s = row / p.seg, j = row % p.seg;
    const int img = tl.img0 + s, iy = tl.r0 * p.stride - p.pad_top + j;
    long long off = -1;
    if (j % p.stride >= p.kh) {
      off = -2;
    } else if (img < p.b && iy >= 0 && iy < p.h) {
      off = (static_cast<long long>(img) * p.h + iy) * p.w_in * p.cin;
    }
    row_off[row] = off;
  }
  for (int slot = tid; slot < p.nslots; slot += kWgThreads) {
    const int ix = (slot % p.per) * p.stride + slot / p.per - p.pad_left;
    slot_ix[slot] = ix >= 0 && ix < p.w_in ? ix : -1;
  }
  if (tid == 0) {
    // per phase: thread 0's announcement of the weights' bytes; every
    // thread's cp.async arrival for the patch
    for (int s = 0; s < p.nstage; ++s) mbar_init(&wfull[s], 1);
    mbar_init(&pfull[0], kWgThreads);
    mbar_init(&pfull[1], kWgThreads);
    mbar_init_fence();
  }
  __syncthreads();

  // the weights of 32-channel chunk c into their ring's stage: one bulk copy
  auto produce_weights = [&](int c, int stage) {
    if (tid == 0) {
      mbar_arrive_expect_tx(&wfull[stage], p.wbytes);
      bulk_copy_g2s(ring + stage * p.wbytes,
                    p.w + (static_cast<long long>(nb) * nchunks + c) * p.wbytes,
                    p.wbytes, &wfull[stage]);
    }
  };
  // the input patch of 64-channel chunk pc into patch stage `stage`; a warp
  // takes a patch row, four lanes a pixel's 64 bytes
  auto produce_patch = [&](int pc, int stage) {
    int8_t* patch = ring + p.patch_off + stage * p.patch_bytes;
    for (int row = warp; row < nrows; row += kWgThreads / 32) {
      const long long off = row_off[row];
      if (off == -2) continue;
      const int8_t* src = p.x + off + pc * kPatchChunk;
      int8_t* dst = patch + row * p.rowb;
      for (int i = lane; i < p.nslots * 4; i += 32) {
        const int slot = i >> 2, piece = i & 3;
        const int ix = slot_ix[slot];
        const bool ok = off >= 0 && ix >= 0;
        cp_async_16_zfill(
            dst + slot * kPix + piece * 16,
            ok ? src + static_cast<long long>(ix) * p.cin + piece * 16 : p.x,
            ok ? 16 : 0);
      }
    }
    cp_async_mbar_arrive(&pfull[stage]);
  };

  for (int c = 0; c < p.nstage - 1 && c < nchunks; ++c) produce_weights(c, c);
  produce_patch(0, 0);

  // this lane's ldmatrix row: pixel (lane & 7) + 8 * bit 3 of the lane of the
  // warp's 16, at k offset 16 * bit 4
  const int m0 = warp * 16;
  const int a_base =
      tab.abase[m0 + (lane & 7) + 8 * ((lane >> 3) & 1)] + 16 * (lane >> 4);
  const bool wg_active = (warp >> 2) * 64 < tl.tile_px;  // else nothing to add

  int acc[kN / 2];
  for (int c = 0; c < nchunks; ++c) {
    const int stage = c % p.nstage;
    const int pc = c >> 1, pstage = pc & 1;
    // the stages that the last iteration read last are free: refill them
    const int ahead = c + p.nstage - 1;
    if (ahead < nchunks) produce_weights(ahead, ahead % p.nstage);
    if ((c & 1) == 0) {
      if (2 * pc + 2 < nchunks) produce_patch(pc + 1, pstage ^ 1);
      mbar_wait(&pfull[pstage], (pc >> 1) & 1);
    }
    mbar_wait(&wfull[stage], (c / p.nstage) & 1);
    if (wg_active) {
      const int8_t* wsm = ring + stage * p.wbytes;
      const int8_t* patch = ring + p.patch_off + pstage * p.patch_bytes;
      wg_mma_steps<kN, kTaps>(acc, patch + a_base + (c & 1) * kChunk, tap_off,
                              taps, wgmma_desc(wsm), c == 0);
    }
    __syncthreads();  // every warp is past its reads of these stages
  }

  if (wg_active) {
    wg_mma_finish(acc);
    fence_async_proxy();
    requant_rows<kN / 8>(p, tab, acc, m0, n0, ring, ms_sm,
                         p.bias_px ? nullptr : bs_sm, 0);
  }
  if (!p.out_f32) {
    __syncthreads();
    store_staged<kN / 8>(p, tl, tab, n0, ring);
  }
}

// ---------------------------------------------------------------------------
// the stems: mma.sync, one chunk, the weights kept over a block's tiles
// ---------------------------------------------------------------------------

// One tile: up to 128 output pixels by the 64 output channels from n0.
// `fresh_weights`: the weights in shared memory are not this block's yet.
__device__ __forceinline__ void stem_tile(const ConvArgs& p, int tile, int n0,
                                          bool fresh_weights, int8_t* patch,
                                          int8_t* wsm, const TileTables& tab,
                                          const float* ms_sm,
                                          const float* bs_sm, float* map_sm) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Tile tl = tile_of(p, tile);

  // the B rows this lane addresses for ldmatrix: channel (lane & 7) + 8 * bit
  // 4 of the lane (of a pair of 8-channel tiles) at k offset 16 * bit 3
  const int bbase = ((lane & 7) + 8 * (lane >> 4)) * p.wpitch +
                    16 * ((lane >> 3) & 1);

  int acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0;

  __syncthreads();  // every warp is past the last tile's patch and staging
  fill_tile_tables(p, tl, tab, p.cin, p.stride);
  if (fresh_weights) {
    const int row16 = p.kh * p.ks * 2;  // 16-byte pieces per output channel
    for (int e = tid; e < 64 * row16; e += kStemThreads) {
      const int n = e / row16, piece = e % row16;
      cp_async_16(wsm + n * p.wpitch + piece * 16,
                  p.w + static_cast<long long>(n0 + n) * p.ktot + piece * 16);
    }
  }
  // the input patch; outside the plane or the batch it is zero. A patch row
  // is the input row's bytes behind pad_left zero pixels.
  const int nrows = p.ipb * p.seg;
  const int iy_first = tl.r0 * p.stride - p.pad_top;
  const int rw = p.rowb / 4;  // words per patch row
  const int lead = p.pad_left * p.cin / 4, row_words = p.w_in * p.cin / 4;
  for (int row = warp; row < nrows; row += kStemThreads / 32) {
    const int s = row / p.seg, j = row % p.seg;
    const int img = tl.img0 + s, iy = iy_first + j;
    const bool row_ok = img < p.b && iy >= 0 && iy < p.h;
    const int8_t* src =
        p.x + (static_cast<long long>(img) * p.h + iy) * p.w_in * p.cin;
    uint32_t* dst = reinterpret_cast<uint32_t*>(patch + row * p.rowb);
    for (int wd = lane; wd < rw; wd += 32) {
      const int at = wd - lead;
      dst[wd] = row_ok && at >= 0 && at < row_words ? ld_global_u32(src + at * 4)
                                                    : 0u;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // a bias map's rows of this tile are on their way during the products: a
  // pixel's 64 floats read from device memory in the epilogue, four times
  // the bytes of its result, took most of the stem's time
  if (map_sm != nullptr) {
    for (int e = tid; e < tl.tile_px * 16; e += kStemThreads) {
      const int m = e >> 4, piece = e & 15;
      cp_async_16(reinterpret_cast<int8_t*>(map_sm + m * kBiasPitch + piece * 4),
                  reinterpret_cast<const int8_t*>(
                      p.bias + tab.oplane[m] * p.bias_px + n0 + piece * 4));
    }
  }

  // this thread's A rows: pixels g and g + 8 of the warp's 16
  const int m0 = warp * 16;
  const bool active = m0 < tl.tile_px;  // the same for the warp
  const int abase0 = tab.abase[m0 + g], abase1 = tab.abase[m0 + g + 8];
  for (int ky = 0; ky < (active ? p.kh : 0); ++ky) {
#pragma unroll 2
    for (int kk = 0; kk < p.ks; ++kk) {
      const int aoff = ky * p.rowb + kk * 32;
      const int8_t* wk = wsm + ky * p.krow + kk * 32;
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
      const int8_t* a0 = patch + abase0 + aoff + t * 4;
      const int8_t* a1 = patch + abase1 + aoff + t * 4;
      uint32_t af[4];
      af[0] = ld_shared_u32(a0);
      af[1] = ld_shared_u32(a1);
      af[2] = ld_shared_u32(a0 + 16);
      af[3] = ld_shared_u32(a1 + 16);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mma_s8(acc, nt * 4, af, bf[nt]);
    }
  }

  cp_async_wait_all();
  __syncthreads();  // the patch is read: its space stages the int8 tile
  if (active) {
    requant_rows<8>(p, tab, acc, m0, n0, patch, ms_sm,
                    map_sm != nullptr ? map_sm : bs_sm,
                    map_sm != nullptr ? kBiasPitch : 0);
  }
  if (!p.out_f32) {
    __syncthreads();
    store_staged<8>(p, tl, tab, n0, patch);
  }
}

__global__ void __launch_bounds__(kStemThreads)
int8_conv_stem_kernel(const ConvArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* patch = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* wsm = patch + p.patch_bytes;
  TileTables tab;
  tab.opix = reinterpret_cast<long long*>(smem_raw + p.tab_off);
  tab.oplane = reinterpret_cast<int*>(tab.opix + kTileM);
  tab.abase = tab.oplane + kTileM;
  __shared__ __align__(8) float ms_sm[64], bs_sm[64];
  float* map_sm = p.bias_off ? reinterpret_cast<float*>(smem_raw + p.bias_off)
                             : nullptr;
  const int n0 = blockIdx.y * 64;
  if (threadIdx.x < 64) {  // ordered before its readers by the tiles' barriers
    ms_sm[threadIdx.x] = p.mscale[n0 + threadIdx.x];
    bs_sm[threadIdx.x] = p.bias_px ? 0.0f : p.bias[n0 + threadIdx.x];
  }
  for (int tt = 0; tt < p.tpb; ++tt) {
    const int tile = blockIdx.x * p.tpb + tt;
    if (tile >= p.tiles) break;  // the same for the whole block
    stem_tile(p, tile, n0, tt == 0, patch, wsm, tab, ms_sm, bs_sm, map_sm);
  }
}

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <typename Kernel>
int launch(Kernel kernel, const ConvArgs& p, dim3 grid, int threads,
           size_t smem, void* stream) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (b, h, w, cin) int8 contiguous, cin a multiple of 64 or one of 4, 8, 12,
// 16 (a stem; 3 channels are padded to 4 by the caller). wt: the weights as
// pack_int8_kernel of ops/int8_conv.py lays them out: for cin a multiple of
// 64 the shared-memory image [cout / N][cin / 32][kh * kw][N / 8][2][8][16]
// int8 (N = 128 where cout is a multiple of 128 and kh * kw <= 16, else 64:
// per block of N output channels, chunk of 32 input channels and tap, the
// core matrices of 8 channels by 16 bytes of input channels); for a stem [cout][kh][krow] with
// krow = kw * cin rounded up to a multiple of 32, zero-filled. mscale: (cout,)
// float32. bias: (cout,) float32, or with bias_map = 1 (ho, wo, cout). s_out:
// one float32 on the device (unused with out_f32 = 1). residual: null
// (res_kind 0), (b, ho, wo, cout) float32 (res_kind 1), or int8 (res_kind 2)
// multiplied by the float32 *res_scale. out: (b, ho, wo, cout) int8, or
// float32 with out_f32 = 1. cout a multiple of 64, wo at most 128. Returns a
// cudaError_t as int (0 = launched).
extern "C" int hipac_int8_conv_requant(
    const void* x, const void* wt, const void* mscale, const void* bias,
    int bias_map, const void* s_out, const void* residual, int res_kind,
    const void* res_scale, void* out, int out_f32, int relu, long long b, int h,
    int w, int cin, int cout, int kh, int kw, int stride, int pad_top,
    int pad_left, int ho, int wo, void* stream) {
  const bool stem = cin < 64;
  if (b <= 0 || b > 0x7fffffffLL || h < 1 || w < 1 || ho < 1 || wo < 1 ||
      wo > kTileM || kh < 1 || kw < 1 || stride < 1 || pad_top < 0 ||
      pad_left < 0 || cout < 64 || cout % 64 || res_kind < 0 || res_kind > 2) {
    return cudaErrorInvalidValue;
  }
  if (stem ? (cin % 4 != 0 || cin < 4 || cin > 16)
           : (cin % 64 != 0 || kh * kw > kMaxTaps)) {
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
  ConvArgs p = {};
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
  p.kw = kw;
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
  const int wp = (wo - 1) * stride + kw;  // patch columns a row
  const long long groups = (b + p.ipb - 1) / p.ipb;
  const long long tiles = groups * p.bands;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.tiles = static_cast<int>(tiles);

  if (stem) {  // the whole kernel row is one window of the patch row
    p.krow = round_up(kw * cin, 32);
    p.ks = p.krow / 32;
    p.ktot = kh * p.krow;
    p.wpitch = p.ktot + 16;
    p.rowb = round_up(wp * cin + 32, 16);
    // the patch's space also stages the int8 tile (80 bytes a pixel)
    p.patch_bytes = p.ipb * p.seg * p.rowb;
    if (p.patch_bytes < kTileM * 80) p.patch_bytes = kTileM * 80;
    // the weights are loaded once per block: give a block up to eight tiles
    // while the grid still fills the card many times
    const long long fill = tiles * (cout / 64) / (132 * 8);
    p.tpb = static_cast<int>(fill < 1 ? 1 : (fill > 8 ? 8 : fill));
    const dim3 grid(static_cast<unsigned int>((tiles + p.tpb - 1) / p.tpb),
                    static_cast<unsigned int>(cout / 64));
    p.tab_off = round_up(p.patch_bytes + 64 * p.wpitch, 16);
    size_t smem = static_cast<size_t>(p.tab_off) + kTileM * 16;
    if (bias_map) {
      p.bias_off = static_cast<int>(smem);
      smem += static_cast<size_t>(p.ipb) * p.rows * wo * kBiasPitch * 4;
    }
    return launch(int8_conv_stem_kernel, p, grid, kStemThreads, smem, stream);
  }

  // wgmma_block of ops/int8_conv.py: two stages of a larger kernel's weights
  // fit only in blocks of 64 channels
  const int n = cout % 128 == 0 && kh * kw <= 16 ? 128 : 64;
  p.nblk = cout / n;
  // with a stride the columns are stored by residue class, of which the taps
  // read min(stride, kw)
  p.per = (wp + stride - 1) / stride;
  p.nslots = (stride < kw ? stride : kw) * p.per;
  p.rowb = p.nslots * kPix;
  p.wbytes = kh * kw * n * kChunk;
  p.patch_bytes = round_up(p.ipb * p.seg * p.rowb, 128);
  // as many stages of the weights as let two blocks share an SM, at least
  // two, beside the patch's two stages
  const int nchunks = cin / kChunk;
  // the tables: 16 bytes a tile pixel, 8 a patch row, 4 a column slot
  const int tables = kTileM * 16 + p.ipb * p.seg * 8 + p.nslots * 4;
  p.nstage = (kMaxSmem / 2 - 2048 - tables - 2 * p.patch_bytes) / p.wbytes;
  if (p.nstage > kMaxStages) p.nstage = kMaxStages;
  if (p.nstage < 2) p.nstage = 2;
  if (p.nstage > nchunks) p.nstage = nchunks;
  p.patch_off = p.nstage * p.wbytes;
  size_t smem = static_cast<size_t>(p.patch_off) + 2 * p.patch_bytes;
  const size_t staging = static_cast<size_t>(kTileM) * (n + 16);
  if (smem < staging) smem = staging;
  p.tab_off = round_up(static_cast<int>(smem), 16);
  smem = static_cast<size_t>(p.tab_off) + tables;
  const long long blocks = tiles * p.nblk;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned int>(blocks));
  const int taps = kh * kw;
  auto kernel =
      n == 128 ? (taps == 9   ? int8_conv_wgmma_kernel<128, 9>
                  : taps == 1 ? int8_conv_wgmma_kernel<128, 1>
                              : int8_conv_wgmma_kernel<128, 0>)
               : (taps == 9   ? int8_conv_wgmma_kernel<64, 9>
                  : taps == 1 ? int8_conv_wgmma_kernel<64, 1>
                              : int8_conv_wgmma_kernel<64, 0>);
  return launch(kernel, p, grid, kWgThreads, smem, stream);
}
