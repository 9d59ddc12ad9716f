// Whole ResNet stem in one pass, for sm_90a: 4x4 stride-1 VALID convolution
// over a 2x2 space-to-depth input (K = 4*4*12 = 192, 64 output channels),
// + bias, ReLU, 3x3 stride-2 maxpool (pad 1); only the pooled plane is written.
//
// Replaces the JAX package's Pallas kernel
// ss25_hierarchical_multiscale_image_classification_tpu/ops/pallas/fused_stem.py::_stem_kernel
// (wrapper fused_stem). Same function, not the same blocks: the TPU kernel
// holds a whole image in fast memory, takes 7 pooled rows per grid step as
// four K=48 matrix products over 15 conv rows at once, and blends the pad row
// in arithmetically.
//
// What it computes, for in2 (B, Hc+3, Wc+3, 12) in float32 or bfloat16,
// w2 (4, 48, 64) with row KY*12 + slot of group KX, and a bias that is (64,)
// or a per-position (Hc, Wc, 64) map:
//   conv[b, r, x, o] = sum_{KY, KX, s} in2[b, r+KY, x+KX, s] * w2[KX, KY*12+s, o]
//   y   = max(conv + bias, 0)
//   out[b, q, p, o] = max of y[b, 2q-1..2q+1, 2p-1..2p+1, o] inside the plane,
// accumulated in float32 and rounded once to the output type. Two kernels:
// float32 products on FP32 FMAs (fused_stem_kernel, below, for parity
// checks), and bfloat16 products on wgmma (fused_stem_wgmma_kernel, further
// down, the serving path).
//
// What bounds it: operations. At B = 512 and 224x224 images the product is
// 157.8 GFLOP against 162-325 MB read and 206 MB written: at least 2.4 ms on
// FP32 FMAs, 0.16 ms at the dense bfloat16 tensor rate.
//
// Design of the FMA kernel: one block of 128 threads per (image, band of pool_rows pooled
// rows). The block keeps the 192x64 weights (48 KB) and a ring of four
// space-to-depth rows in shared memory and walks down the band one conv row
// at a time. A thread owns 8 neighbouring conv columns x 8 channels (64
// accumulators): per (KY, slot) it reads 11 inputs and, per KX, 8 weights as
// two float4, for 256 FMAs. Rows are stored with 4 floats of padding after
// every 8 pixels so that the four column groups of a warp read different
// banks; the 8 channel groups read one contiguous 128-byte line. The row's
// ReLU output never leaves registers: the column-wise 3-maximum needs one
// neighbour column, passed through a small shared array, and the row-wise
// maximum runs in registers down the band. The band's first conv row is
// computed twice (by this band and the one above): 1/(2*pool_rows) extra work.
//
// Bound with ctypes: a plain C entry point, launched on the caller's stream,
// allocating nothing; it returns the first CUDA error (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_wgmma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPx = 8;      // conv columns per thread
constexpr int kCo = 64;     // output channels
constexpr int kSlots = 12;  // space-to-depth channels
constexpr int kK = 4 * 4 * kSlots;
constexpr int kGroup = kPx * kSlots + 4;  // floats of 8 stored pixels + padding
constexpr int kMaxGroups = kThreads / 8;  // column groups a block covers

__host__ __device__ constexpr int row_floats(int groups) {
  // (groups * 8 + 3) pixels: the last group reads 3 pixels past its own
  return groups * kGroup + 3 * kSlots;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                                            *reinterpret_cast<uint32_t*>(&hi));
}

// One space-to-depth row (n = win * 12 values) into its padded shared layout;
// everything past the row's end, and the padding, is zero.
__device__ __forceinline__ void load_row(const float* __restrict__ src, int n,
                                         float* dst, int row_len) {
  for (int idx = threadIdx.x; idx < row_len; idx += kThreads) {
    const int grp = idx / kGroup;
    const int off = idx - grp * kGroup;
    const int e = grp * (kPx * kSlots) + off;
    dst[idx] = off < kPx * kSlots && e < n ? src[e] : 0.0f;
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
fused_stem_kernel(const float* __restrict__ in2, const float* __restrict__ w2,
                  const float* __restrict__ bias, OutT* __restrict__ out,
                  int hin, int win, int pool_rows, long long bias_sh,
                  long long bias_sw) {
  extern __shared__ __align__(16) float smem[];
  const int hc = hin - 3, wc = win - 3;
  const int ho = (hc - 1) / 2 + 1, wo = (wc - 1) / 2 + 1;
  const int groups = (wc + kPx - 1) / kPx;
  const int row_len = row_floats(groups);
  float* sw = smem;                  // (4, 48, 64) as given
  float* rows = sw + kK * kCo;       // ring of 4 rows, slot = row & 3
  float* edge = rows + 4 * row_len;  // (groups, 64): each group's last column

  const int tid = threadIdx.x;
  const int cg = tid & 7;   // channels cg*4..+3 and 32+cg*4..+3
  const int pg = tid >> 3;  // conv columns pg*8..+7
  const bool active = pg < groups;
  const long long b = blockIdx.x;
  const int q0 = blockIdx.y * pool_rows;
  const int q1 = min(q0 + pool_rows, ho);
  const int cr_begin = max(2 * q0 - 1, 0);
  const int cr_end = min(2 * q1 - 1, hc - 1);  // inclusive
  const float* img = in2 + b * hin * win * kSlots;
  OutT* ob = out + b * ho * wo * kCo;

  for (int i = tid; i < kK * kCo / 4; i += kThreads) {
    reinterpret_cast<float4*>(sw)[i] = reinterpret_cast<const float4*>(w2)[i];
  }

  float vm[4][8];  // running row-wise maximum of 4 pooled columns x 8 channels
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int i = 0; i < 8; ++i) vm[t][i] = 0.0f;
  }

  for (int cr = cr_begin; cr <= cr_end; ++cr) {
    // rows cr..cr+3 into the ring: all four at the start, then one new row,
    // which takes the slot of row cr-1 (every thread is past its last read)
    for (int r = (cr == cr_begin ? cr : cr + 3); r <= cr + 3; ++r) {
      load_row(img + static_cast<long long>(r) * win * kSlots, win * kSlots,
               rows + (r & 3) * row_len, row_len);
    }
    __syncthreads();

    float y[kPx][8];
    if (active) {
#pragma unroll
      for (int p = 0; p < kPx; ++p) {
#pragma unroll
        for (int i = 0; i < 8; ++i) y[p][i] = 0.0f;
      }
#pragma unroll 1
      for (int ky = 0; ky < 4; ++ky) {
        const float* seg = rows + ((cr + ky) & 3) * row_len + pg * kGroup;
        const float* wk = sw + ky * kSlots * kCo + cg * 4;
#pragma unroll 4
        for (int s = 0; s < kSlots; ++s) {
          float xin[kPx + 3];
#pragma unroll
          for (int c = 0; c < kPx + 3; ++c) {
            xin[c] = seg[c * kSlots + (c >= kPx ? 4 : 0) + s];
          }
#pragma unroll
          for (int kx = 0; kx < 4; ++kx) {
            const float* wp = wk + kx * (4 * kSlots * kCo) + s * kCo;
            const float4 wa = *reinterpret_cast<const float4*>(wp);
            const float4 wb = *reinterpret_cast<const float4*>(wp + 32);
#pragma unroll
            for (int p = 0; p < kPx; ++p) {
              const float xv = xin[p + kx];
              y[p][0] = fmaf(xv, wa.x, y[p][0]);
              y[p][1] = fmaf(xv, wa.y, y[p][1]);
              y[p][2] = fmaf(xv, wa.z, y[p][2]);
              y[p][3] = fmaf(xv, wa.w, y[p][3]);
              y[p][4] = fmaf(xv, wb.x, y[p][4]);
              y[p][5] = fmaf(xv, wb.y, y[p][5]);
              y[p][6] = fmaf(xv, wb.z, y[p][6]);
              y[p][7] = fmaf(xv, wb.w, y[p][7]);
            }
          }
        }
      }
      // + bias, ReLU; columns past the plane become 0, which never wins
#pragma unroll
      for (int p = 0; p < kPx; ++p) {
        const int x = pg * kPx + p;
        if (x < wc) {
          const float* bp = bias + cr * bias_sh + x * bias_sw + cg * 4;
          const float4 ba = *reinterpret_cast<const float4*>(bp);
          const float4 bb = *reinterpret_cast<const float4*>(bp + 32);
          y[p][0] = fmaxf(y[p][0] + ba.x, 0.0f);
          y[p][1] = fmaxf(y[p][1] + ba.y, 0.0f);
          y[p][2] = fmaxf(y[p][2] + ba.z, 0.0f);
          y[p][3] = fmaxf(y[p][3] + ba.w, 0.0f);
          y[p][4] = fmaxf(y[p][4] + bb.x, 0.0f);
          y[p][5] = fmaxf(y[p][5] + bb.y, 0.0f);
          y[p][6] = fmaxf(y[p][6] + bb.z, 0.0f);
          y[p][7] = fmaxf(y[p][7] + bb.w, 0.0f);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) y[p][i] = 0.0f;
        }
      }
      store4(edge + pg * kCo + cg * 4, &y[kPx - 1][0]);
      store4(edge + pg * kCo + 32 + cg * 4, &y[kPx - 1][4]);
    }
    __syncthreads();

    if (active) {
      // pooled column pg*4 + t covers conv columns 2t-1, 2t, 2t+1 of this
      // thread; column -1 is the left neighbour's last
      float h[4][8];
      float left[8];
      if (pg > 0) {
        const float4 la =
            *reinterpret_cast<const float4*>(edge + (pg - 1) * kCo + cg * 4);
        const float4 lb = *reinterpret_cast<const float4*>(
            edge + (pg - 1) * kCo + 32 + cg * 4);
        left[0] = la.x; left[1] = la.y; left[2] = la.z; left[3] = la.w;
        left[4] = lb.x; left[5] = lb.y; left[6] = lb.z; left[7] = lb.w;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) left[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        h[0][i] = fmaxf(left[i], fmaxf(y[0][i], y[1][i]));
        h[1][i] = fmaxf(y[1][i], fmaxf(y[2][i], y[3][i]));
        h[2][i] = fmaxf(y[3][i], fmaxf(y[4][i], y[5][i]));
        h[3][i] = fmaxf(y[5][i], fmaxf(y[6][i], y[7][i]));
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int i = 0; i < 8; ++i) vm[t][i] = fmaxf(vm[t][i], h[t][i]);
      }
      const bool odd = (cr & 1) != 0;
      if (odd || cr == hc - 1) {  // conv row 2q+1 (or the plane's last) ends q
        const int q = cr >> 1;
        if (q >= q0 && q < q1) {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int p = pg * 4 + t;
            if (p < wo) {
              OutT* op = ob + (static_cast<long long>(q) * wo + p) * kCo + cg * 4;
              store4(op, &vm[t][0]);
              store4(op + 32, &vm[t][4]);
            }
          }
        }
      }
      if (odd) {  // conv row 2(q+1)-1 opens the next pooled row
#pragma unroll
        for (int t = 0; t < 4; ++t) {
#pragma unroll
          for (int i = 0; i < 8; ++i) vm[t][i] = h[t][i];
        }
      }
    }
  }
}

template <typename OutT>
cudaError_t launch(const float* in2, const float* w2, const float* bias,
                   void* out, long long b, int hin, int win, int pool_rows,
                   long long bias_sh, long long bias_sw, cudaStream_t stream) {
  const int hc = hin - 3, wc = win - 3;
  const int ho = (hc - 1) / 2 + 1;
  const int groups = (wc + kPx - 1) / kPx;
  const int bands = (ho + pool_rows - 1) / pool_rows;
  const size_t smem =
      sizeof(float) * (kK * kCo + 4 * row_floats(groups) + groups * kCo);
  auto kernel = fused_stem_kernel<OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned int>(b),
                  static_cast<unsigned int>(bands));
  kernel<<<grid, kThreads, smem, stream>>>(
      in2, w2, bias, static_cast<OutT*>(out), hin, win, pool_rows, bias_sh,
      bias_sw);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 products on wgmma (float32 accumulation), for sm_90a.
//
// Rows of the product (M) are conv columns, N the 64 channels, K = 192 in the
// order KY*48 + KX*12 + slot. For a fixed KY the 48 values (KX, slot) that a
// conv column reads are contiguous in the space-to-depth row, starting 12
// values after its left neighbour's, so the A operand stays in registers,
// loaded with plain 32-bit shared loads from the row ring (the `mma.sync`
// A fragment is the `wgmma` A fragment; there is no im2col buffer). B is the
// weight image packed once on the host (pack_stem_weights of
// ops/fused_stem.py): per K step of 16, [channel / 8][K half][channel % 8][8
// values], 2 KB, read by the tensor cores through a no-swizzle descriptor
// (128 bytes between the two K halves, 256 between channel groups: a bf16
// core matrix is 8 channels by 8 values = 16 bytes a row, the same bytes as
// the int8 image's 8 channels by 16 values). One bulk copy lands it once per
// block.
//
// Column mapping: warp W' (of 4 * tiles consumer warps) writes the 7 pooled
// columns 7W' .. 7W' + 6, whose windows span the 15 conv columns 14W' - 1 ..
// 14W' + 13; its 16 product rows are those columns and one spare. So every
// 3-column maximum lies inside one warp: two lanes' registers apart, taken
// with shuffles, and no conv column passes through shared memory. A 112-wide
// plane is 56 pooled columns = 8 warps = two warpgroups (tiles). For a
// bfloat16 output the ReLU values are rounded to bfloat16 before the maxima
// (rounding is monotone, so the result is the same) and two channels move
// per shuffle.
//
// Work: persistent blocks, one per SM, walk work items (band of pool_rows
// pooled rows, image) band-major; each block takes a contiguous run of items
// of equal cost (conv rows). The bias map's rows of a band stay in shared
// memory (bfloat16 or float32, as given) for every image of the band that
// the block takes: a block reads the map about once, where the previous
// design read it from L2 for every conv row of every image. A producer warp
// streams the space-to-depth rows with bulk copies into a ring of mbarrier
// slots, running ahead into the next item. Each copy starts at the 16-byte
// boundary at or below the row (rows of W * 24 bytes start 0 or 8 bytes past
// one) and the A loads add the row's offset. Each of the two consumer
// warpgroups owns one 64-row tile of every conv row and walks the band: A
// loads, 12 products, then the bias, ReLU, column maxima and stores of that
// row, with the running maximum down the band in registers. The two
// warpgroups take turns at the tensor cores: one's epilogue runs under the
// other's products. (Two accumulator sets a warpgroup, products of row
// cr + 1 under the epilogue of row cr, measured slower: at the 168
// registers that a 9-warp block leaves, the compiler spills and waits for
// the products before the epilogue; PERF.md.)
// ---------------------------------------------------------------------------

using namespace hipac_int8;  // descriptor, wgmma fences, mbarriers, bulk copy

constexpr int kKSteps = kK / 16;                 // 12 products of k16
constexpr int kWImgBytes = kKSteps * kCo * 32;   // 24 KB weight image
constexpr int kRing = 8;  // slots of input rows (a power of two)
constexpr int kPoolsPerWarp = 7;
constexpr int kBiasPitch = kCo + 8;  // elements a column of the bias band
constexpr int kSmemBudget = 232448 - 256;  // dynamic bytes (static below)

__host__ __device__ constexpr int ring_slot_bytes(int win) {
  // the row, its 0- or 8-byte start offset, rounded up to 16 bytes
  return (win * kSlots * 2 + 16 + 15) / 16 * 16;
}

__device__ __forceinline__ void keep_f(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// D (64 x 64, float32) (+)= A (64 x 16, bf16, registers) * B (64 x 16, bf16,
// shared memory through `b_desc`), B K-major. Fragments as in
// int8_wgmma.cuh: warp w of the warpgroup holds rows 16w .. 16w + 15, a[0..3]
// the mma.m16n8k16 A fragment, d[4 * nt + j] = c[j] of the 8-channel tile nt.
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(accumulate));
}

// Two channels of one column in the output type, with the operations the
// pooling needs.
template <typename OutT>
struct PoolPair;

template <>
struct PoolPair<__nv_bfloat16> {
  using V = uint32_t;
  static __device__ __forceinline__ V zero() { return 0u; }
  static __device__ __forceinline__ V make(float a, float b) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ V vmax(V a, V b) {
    __nv_bfloat162 r = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&a),
                               *reinterpret_cast<__nv_bfloat162*>(&b));
    return *reinterpret_cast<uint32_t*>(&r);
  }
  static __device__ __forceinline__ V shfl(V v, int src) {
    return __shfl_sync(0xffffffffu, v, src);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, V v) {
    *reinterpret_cast<uint32_t*>(p) = v;
  }
};

template <>
struct PoolPair<float> {
  using V = float2;
  static __device__ __forceinline__ V zero() { return make_float2(0.0f, 0.0f); }
  static __device__ __forceinline__ V make(float a, float b) {
    return make_float2(a, b);
  }
  static __device__ __forceinline__ V vmax(V a, V b) {
    return make_float2(fmaxf(a.x, b.x), fmaxf(a.y, b.y));
  }
  static __device__ __forceinline__ V shfl(V v, int src) {
    return make_float2(__shfl_sync(0xffffffffu, v.x, src),
                       __shfl_sync(0xffffffffu, v.y, src));
  }
  static __device__ __forceinline__ void store(float* p, V v) {
    *reinterpret_cast<float2*>(p) = v;
  }
};

// Conv rows [first, last] of the band of pooled rows [q0, q1).
struct Band {
  int q0, q1, first, last;
};

__host__ __device__ __forceinline__ Band band_of(int band, int pool_rows,
                                                 int hc) {
  const int ho = (hc - 1) / 2 + 1;
  Band bd;
  bd.q0 = band * pool_rows;
  bd.q1 = min(bd.q0 + pool_rows, ho);
  bd.first = max(2 * bd.q0 - 1, 0);
  bd.last = min(2 * bd.q1 - 1, hc - 1);
  return bd;
}

// First work item (band-major: item = band * b + image) of block `j` of
// `blocks`: the items are cut into runs of equal cost in conv rows.
__device__ long long first_item(int j, int blocks, int bands, int pool_rows,
                                int hc, long long b) {
  long long total = 0;
  for (int i = 0; i < bands; ++i) {
    const Band bd = band_of(i, pool_rows, hc);
    total += b * (bd.last - bd.first + 1);
  }
  const long long target = total * j / blocks;
  long long before = 0;
  for (int i = 0; i < bands; ++i) {
    const Band bd = band_of(i, pool_rows, hc);
    const long long cost = bd.last - bd.first + 1;
    if (target < before + b * cost) {
      return i * b + (target - before + cost - 1) / cost;
    }
    before += b * cost;
  }
  return bands * b;
}

__device__ __forceinline__ float2 bias_pair(const unsigned char* band,
                                            int bias_bf16, int off) {
  if (bias_bf16) {
    return __bfloat1622float2(
        reinterpret_cast<const __nv_bfloat162*>(band)[off >> 1]);
  }
  return reinterpret_cast<const float2*>(band)[off >> 1];
}

__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

template <typename OutT, int kTiles>
__global__ void __launch_bounds__(kTiles * 128 + 32, 1)
fused_stem_wgmma_kernel(const __nv_bfloat16* __restrict__ in2,
                        const unsigned char* __restrict__ wimg,
                        const unsigned char* __restrict__ bias,
                        OutT* __restrict__ out, long long b, int hin, int win,
                        int pool_rows, int bias_map, int bias_bf16) {
  using P = PoolPair<OutT>;
  using V = typename P::V;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kRing], empty[kRing], wbar;
  constexpr int kConsumers = kTiles * 128;
  const int hc = hin - 3, wc = win - 3;
  const int ho = (hc - 1) / 2 + 1, wo = (wc - 1) / 2 + 1;
  const int bands = (ho + pool_rows - 1) / pool_rows;
  const int slot_b = ring_slot_bytes(win);
  const long long row_bytes = static_cast<long long>(win) * kSlots * 2;
  unsigned char* wsm = smem_raw;
  unsigned char* ring = smem_raw + kWImgBytes;
  unsigned char* band_sm = ring + kRing * slot_b;
  const int esize = bias_bf16 ? 2 : 4;
  const int tid = threadIdx.x;
  const long long it0 = first_item(blockIdx.x, gridDim.x, bands, pool_rows, hc, b);
  const long long it1 = first_item(blockIdx.x + 1, gridDim.x, bands, pool_rows, hc, b);

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init(&wbar, 1);
    mbar_init_fence();
    mbar_arrive_expect_tx(&wbar, kWImgBytes);
    bulk_copy_g2s(wsm, wimg, kWImgBytes, &wbar);
  }
  if (!bias_map && tid < kCo) {  // a (64,) float32 bias, once
    reinterpret_cast<float*>(band_sm)[tid] =
        reinterpret_cast<const float*>(bias)[tid];
  }
  __syncthreads();

  // The producer warp's first thread streams the block's input rows, in
  // the order the warpgroups read them, into the ring: feed(upto) issues
  // every row whose sequence number is below `upto`, each once its slot's
  // previous row is released. Row s of the block's sequence lands in slot
  // s % kRing; the counters are 32-bit and kRing a power of two, so they
  // may wrap. (Issued from a consumer thread, the copies and their waits sat
  // on the products' path: 1.33-1.55 ms against 0.89 at B = 512.)
  const unsigned char* src = reinterpret_cast<const unsigned char*>(in2);
  const long long total = b * hin * row_bytes;
  uint32_t f_seq = 0;
  long long f_left = it1 - it0;  // items not yet fully issued
  int f_band = static_cast<int>(it0 / b);
  long long f_img = it0 % b;
  Band f_bd = band_of(f_band, pool_rows, hc);
  int f_r = f_bd.first;
  auto feed = [&](uint32_t upto) {
    for (; static_cast<int>(upto - f_seq) > 0 && f_left > 0; ++f_seq) {
      const int slot = f_seq & (kRing - 1);
      if (f_seq >= kRing) {
        mbar_wait(&empty[slot], ((f_seq / kRing) + 1) & 1);
      }
      const long long start = (f_img * hin + f_r) * row_bytes;
      const long long a0 = start & ~15LL;
      long long a1 = (start + row_bytes + 15) & ~15LL;
      unsigned char* dst = ring + slot * slot_b;
      if (a1 > total) {  // the tensor's last 8 bytes: no 16-byte copy
        a1 = total & ~15LL;
        *reinterpret_cast<uint2*>(dst + (a1 - a0)) =
            *reinterpret_cast<const uint2*>(src + a1);
      }
      mbar_arrive_expect_tx(&full[slot], static_cast<uint32_t>(a1 - a0));
      bulk_copy_g2s(dst, src + a0, static_cast<uint32_t>(a1 - a0), &full[slot]);
      if (++f_r > f_bd.last + 3 && --f_left > 0) {  // the next item
        if (++f_img == b) {
          f_img = 0;
          f_bd = band_of(++f_band, pool_rows, hc);
        }
        f_r = f_bd.first;
      }
    }
  };
  // the role as a value the compiler knows to be the same across a warp
  // group: wgmma under a branch it cannot prove uniform is serialized
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == kTiles) {
    if (tid == kConsumers) feed(f_seq + 0x7fffffffu);
    return;
  }

  // consumers: warpgroup wg owns product rows 64 wg .. 64 wg + 63
  const int lane = tid & 31, warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int g = lane >> 2, t = lane & 3;
  const int x0 = 14 * warp - 1 + g;  // this lane's product rows g, g + 8
  const int x1 = 14 * warp + 7 + g;
  const bool v0 = x0 >= 0 && x0 < wc, v1 = x1 < wc;
  const int x0c = min(max(x0, 0), wc - 1), x1c = min(x1, wc - 1);
  const int bx0 = x0c * kSlots * 2 + 4 * t, bx1 = x1c * kSlots * 2 + 4 * t;
  const int bias_row = bias_map ? wc * kBiasPitch : 0;
  const int bias_col = bias_map ? kBiasPitch : 0;
  // pooled columns of this lane's two sets (even g only)
  const int p0 = kPoolsPerWarp * warp + g / 2;
  const int p1 = kPoolsPerWarp * warp + 4 + g / 2;
  const bool st0 = (g & 1) == 0 && p0 < wo;
  const bool st1 = (g & 1) == 0 && g <= 4 && p1 < wo;
  const uint64_t b_desc = wgmma_desc(wsm);
  mbar_wait(&wbar, 0);

  float acc[32];
  uint32_t a[kKSteps][4];
  uint32_t seq = 0;  // the ring's sequence number of the item's first row
  int band_loaded = -1;
  int band = static_cast<int>(it0 / b);
  long long img = it0 % b;

  for (long long it = it0; it < it1; ++it, ++img) {
    if (img == b) {
      img = 0;
      ++band;
    }
    const Band bd = band_of(band, pool_rows, hc);
    if (bias_map && band != band_loaded) {
      // every consumer is past the previous band's epilogues
      consumer_sync(kConsumers);
      const int units = kCo * esize / 16;  // 16-byte pieces of a column
      const int rows = bd.last - bd.first + 1;
      for (int e = tid; e < rows * wc * units; e += kConsumers) {
        const int col = e / units, u = e % units;  // col = row * wc + x
        const uint4 v = reinterpret_cast<const uint4*>(
            bias + (static_cast<long long>(bd.first) * wc + col) * kCo * esize)[u];
        reinterpret_cast<uint4*>(band_sm + col * kBiasPitch * esize)[u] = v;
      }
      consumer_sync(kConsumers);
      band_loaded = band;
    }
    const uint32_t seq0 = seq - bd.first;  // + r: row r's sequence number
    // a row of W * 24 bytes starts 8 bytes past a 16-byte boundary when its
    // index in the tensor and W are both odd
    const int odd_img = static_cast<int>(img & hin & 1);
    auto slot_of = [&](int r) { return static_cast<int>((seq0 + r) & (kRing - 1)); };
    auto wait_row = [&](int r) {
      mbar_wait(&full[slot_of(r)], ((seq0 + r) / kRing) & 1);
    };
    // A of conv row cr from rows cr .. cr + 3, then its products
    auto issue = [&](int cr, float (&d)[32]) {
      if (cr == bd.first) {
        for (int r = cr; r < cr + 3; ++r) wait_row(r);
      }
      wait_row(cr + 3);
#pragma unroll
      for (int ky = 0; ky < 4; ++ky) {
        const int r = cr + ky;
        const int off = 8 * (win & (odd_img ^ r) & 1);
        const unsigned char* base = ring + slot_of(r) * slot_b + off;
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) {
          const unsigned char* q0p = base + bx0 + jj * 32;
          const unsigned char* q1p = base + bx1 + jj * 32;
          uint32_t(&f)[4] = a[ky * 3 + jj];
          f[0] = *reinterpret_cast<const uint32_t*>(q0p);
          f[1] = *reinterpret_cast<const uint32_t*>(q1p);
          f[2] = *reinterpret_cast<const uint32_t*>(q0p + 16);
          f[3] = *reinterpret_cast<const uint32_t*>(q1p + 16);
        }
      }
      // row cr has no reader after this (rows past the band's last: none)
      __syncwarp();
      if (lane == 0) {
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                         smem_u32(&empty[slot_of(cr)]))
                     : "memory");
        if (cr == bd.last) {
          for (int r = cr + 1; r <= cr + 3; ++r) {
            asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                             smem_u32(&empty[slot_of(r)]))
                         : "memory");
          }
        }
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        wgmma_bf16(d, a[ks], b_desc + ks * (kCo * 32 / 16), ks > 0);
      }
      wgmma_commit();
      // refill the slot that row cr - 1 left (every warp is past it unless
      // the other warpgroup runs a row behind)
    };
    auto finish = [&](float (&d)[32]) {
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) keep_f(d[i]);
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
        for (int i = 0; i < 4; ++i) keep(a[ks][i]);
      }
    };

    V vm0[8], vm1[8];  // running maxima down the band, sets g and g + 8
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) vm0[nt] = vm1[nt] = P::zero();
    // + bias, ReLU, the 3-column maxima, the running maximum, the stores
    auto epilogue = [&](int cr, const float (&d)[32]) {
      const int rl = bias_map ? cr - bd.first : 0;
      const bool odd = (cr & 1) != 0;
      const int q = cr >> 1;
      const bool ends = (odd || cr == hc - 1) && q >= bd.q0 && q < bd.q1;
      OutT* orow = out + ((img * ho + q) * wo) * kCo;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int ch = nt * 8 + 2 * t;
        const float2 b0 = bias_pair(band_sm, bias_bf16, rl * bias_row + x0c * bias_col + ch);
        const float2 b1 = bias_pair(band_sm, bias_bf16, rl * bias_row + x1c * bias_col + ch);
        const V y0 = v0 ? P::make(fmaxf(d[4 * nt] + b0.x, 0.0f),
                                  fmaxf(d[4 * nt + 1] + b0.y, 0.0f))
                        : P::zero();
        const V y1 = v1 ? P::make(fmaxf(d[4 * nt + 2] + b1.x, 0.0f),
                                  fmaxf(d[4 * nt + 3] + b1.y, 0.0f))
                        : P::zero();
        // the window of an even lane g is rows g, g + 1, g + 2 of its set;
        // for g = 6 in the first set, g + 2 is row 0 of the second
        const V n1_0 = P::shfl(y0, (lane + 4) & 31);
        const V n2_0 = P::shfl(y0, (lane + 8) & 31);
        const V n1_1 = P::shfl(y1, (lane + 4) & 31);
        const V n2_1 = P::shfl(y1, (lane + 8) & 31);
        const V h0 = P::vmax(y0, P::vmax(n1_0, g == 6 ? n2_1 : n2_0));
        const V h1 = P::vmax(y1, P::vmax(n1_1, n2_1));
        const V m0 = P::vmax(vm0[nt], h0);
        const V m1 = P::vmax(vm1[nt], h1);
        if (ends) {  // conv row 2q + 1 (or the plane's last) ends q
          if (st0) P::store(orow + p0 * kCo + ch, m0);
          if (st1) P::store(orow + p1 * kCo + ch, m1);
        }
        // conv row 2(q + 1) - 1 opens the next pooled row
        vm0[nt] = odd ? h0 : m0;
        vm1[nt] = odd ? h1 : m1;
      }
    };

    // the other warpgroup's products run under this one's epilogue
    for (int cr = bd.first; cr <= bd.last; ++cr) {
      issue(cr, acc);
      finish(acc);
      epilogue(cr, acc);
    }
    seq += bd.last - bd.first + 4;
  }
}

// Dynamic shared memory of the wgmma kernel: weight image, ring, bias band.
inline long long wgmma_smem(int hin, int win, int pool_rows, int bias_map,
                            int bias_bf16) {
  const int hc = hin - 3, wc = win - 3;
  const int band_rows = min(2 * pool_rows + 1, hc);
  const long long band = bias_map ? static_cast<long long>(band_rows) * wc *
                                        kBiasPitch * (bias_bf16 ? 2 : 4)
                                  : kCo * 4;
  return kWImgBytes + static_cast<long long>(kRing) * ring_slot_bytes(win) + band;
}

template <typename OutT, int kTiles>
cudaError_t launch_wgmma(const void* in2, const void* wimg, const void* bias,
                         void* out, long long b, int hin, int win,
                         int pool_rows, int blocks, int bias_map,
                         int bias_bf16, cudaStream_t stream) {
  const long long smem = wgmma_smem(hin, win, pool_rows, bias_map, bias_bf16);
  auto kernel = fused_stem_wgmma_kernel<OutT, kTiles>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kTiles * 128 + 32, static_cast<size_t>(smem), stream>>>(
      static_cast<const __nv_bfloat16*>(in2),
      static_cast<const unsigned char*>(wimg),
      static_cast<const unsigned char*>(bias), static_cast<OutT*>(out), b, hin,
      win, pool_rows, bias_map, bias_bf16);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_wgmma_tiles(int tiles, const void* in2, const void* wimg,
                               const void* bias, void* out, long long b,
                               int hin, int win, int pool_rows, int blocks,
                               int bias_map, int bias_bf16,
                               cudaStream_t stream) {
  switch (tiles) {
    case 1:
      return launch_wgmma<OutT, 1>(in2, wimg, bias, out, b, hin, win, pool_rows,
                                   blocks, bias_map, bias_bf16, stream);
    case 2:
      return launch_wgmma<OutT, 2>(in2, wimg, bias, out, b, hin, win, pool_rows,
                                   blocks, bias_map, bias_bf16, stream);
    default:
      return launch_wgmma<OutT, 3>(in2, wimg, bias, out, b, hin, win, pool_rows,
                                   blocks, bias_map, bias_bf16, stream);
  }
}

}  // namespace

// float32 products. in2: (b, hin, win, 12) contiguous float32; w2: (4, 48, 64)
// float32; bias: float32, (64,) with bias_map = 0 or (hin-3, win-3, 64) with
// bias_map = 1; out: (b, ho, wo, 64) bfloat16 (out_bf16 = 1) or float32,
// ho = (hin-4)/2+1, wo = (win-4)/2+1. The conv plane may be up to 128 columns
// wide. Returns a cudaError_t as int (0 = launched).
extern "C" int hipac_fused_stem(const void* in2, const void* w2,
                                const void* bias, void* out, long long b,
                                int hin, int win, int pool_rows, int bias_map,
                                int out_bf16, void* stream) {
  if (b <= 0 || b > 0x7fffffffLL || hin < 4 || win < 4 || pool_rows < 1 ||
      win - 3 > kMaxGroups * kPx) {
    return cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(w2) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return cudaErrorInvalidValue;
  }
  const long long sh = bias_map ? static_cast<long long>(win - 3) * kCo : 0;
  const long long sw = bias_map ? kCo : 0;
  const auto* ip = static_cast<const float*>(in2);
  const auto* wp = static_cast<const float*>(w2);
  const auto* bp = static_cast<const float*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_bf16 ? launch<__nv_bfloat16>(ip, wp, bp, out, b, hin, win, pool_rows, sh, sw, st)
               : launch<float>(ip, wp, bp, out, b, hin, win, pool_rows, sh, sw, st);
  return static_cast<int>(err);
}

// The same function with bfloat16 products on wgmma. in2: (b, hin, win, 12)
// bfloat16, 16-byte aligned; wimg: the (12 * 64 * 16,) bfloat16 weight image
// of pack_stem_weights; bias: (64,) float32 (bias_map = 0) or an
// (hin-3, win-3, 64) map in bfloat16 (bias_bf16 = 1) or float32; out as
// above. pool_rows: pooled rows a band; blocks: persistent blocks (one an
// SM); tiles: consumer warpgroups, ceil(wo / 28) (ops/fused_stem.py::
// stem_wgmma_plan computes all three). Returns a cudaError_t as int.
extern "C" int hipac_fused_stem_wgmma(const void* in2, const void* wimg,
                                      const void* bias, void* out, long long b,
                                      int hin, int win, int pool_rows,
                                      int blocks, int tiles, int bias_map,
                                      int bias_bf16, int out_bf16,
                                      void* stream) {
  if (b <= 0 || b > 0x7fffffffLL || hin < 4 || win < 4 || pool_rows < 1 ||
      blocks < 1 || win - 3 > kMaxGroups * kPx) {
    return cudaErrorInvalidValue;
  }
  const int wo = (win - 4) / 2 + 1;
  if (tiles != (wo + 4 * kPoolsPerWarp - 1) / (4 * kPoolsPerWarp) ||
      wgmma_smem(hin, win, pool_rows, bias_map, bias_bf16) > kSmemBudget) {
    return cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(in2) % 16 ||
      reinterpret_cast<uintptr_t>(wimg) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_bf16 ? launch_wgmma_tiles<__nv_bfloat16>(tiles, in2, wimg, bias, out, b, hin, win, pool_rows, blocks, bias_map, bias_bf16, st)
               : launch_wgmma_tiles<float>(tiles, in2, wimg, bias, out, b, hin, win, pool_rows, blocks, bias_map, bias_bf16, st);
  return static_cast<int>(err);
}
