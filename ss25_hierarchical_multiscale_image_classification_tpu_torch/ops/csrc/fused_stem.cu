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
// w2 (4, 48, 64) float32 with row KY*12 + slot of group KX, and a float32
// bias that is (64,) or a per-position (Hc, Wc, 64) map:
//   conv[b, r, x, o] = sum_{KY, KX, s} in2[b, r+KY, x+KX, s] * w2[KX, KY*12+s, o]
//   y   = max(conv + bias, 0)
//   out[b, q, p, o] = max of y[b, 2q-1..2q+1, 2p-1..2p+1, o] inside the plane,
// accumulated in float32 and rounded once to the output type. Two kernels:
// float32 products on FP32 FMAs (fused_stem_kernel, below), and bfloat16
// products on the tensor cores (fused_stem_mma_kernel, further down).
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
// bfloat16 products on the tensor cores (mma.sync.m16n8k16, float32
// accumulation). Same block per (image, band) and the same walk down the
// band. For a fixed KY the 48 values (KX, slot) that a conv column reads are
// contiguous in the space-to-depth row, starting 12 values after its left
// neighbour's: the im2col matrix is a set of overlapping 48-wide windows of
// the row ring, so A fragments are plain 32-bit loads from it and K runs as
// KY*48 + KX*12 + slot (12 steps of 16). The wrapper hands the weights over
// as wt[o][K] in that order. A warp owns 32 channels and half of the conv
// row's 16-column tiles (up to 4 x 4 accumulator tiles) and keeps its weight
// fragments in 96 registers for the whole band. The row's ReLU output goes
// through shared memory (padded to 72 floats a column against bank
// conflicts) so that any thread can pool any column. The row ring has five
// slots: while rows cr..cr+3 feed the products, row cr+4 arrives from device
// memory with cp.async, so no warp waits on a load it has just issued.
// ---------------------------------------------------------------------------

constexpr int kKSteps = kK / 16;
constexpr int kYStride = kCo + 8;  // floats per column of the ReLU row

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__host__ __device__ constexpr int mma_row_len(int mtiles) {
  // bfloat16 values of (mtiles * 16 + 3) pixels: the last column's window
  return (mtiles * 16 + 3) * kSlots;
}

constexpr int kRing = 5;

// Start the copy of one space-to-depth row (n values, n a multiple of 4 and
// both ends 8-byte aligned) into a ring slot; it lands asynchronously.
__device__ __forceinline__ void copy_row_async(
    const __nv_bfloat16* __restrict__ src, int n, __nv_bfloat16* dst) {
  for (int c = threadIdx.x; c < n / 4; c += kThreads) {
    const unsigned int d =
        static_cast<unsigned int>(__cvta_generic_to_shared(dst + 4 * c));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src + 4 * c));
  }
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
fused_stem_mma_kernel(const __nv_bfloat16* __restrict__ in2,
                      const __nv_bfloat16* __restrict__ wt,
                      const float* __restrict__ bias, OutT* __restrict__ out,
                      int hin, int win, int pool_rows, long long bias_sh,
                      long long bias_sw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hc = hin - 3, wc = win - 3;
  const int ho = (hc - 1) / 2 + 1, wo = (wc - 1) / 2 + 1;
  const int mtiles = (wc + 15) / 16;
  const int row_len = mma_row_len(mtiles);
  float* ybuf = reinterpret_cast<float*>(smem_raw);  // (mtiles*16, 72)
  __nv_bfloat16* rows =
      reinterpret_cast<__nv_bfloat16*>(ybuf + mtiles * 16 * kYStride);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ng = warp & 1;  // channels ng*32..+31
  const int half_tiles = (mtiles + 1) / 2;
  const int mt0 = (warp >> 1) * half_tiles;
  const int my_tiles = min(half_tiles, mtiles - mt0);
  const long long b = blockIdx.x;
  const int q0 = blockIdx.y * pool_rows;
  const int q1 = min(q0 + pool_rows, ho);
  const int cr_begin = max(2 * q0 - 1, 0);
  const int cr_end = min(2 * q1 - 1, hc - 1);  // inclusive
  const int n = win * kSlots;
  const __nv_bfloat16* img = in2 + b * hin * n;
  OutT* ob = out + b * ho * wo * kCo;

  // the ring's first four rows on their way; past a row's end stays zero
  for (int r = cr_begin; r <= cr_begin + 3; ++r) {
    copy_row_async(img + static_cast<long long>(r) * n, n,
                   rows + (r % kRing) * row_len);
  }
  const int tail = row_len - n;
  for (int e = tid; e < kRing * tail; e += kThreads) {
    rows[(e / tail) * row_len + n + e % tail] = __float2bfloat16_rn(0.0f);
  }

  uint32_t bfrag[kKSteps][4][2];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const __nv_bfloat16* p = wt + (ng * 32 + nt * 8 + g) * kK + ks * 16 + 2 * t;
      bfrag[ks][nt][0] = *reinterpret_cast<const uint32_t*>(p);
      bfrag[ks][nt][1] = *reinterpret_cast<const uint32_t*>(p + 8);
    }
  }

  // pooling: thread = 4 channels (cg4) of pooled columns xo0 + 8*i
  const int cg4 = tid & 15, xo0 = tid >> 4;
  float vm[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) vm[i][j] = 0.0f;
  }

  for (int cr = cr_begin; cr <= cr_end; ++cr) {
    // rows cr..cr+3 have landed; every thread is past its reads of row cr-1,
    // whose slot row cr+4 takes
    wait_copies();
    __syncthreads();
    if (cr < cr_end) {
      copy_row_async(img + static_cast<long long>(cr + 4) * n, n,
                     rows + ((cr + 4) % kRing) * row_len);
    }

    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mi][nt][j] = 0.0f;
      }
    }
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int ky = ks / 3;
      const __nv_bfloat16* rp =
          rows + ((cr + ky) % kRing) * row_len + (ks % 3) * 16 + 2 * t;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if (mi < my_tiles) {
          const __nv_bfloat16* ap = rp + ((mt0 + mi) * 16 + g) * kSlots;
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(ap);
          a[1] = *reinterpret_cast<const uint32_t*>(ap + 8 * kSlots);
          a[2] = *reinterpret_cast<const uint32_t*>(ap + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(ap + 8 * kSlots + 8);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mi][nt], a, bfrag[ks][nt]);
        }
      }
    }

    // + bias, ReLU into the shared row; columns past the plane become 0
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      if (mi < my_tiles) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int x = (mt0 + mi) * 16 + g + 8 * hf;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int ch = ng * 32 + nt * 8 + 2 * t;
            float2 v = make_float2(0.0f, 0.0f);
            if (x < wc) {
              const float2 bv = *reinterpret_cast<const float2*>(
                  bias + cr * bias_sh + x * bias_sw + ch);
              v.x = fmaxf(acc[mi][nt][2 * hf] + bv.x, 0.0f);
              v.y = fmaxf(acc[mi][nt][2 * hf + 1] + bv.y, 0.0f);
            }
            *reinterpret_cast<float2*>(ybuf + x * kYStride + ch) = v;
          }
        }
      }
    }
    __syncthreads();

    const bool odd = (cr & 1) != 0;
    const bool ends = odd || cr == hc - 1;  // conv row 2q+1 (or the last) ends q
    const int q = cr >> 1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = xo0 + 8 * i;
      if (p < wo) {
        float h[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const int x = 2 * p + dx;
          if (x >= 0 && x < wc) {
            const float4 v =
                *reinterpret_cast<const float4*>(ybuf + x * kYStride + cg4 * 4);
            h[0] = fmaxf(h[0], v.x);
            h[1] = fmaxf(h[1], v.y);
            h[2] = fmaxf(h[2], v.z);
            h[3] = fmaxf(h[3], v.w);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) vm[i][j] = fmaxf(vm[i][j], h[j]);
        if (ends && q >= q0 && q < q1) {
          store4(ob + (static_cast<long long>(q) * wo + p) * kCo + cg4 * 4,
                 &vm[i][0]);
        }
        if (odd) {  // conv row 2(q+1)-1 opens the next pooled row
#pragma unroll
          for (int j = 0; j < 4; ++j) vm[i][j] = h[j];
        }
      }
    }
  }
}

template <typename OutT>
cudaError_t launch_mma(const void* in2, const void* wt, const float* bias,
                       void* out, long long b, int hin, int win, int pool_rows,
                       long long bias_sh, long long bias_sw,
                       cudaStream_t stream) {
  const int hc = hin - 3, wc = win - 3;
  const int ho = (hc - 1) / 2 + 1;
  const int mtiles = (wc + 15) / 16;
  const int bands = (ho + pool_rows - 1) / pool_rows;
  const size_t smem = kRing * mma_row_len(mtiles) * sizeof(__nv_bfloat16) +
                      sizeof(float) * mtiles * 16 * kYStride;
  auto kernel = fused_stem_mma_kernel<OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned int>(b),
                  static_cast<unsigned int>(bands));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(in2),
      static_cast<const __nv_bfloat16*>(wt), bias,
      static_cast<OutT*>(out), hin, win, pool_rows, bias_sh, bias_sw);
  return cudaGetLastError();
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

// The same function with bfloat16 products on the tensor cores. bias and out
// as above; in2 bfloat16; wt: (64, 192) bfloat16, wt[o][KY*48 + KX*12 + slot].
extern "C" int hipac_fused_stem_mma(const void* in2, const void* wt,
                                    const void* bias, void* out, long long b,
                                    int hin, int win, int pool_rows,
                                    int bias_map, int out_bf16, void* stream) {
  if (b <= 0 || b > 0x7fffffffLL || hin < 4 || win < 4 || pool_rows < 1 ||
      win - 3 > kMaxGroups * kPx) {
    return cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(in2) % 16 ||
      reinterpret_cast<uintptr_t>(wt) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return cudaErrorInvalidValue;
  }
  const long long sh = bias_map ? static_cast<long long>(win - 3) * kCo : 0;
  const long long sw = bias_map ? kCo : 0;
  const auto* bp = static_cast<const float*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_bf16 ? launch_mma<__nv_bfloat16>(in2, wt, bp, out, b, hin, win, pool_rows, sh, sw, st)
               : launch_mma<float>(in2, wt, bp, out, b, hin, win, pool_rows, sh, sw, st);
  return static_cast<int>(err);
}
