// Fused bias + ReLU + 3x3 stride-2 maxpool (pad 1) over an NHWC plane, for
// sm_90a.
//
// Replaces the JAX package's Pallas kernel
// ss25_hierarchical_multiscale_image_classification_tpu/ops/pallas/fused_stem.py::_bias_relu_pool_kernel
// (wrapper bias_relu_pool). Same function, not the same blocks: the TPU
// kernel takes 28 conv rows of one image per grid step plus a boundary row
// that the wrapper gathers, and writes a pre-negated bias into the pad row.
//
// What it computes, for a contiguous (B, H, W, C) plane x in bfloat16 or
// float32 and a float32 bias that is (C,) or a per-position (H, W, C) map:
//   y[b, h, w, c]   = max(float(x[b, h, w, c]) + bias[(h, w,) c], 0)
//   out[b, q, p, c] = max of y[b, 2q-1..2q+1, 2p-1..2p+1, c] inside the plane,
// one float32 add and comparisons, rounded once to the output type; so the
// result equals the plain PyTorch version bit for bit. Positions outside the
// plane never win (y >= 0 and the window's centre is always inside), which is
// the -inf padding of the float model.
//
// What bounds it: device memory. At (512, 112, 112, 64) bfloat16 it reads
// 822 MB and writes 206 MB with one add and ~2 comparisons per byte.
//
// How it keeps to one pass: a thread owns 8 channels (16 bytes of bfloat16)
// of one pooled column and walks down a band of kRows pooled rows, keeping
// the column-wise maximum of the last conv row in registers, so each conv row
// is loaded once per band (the band's first row twice). The three columns a
// thread reads overlap its neighbours' by one; the 8 channel groups of a
// pixel sit in consecutive lanes, so a warp's loads cover whole pixels and
// the overlap is served by L1/L2. The bias map (3.2 MB at full size) stays in
// L2.
//
// Bound with ctypes: a plain C entry point, launched on the caller's stream,
// allocating nothing; it returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;  // pooled rows per thread
constexpr int kVec = 8;   // channels per thread

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[kVec]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // a bfloat16 is the upper half of the float32 with the same value
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[kVec]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename InT, typename OutT>
__global__ void __launch_bounds__(kThreads)
bias_relu_pool_kernel(const InT* __restrict__ x, const float* __restrict__ bias,
                      OutT* __restrict__ out, long long items, int h, int w,
                      int c, int ho, int wo, int bands, long long bias_sh,
                      long long bias_sw) {
  long long item = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (item >= items) return;
  const int cgs = c / kVec;
  const int c0 = static_cast<int>(item % cgs) * kVec;
  item /= cgs;
  const int p = static_cast<int>(item % wo);
  item /= wo;
  const int band = static_cast<int>(item % bands);
  const long long b = item / bands;
  const InT* xb = x + b * h * w * c;
  OutT* ob = out + b * ho * wo * c;

  // column-wise maximum of y over conv row r, columns 2p-1..2p+1
  auto row_max = [&](int r, float (&acc)[kVec]) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int col = 2 * p + dx;
      if (col < 0 || col >= w) continue;
      float v[kVec], bv[kVec];
      load8(xb + (static_cast<long long>(r) * w + col) * c + c0, v);
      load8(bias + r * bias_sh + col * bias_sw + c0, bv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        acc[k] = fmaxf(acc[k], fmaxf(v[k] + bv[k], 0.0f));
      }
    }
  };

  const int q0 = band * kRows;
  const int q1 = min(q0 + kRows, ho);
  float carry[kVec];  // row 2q-1, shared with the pooled row above
  if (q0 > 0) {
    row_max(2 * q0 - 1, carry);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) carry[k] = 0.0f;
  }
  for (int q = q0; q < q1; ++q) {
    float m[kVec], t[kVec];
    row_max(2 * q, t);
#pragma unroll
    for (int k = 0; k < kVec; ++k) m[k] = fmaxf(carry[k], t[k]);
    if (2 * q + 1 < h) {
      row_max(2 * q + 1, carry);
#pragma unroll
      for (int k = 0; k < kVec; ++k) m[k] = fmaxf(m[k], carry[k]);
    }
    store8(ob + (static_cast<long long>(q) * wo + p) * c + c0, m);
  }
}

template <typename InT, typename OutT>
cudaError_t launch(const void* x, const float* bias, void* out, long long b,
                   int h, int w, int c, long long bias_sh, long long bias_sw,
                   cudaStream_t stream) {
  const int ho = (h - 1) / 2 + 1;
  const int wo = (w - 1) / 2 + 1;
  const int bands = (ho + kRows - 1) / kRows;
  const long long items = b * bands * wo * (c / kVec);
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  bias_relu_pool_kernel<InT, OutT>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
          static_cast<const InT*>(x), bias, static_cast<OutT*>(out), items, h,
          w, c, ho, wo, bands, bias_sh, bias_sw);
  return cudaGetLastError();
}

}  // namespace

// x: (b, h, w, c) contiguous, bfloat16 (in_bf16 = 1) or float32; bias:
// float32, (c,) with bias_map = 0 or (h, w, c) with bias_map = 1; out:
// (b, (h-1)/2+1, (w-1)/2+1, c) bfloat16 (out_bf16 = 1) or float32. c must be
// a multiple of 8 and the pointers 16-byte aligned. Returns a cudaError_t as
// int (0 = launched).
extern "C" int hipac_bias_relu_pool(const void* x, const void* bias, void* out,
                                    long long b, int h, int w, int c,
                                    int bias_map, int in_bf16, int out_bf16,
                                    void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || c % kVec != 0) {
    return cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(bias) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return cudaErrorInvalidValue;
  }
  const long long sh = bias_map ? static_cast<long long>(w) * c : 0;
  const long long sw = bias_map ? c : 0;
  const auto* bp = static_cast<const float*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_bf16) {
    err = out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, bp, out, b, h, w, c, sh, sw, st)
                   : launch<__nv_bfloat16, float>(x, bp, out, b, h, w, c, sh, sw, st);
  } else {
    err = out_bf16 ? launch<float, __nv_bfloat16>(x, bp, out, b, h, w, c, sh, sw, st)
                   : launch<float, float>(x, bp, out, b, h, w, c, sh, sw, st);
  }
  return static_cast<int>(err);
}
