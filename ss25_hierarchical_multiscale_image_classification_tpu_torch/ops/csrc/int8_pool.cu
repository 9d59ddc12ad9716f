// 3x3 stride-2 maxpool (pad 1) over NHWC int8 activations, for sm_90a: the
// pool between the stem and stage 1 of the int8 (w8a8) ResNet18 forward.
//
// Stands for the `lax.reduce_window` on int8 of the JAX package's
// models/quantized.py::quant_forward, which XLA compiles (there is no Pallas
// kernel for it). PyTorch's `max_pool2d` takes no int8 tensor on CUDA, and
// the way round it in plain ops (cast to bfloat16, pool, cast back) moves
// seven times the bytes.
//
// What bounds it: bytes (one comparison per byte read). A thread owns 16
// channels of one output pixel: up to nine 16-byte loads (the windows
// overlap, so L1/L2 serve most of them), a byte-wise signed maximum
// (`__vmaxs4`) and one 16-byte store. A tap outside the plane is skipped,
// which is the pad of -128: every window holds at least one real element.
//
// Built by ops/build.py (nvcc, plain C entry point, no PyTorch headers).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint4 vmax16(uint4 a, uint4 b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y), __vmaxs4(a.z, b.z),
                    __vmaxs4(a.w, b.w));
}

__global__ void __launch_bounds__(kThreads)
int8_maxpool_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                    long long total, int h, int w, int ho, int wo, int c16) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i >= total) return;
  const int cv = static_cast<int>(i % c16);
  long long rest = i / c16;
  const int ox = static_cast<int>(rest % wo);
  rest /= wo;
  const int oy = static_cast<int>(rest % ho);
  const long long img = rest / ho;
  const uint4* plane = x + img * h * w * c16;
  const unsigned int low = 0x80808080u;  // four times -128
  uint4 m = make_uint4(low, low, low, low);
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const int iy = 2 * oy + dy;
    if (iy < 0 || iy >= h) continue;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int ix = 2 * ox + dx;
      if (ix < 0 || ix >= w) continue;
      m = vmax16(m, __ldg(plane + (static_cast<long long>(iy) * w + ix) * c16 + cv));
    }
  }
  out[i] = m;
}

}  // namespace

// x: (b, h, w, c) int8 contiguous, c a multiple of 16; out: (b, ho, wo, c) int8
// with ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1. Returns a cudaError_t as int
// (0 = launched).
extern "C" int hipac_int8_maxpool(const void* x, void* out, long long b, int h,
                                  int w, int c, void* stream) {
  if (b <= 0 || h < 1 || w < 1 || c < 16 || c % 16) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16) {
    return cudaErrorInvalidValue;
  }
  const int ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1;
  const long long total = b * ho * wo * (c / 16);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  int8_maxpool_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), total, h, w, ho,
      wo, c / 16);
  return static_cast<int>(cudaGetLastError());
}
