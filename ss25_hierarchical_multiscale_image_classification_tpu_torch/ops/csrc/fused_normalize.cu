// Fused ImageNet normalize + per-patch pixel sum, for sm_90a.
//
// Replaces the JAX package's Pallas kernel
// ss25_hierarchical_multiscale_image_classification_tpu/ops/pallas/preprocess.py::_kernel
// (wrapper fused_normalize). Same function, not the same blocks: the TPU
// kernel views each patch as one (H*W*3)-wide row, B in blocks of 8.
//
// What it computes, for a contiguous (B, H, W, 3) uint8 batch:
//   out[b, i] = (x[b, i] - m_c) / s_c   with c = i mod 3,
//               m_c = float(255 * IMAGENET_MEAN[c]), s_c = float(255 * IMAGENET_STD[c])
//               in float32, IEEE division, rounded once to float32 or bfloat16;
//   sums[b]  += sum_i x[b, i]           exact, in integers.
// The wrapper turns sums into the per-patch mean the tissue filter reads.
//
// What bounds it: device memory. Per 224x224 patch it reads 150,528 bytes
// and writes 602,112 bytes of float32 (or 301,056 of bfloat16), with a
// subtraction and a division per byte: far below the compute roofline.
//
// How it keeps to one read: each thread loads 16 / sizeof(out) input bytes
// (4 for float32, 8 for bfloat16) and writes 16 bytes, so a warp's loads
// and its stores each cover one contiguous span; both the normalized
// values and the running sum come from that one register copy. A block
// covers one chunk of one patch (grid = B x chunks), reduces its sum with
// warp shuffles, and adds it to the patch's 64-bit counter with one integer
// atomicAdd; integer addition is associative, so the result does not depend
// on the order the blocks run in. 64 bits because a level-0 patch
// (1792x1792x3 bytes of up to 255) sums past 2^31. Patches whose byte count
// is not a multiple of that width, or unaligned pointers, take a
// one-byte-per-thread path.
//
// Bound with ctypes: a plain C entry point, launched on the caller's
// stream, allocating nothing; it returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIters = 4;  // loads per thread per block
constexpr int kWarps = kThreads / 32;

struct Affine {
  float m0, m1, m2;
  float s0, s1, s2;
};

__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store16(float* dst, const float (&f)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* dst,
                                        const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    w[k] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Adds the block's total of `acc` to *sum with one atomic.
__device__ __forceinline__ void block_sum_to(unsigned long long* sum,
                                             unsigned int acc) {
  __shared__ unsigned int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kWarps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) atomicAdd(sum, static_cast<unsigned long long>(acc));
  }
}

// kIn = 16 / sizeof(OutT) bytes per load, 16 bytes per store. Element
// kIn*v + j has channel (kIn*v + j) mod 3; the three constants are rotated
// once per load so the unrolled loop indexes them at compile time.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
fused_normalize_vec(const uint8_t* __restrict__ in, OutT* __restrict__ out,
                    unsigned long long* __restrict__ sums, long long nvec,
                    Affine a) {
  constexpr int kIn = 16 / sizeof(OutT);
  const long long b = blockIdx.x;
  const uint8_t* src = in + b * nvec * kIn;
  OutT* dst = out + b * nvec * kIn;
  unsigned int acc = 0;
  for (long long v = static_cast<long long>(blockIdx.y) * kThreads + threadIdx.x;
       v < nvec; v += static_cast<long long>(gridDim.y) * kThreads) {
    uint32_t words[kIn / 4];
    if constexpr (kIn == 4) {
      words[0] = reinterpret_cast<const uint32_t*>(src)[v];
    } else {
      const uint2 q = reinterpret_cast<const uint2*>(src)[v];
      words[0] = q.x;
      words[1] = q.y;
    }
    const int c0 = static_cast<int>((v * kIn) % 3);
    const float rm[3] = {c0 == 0 ? a.m0 : (c0 == 1 ? a.m1 : a.m2),
                         c0 == 0 ? a.m1 : (c0 == 1 ? a.m2 : a.m0),
                         c0 == 0 ? a.m2 : (c0 == 1 ? a.m0 : a.m1)};
    const float rs[3] = {c0 == 0 ? a.s0 : (c0 == 1 ? a.s1 : a.s2),
                         c0 == 0 ? a.s1 : (c0 == 1 ? a.s2 : a.s0),
                         c0 == 0 ? a.s2 : (c0 == 1 ? a.s0 : a.s1)};
    float f[kIn];
#pragma unroll
    for (int j = 0; j < kIn; ++j) {
      const unsigned int x = (words[j >> 2] >> ((j & 3) * 8)) & 0xffu;
      acc += x;
      f[j] = (static_cast<float>(x) - rm[j % 3]) / rs[j % 3];
    }
    store16(dst + v * kIn, f);
  }
  block_sum_to(sums + b, acc);
}

// One byte per thread per step: any H, W, and unaligned pointers.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
fused_normalize_scalar(const uint8_t* __restrict__ in, OutT* __restrict__ out,
                       unsigned long long* __restrict__ sums, long long n,
                       Affine a) {
  const long long b = blockIdx.x;
  const uint8_t* src = in + b * n;
  OutT* dst = out + b * n;
  unsigned int acc = 0;
  for (long long i = static_cast<long long>(blockIdx.y) * kThreads + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.y) * kThreads) {
    const unsigned int x = src[i];
    acc += x;
    const int c = static_cast<int>(i % 3);
    const float m = c == 0 ? a.m0 : (c == 1 ? a.m1 : a.m2);
    const float s = c == 0 ? a.s0 : (c == 1 ? a.s1 : a.s2);
    store1(dst + i, (static_cast<float>(x) - m) / s);
  }
  block_sum_to(sums + b, acc);
}

template <typename OutT>
cudaError_t launch(const void* in, void* out, unsigned long long* sums,
                   long long batch, long long n, Affine a,
                   cudaStream_t stream) {
  constexpr int kIn = 16 / sizeof(OutT);
  const bool vec = n % kIn == 0 &&
                   reinterpret_cast<uintptr_t>(in) % kIn == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long units = vec ? n / kIn : n;
  const long long per_block = static_cast<long long>(kThreads) * kIters;
  const long long chunks = (units + per_block - 1) / per_block;
  if (chunks > 65535 || batch > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned int>(batch),
                  static_cast<unsigned int>(chunks));
  if (vec) {
    fused_normalize_vec<OutT><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint8_t*>(in), static_cast<OutT*>(out), sums, units,
        a);
  } else {
    fused_normalize_scalar<OutT><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint8_t*>(in), static_cast<OutT*>(out), sums, n, a);
  }
  return cudaGetLastError();
}

}  // namespace

// in: (batch, n) uint8, n = H*W*3; out: (batch, n) float32 (out_bf16 = 0) or
// bfloat16 (out_bf16 = 1); sums: (batch,) int64, zeroed by the caller.
// Returns a cudaError_t as int (0 = launched).
extern "C" int hipac_fused_normalize(const void* in, void* out, void* sums,
                                     long long batch, long long n,
                                     int out_bf16, float m0, float m1,
                                     float m2, float s0, float s1, float s2,
                                     void* stream) {
  if (batch <= 0 || n <= 0 || n % 3 != 0) return cudaErrorInvalidValue;
  const Affine a{m0, m1, m2, s0, s1, s2};
  auto* s = static_cast<unsigned long long*>(sums);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_bf16 ? launch<__nv_bfloat16>(in, out, s, batch, n, a, st)
               : launch<float>(in, out, s, batch, n, a, st);
  return static_cast<int>(err);
}
