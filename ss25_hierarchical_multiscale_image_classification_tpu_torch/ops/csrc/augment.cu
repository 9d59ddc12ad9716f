// Classifier training augmentation (D4 element, colour affine, clip,
// ImageNet normalize) in two passes, for sm_90a.
//
// The JAX package has no Pallas kernel here: XLA fuses its
// ss25_hierarchical_multiscale_image_classification_tpu/data/augment.py::augment_batch
// into a few passes inside the jitted train step, where eager PyTorch runs
// each of its ~15 operations as a pass over the batch. These two kernels
// stand for that fusion, equal bit for bit to the plain PyTorch version
// (data/augment.py::augment_batch of the port).
//
// What it computes, for a contiguous (B, S, S, 3) uint8 batch:
//   pass 1 (hipac_augment_sums): sums[b] += sum of image b's bytes, exact
//     in integers (the wrapper turns it into the mean m0 and the affine);
//   pass 2 (hipac_augment_apply): out[b, y, x, d] from the source pixel
//     (sy, sx) of the image's D4 element, looked up from its draws (hflip
//     h, vflip v, k quarter turns) in the 16-entry table d4 (3 bits an
//     entry at 3 * (8h + 4v + k): bit 0 transpose, bit 1 x-reverse, bit 2
//     y-reverse): with every channel v = bf16(x_c * inv255),
//     c = bf16(bf16(bf16(bf16(m_d0 v_r) + bf16(m_d1 v_g)) + bf16(m_d2 v_b))
//     + bias), clipped to [0, 1], then (c * 255 - mean255_d) / std255_d in
//     float32 with an IEEE division. Every product and sum is rounded where
//     the eager bfloat16 operations round (float32 result, then to bfloat16
//     to nearest even), with __fmul_rn/__fadd_rn so that nvcc contracts
//     nothing into an FMA.
//
// What bounds it: device memory. At (512, 224, 224, 3) the function reads
// 77.1 MB and writes 308.3 MB of float32 (0.115 ms at 3.35 TB/s); this
// two-pass design reads the input twice (0.138 ms). The operations, ~20 a
// byte read, are far below the compute roofline.
//
// Design, simple first: pass 1 is fused_normalize.cu's block reduction
// (16 bytes a thread a step, warp shuffles, one 64-bit atomicAdd a block,
// order-independent). Pass 2 gives a block one 32 x 32 output tile of one
// image: the source rows of the tile (a 32 x 32 window under any D4
// element) are staged in shared memory by whole rows, each thread maps its
// output pixel into the window and puts its three floats into an output
// tile in shared memory, and the block writes that tile by whole rows
// (a warp's store covers 128 contiguous bytes).
//
// Bound with ctypes: plain C entry points, launched on the caller's stream,
// allocating nothing; each returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIters = 4;  // loads per thread per block in pass 1
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // output tile edge in pixels (pass 2)

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

// The sum of a word's four bytes.
__device__ __forceinline__ unsigned int byte_sum(uint32_t w) {
  return __vsadu4(w, 0u);
}

__global__ void __launch_bounds__(kThreads)
augment_sums_vec(const uint4* __restrict__ in,
                 unsigned long long* __restrict__ sums, long long nvec) {
  const long long b = blockIdx.x;
  const uint4* src = in + b * nvec;
  unsigned int acc = 0;
  for (long long v = static_cast<long long>(blockIdx.y) * kThreads + threadIdx.x;
       v < nvec; v += static_cast<long long>(gridDim.y) * kThreads) {
    const uint4 q = src[v];
    acc += byte_sum(q.x) + byte_sum(q.y) + byte_sum(q.z) + byte_sum(q.w);
  }
  block_sum_to(sums + b, acc);
}

// One byte per thread per step: any size and unaligned pointers.
__global__ void __launch_bounds__(kThreads)
augment_sums_scalar(const uint8_t* __restrict__ in,
                    unsigned long long* __restrict__ sums, long long n) {
  const long long b = blockIdx.x;
  const uint8_t* src = in + b * n;
  unsigned int acc = 0;
  for (long long i = static_cast<long long>(blockIdx.y) * kThreads + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.y) * kThreads) {
    acc += src[i];
  }
  block_sum_to(sums + b, acc);
}

struct Norm {
  float inv255;  // bfloat16(1/255), as a float
  float m0, m1, m2;  // float32(255 * IMAGENET_MEAN)
  float s0, s1, s2;  // float32(255 * IMAGENET_STD)
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_bits(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// ((m0 r + m1 g) + m2 b) + bias, rounded to bfloat16 after every operation,
// clipped, normalized.
__device__ __forceinline__ float channel(const float* m, float bias, float r,
                                         float g, float b, float mean,
                                         float std) {
  float c = bf16r(__fmul_rn(m[0], r));
  c = bf16r(__fadd_rn(c, bf16r(__fmul_rn(m[1], g))));
  c = bf16r(__fadd_rn(c, bf16r(__fmul_rn(m[2], b))));
  c = bf16r(__fadd_rn(c, bias));
  c = fminf(fmaxf(c, 0.0f), 1.0f);
  return __fdiv_rn(__fsub_rn(__fmul_rn(c, 255.0f), mean), std);
}

__global__ void __launch_bounds__(kThreads)
augment_apply(const uint8_t* __restrict__ in, const uint8_t* __restrict__ hflip,
              const uint8_t* __restrict__ vflip, const long long* __restrict__ k,
              unsigned long long d4, const uint16_t* __restrict__ mat,
              const uint16_t* __restrict__ bias, float* __restrict__ out, int s,
              Norm nm) {
  // source window, rows padded to 25 words: a warp reading down a column
  // (under a transpose) hits 32 banks
  __shared__ uint8_t tile[kTile][kTile * 3 + 4];
  __shared__ float otile[kTile][kTile * 3];  // the output tile, row-major
  __shared__ float coef[10];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * kTile;
  const int tx0 = blockIdx.x * kTile;
  const int entry = 8 * (hflip[b] != 0) + 4 * (vflip[b] != 0) +
                    static_cast<int>(k[b] & 3);
  const int code = static_cast<int>((d4 >> (3 * entry)) & 7);
  const bool t = code & 1, fx = code & 2, fy = code & 4;

  // the window of source rows and columns the tile reads
  const int ny = min(kTile, s - ty0);
  const int nx = min(kTile, s - tx0);
  const int yy0 = fy ? s - ty0 - ny : ty0;
  const int xx0 = fx ? s - tx0 - nx : tx0;
  const int r0 = t ? xx0 : yy0, nr = t ? nx : ny;
  const int c0 = t ? yy0 : xx0, nc = t ? ny : nx;

  // each warp copies whole source rows, lanes on neighbouring bytes
  const uint8_t* src = in + static_cast<size_t>(b) * s * s * 3;
  for (int r = warp; r < nr; r += kWarps) {
    const uint8_t* row = src + (static_cast<size_t>(r0 + r) * s + c0) * 3;
    for (int cb = lane; cb < nc * 3; cb += 32) tile[r][cb] = row[cb];
  }
  if (threadIdx.x < 9) coef[threadIdx.x] = bf16_bits(mat[b * 9 + threadIdx.x]);
  if (threadIdx.x == 9) coef[9] = bf16_bits(bias[b]);
  __syncthreads();

  float m[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = coef[i];
  const float bia = coef[9];
  // a warp computes an output row of the tile, a lane a pixel
  if (lane < nx) {
    const int xx = fx ? s - 1 - (tx0 + lane) : tx0 + lane;
    for (int ly = warp; ly < ny; ly += kWarps) {
      const int y = ty0 + ly;
      const int yy = fy ? s - 1 - y : y;
      const int sy = t ? xx : yy;
      const int sx = t ? yy : xx;
      const uint8_t* p = &tile[sy - r0][(sx - c0) * 3];
      const float vr = bf16r(__fmul_rn(static_cast<float>(p[0]), nm.inv255));
      const float vg = bf16r(__fmul_rn(static_cast<float>(p[1]), nm.inv255));
      const float vb = bf16r(__fmul_rn(static_cast<float>(p[2]), nm.inv255));
      float* o = &otile[ly][lane * 3];
      o[0] = channel(m, bia, vr, vg, vb, nm.m0, nm.s0);
      o[1] = channel(m + 3, bia, vr, vg, vb, nm.m1, nm.s1);
      o[2] = channel(m + 6, bia, vr, vg, vb, nm.m2, nm.s2);
    }
  }
  __syncthreads();

  // each warp writes whole output rows: 128 contiguous bytes a store
  for (int r = warp; r < ny; r += kWarps) {
    float* row = out + ((static_cast<size_t>(b) * s + ty0 + r) * s + tx0) * 3;
    for (int c = lane; c < nx * 3; c += 32) row[c] = otile[r][c];
  }
}

}  // namespace

// in: (batch, n) uint8; sums: (batch,) int64, zeroed by the caller.
// Returns a cudaError_t as int (0 = launched).
extern "C" int hipac_augment_sums(const void* in, void* sums, long long batch,
                                  long long n, void* stream) {
  if (batch <= 0 || batch > 0x7fffffffLL || n <= 0) return cudaErrorInvalidValue;
  const bool vec = n % 16 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;
  const long long units = vec ? n / 16 : n;
  const long long per_block = static_cast<long long>(kThreads) * kIters;
  const long long chunks = (units + per_block - 1) / per_block;
  if (chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned int>(batch),
                  static_cast<unsigned int>(chunks));
  auto* s = static_cast<unsigned long long*>(sums);
  auto st = static_cast<cudaStream_t>(stream);
  if (vec) {
    augment_sums_vec<<<grid, kThreads, 0, st>>>(static_cast<const uint4*>(in),
                                                 s, units);
  } else {
    augment_sums_scalar<<<grid, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(in), s, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// in: (batch, s, s, 3) uint8; hflip, vflip: (batch,) bool; k: (batch,)
// int64 in 0..3; d4: the packed table; mat: (batch, 3, 3) bfloat16; bias:
// (batch,) bfloat16; out: (batch, s, s, 3) float32.
extern "C" int hipac_augment_apply(const void* in, const void* hflip,
                                   const void* vflip, const void* k,
                                   unsigned long long d4, const void* mat,
                                   const void* bias, void* out,
                                   long long batch, int s,
                                   float inv255, float m0, float m1, float m2,
                                   float s0, float s1, float s2,
                                   void* stream) {
  if (batch <= 0 || batch > 65535 || s <= 0) return cudaErrorInvalidValue;
  const Norm nm{inv255, m0, m1, m2, s0, s1, s2};
  const unsigned int tiles = static_cast<unsigned int>((s + kTile - 1) / kTile);
  const dim3 grid(tiles, tiles, static_cast<unsigned int>(batch));
  augment_apply<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<const uint8_t*>(hflip),
      static_cast<const uint8_t*>(vflip), static_cast<const long long*>(k),
      d4, static_cast<const uint16_t*>(mat), static_cast<const uint16_t*>(bias),
      static_cast<float*>(out), s, nm);
  return static_cast<int>(cudaGetLastError());
}
