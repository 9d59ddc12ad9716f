// Classifier training augmentation (D4 element, colour affine, clip,
// ImageNet normalize) in one launch, for sm_90a.
//
// The JAX package has no Pallas kernel here: XLA fuses its
// ss25_hierarchical_multiscale_image_classification_tpu/data/augment.py::augment_batch
// into a few passes inside the jitted train step, where eager PyTorch runs
// each of its ~15 operations as a pass over the batch. This kernel stands
// for that fusion, equal bit for bit to the plain PyTorch version
// (data/augment.py::augment_batch of the port).
//
// What it computes, for a contiguous (B, S, S, 3) uint8 batch: each image's
// mean m0 = float(sum of its bytes) / n / 255 (the sum exact in integers,
// two IEEE divisions), its contrast bias bf16(((1 - fc) fb) m0) from the
// float32 draws, then out[b, y, x, d] from the source pixel (sy, sx) of the
// image's D4 element, looked up from its draws (hflip h, vflip v, k quarter
// turns) in the 16-entry table d4 (3 bits an entry at 3 * (8h + 4v + k):
// bit 0 transpose, bit 1 x-reverse, bit 2 y-reverse): with every channel
// v = bf16(x_c * inv255), c = bf16(bf16(bf16(bf16(m_d0 v_r) + bf16(m_d1
// v_g)) + bf16(m_d2 v_b)) + bias), clipped to [0, 1], then (c * 255 -
// mean255_d) / std255_d in float32 with an IEEE division. The (B, 3, 3)
// bfloat16 matrix comes from the wrapper: it depends on the draws only.
//
// Exactness. The eager bfloat16 operations compute each product and sum in
// float32 and round it to bfloat16 to nearest even. Here they are
// `mul.rn.bf16x2` and `add.rn.bf16x2`, which round the exact result once,
// two channels a word: the same bits, because a product of two bfloat16
// values is exact in float32 (8 x 8 significant bits), and so is a sum of
// two unless their exponents differ by more than 15, when the smaller is
// under 2^-15 of the larger and both routes give the larger. The explicit
// `.rn` keeps ptxas from fusing a product and a sum into an FMA; the
// float32 tail uses the explicitly rounded intrinsics for the same reason.
// Its division by std255_d is q0 = a y, q = q0 + (a - std q0) y with
// y = RN(1 / std) (Markstein's correction, two FMAs): the IEEE quotient for
// every a the clipped bfloat16 c can give, as a CPU test checks in exact
// arithmetic, without __fdiv_rn's reciprocal, range check and branch per
// value.
//
// What bounds it: device memory. At (512, 224, 224, 3) the function reads
// 77.1 MB and writes 308.3 MB of float32: 0.115 ms at 3.35 TB/s. The
// per-pixel work (~60 instructions) is what keeps it from that bound; the
// arithmetic above halves it against float32 arithmetic with a conversion
// to bfloat16 after every operation (PERF.md has the versions' times,
// scripts/profile_torch_augment.py measures them).
//
// Design: a cluster of kCluster blocks an image, every input byte read from
// device memory once. Block j of the cluster owns the source rows
// [j R, (j + 1) R), R = ceil(S / kCluster): one bulk copy a row lands them
// in shared memory (rows padded to an odd number of 16-byte units, so that
// a warp reading down a column under a transpose meets 4-way bank conflicts
// and not 8-way), byte loads where a row is not a multiple of 16 bytes. The
// block sums its band into a shared slot; after a cluster barrier warp 0
// adds the kCluster slots through distributed shared memory (an exact
// integer sum, so the order does not matter) and derives m0 and the bias.
// Then the block writes the output region its band maps to under the D4
// element, so that it reads no other block's pixels: output rows without a
// transpose, output columns with one; the pixel (iy, ix) of that region
// reads the band's byte org + iy dy + ix dx. A warp computes kRuns runs of
// up to 32 consecutive output pixels of a region row (a lane a pixel, so
// kRuns independent pixels a lane), puts their floats into its own buffer
// and stores them as 16-byte vectors (4-byte stores where a run is not
// aligned). A second cluster barrier, arrived at once the slots are read and
// waited on at the end, keeps every block's slot alive while another block
// reads it. Blocks of 128 threads (8 an SM at 64 registers) hide the band
// loads better than blocks of 256; persistent clusters that copy the next
// image's band under this one's work measured slower (PERF.md).
//
// Bound with ctypes: a plain C entry point, launched on the caller's stream,
// allocating nothing; it returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_wgmma.cuh"

namespace cg = cooperative_groups;
using hipac_int8::bulk_copy_g2s;
using hipac_int8::mbar_arrive_expect_tx;
using hipac_int8::mbar_init;
using hipac_int8::mbar_init_fence;
using hipac_int8::mbar_wait;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;  // blocks an image
constexpr int kRun = 32;     // output pixels of a run: a lane a pixel
constexpr int kRuns = 4;     // runs a warp computes before it stores them
// shared memory ahead of the band: barrier, slot, coefficients, warp sums,
// warp buffers
constexpr int kSlotOffset = 8;
constexpr int kCoefOffset = 16;
constexpr int kSumsOffset = 64;
constexpr int kBufOffset = kSumsOffset + kWarps * 4;
constexpr int kBandOffset = kBufOffset + kWarps * kRuns * kRun * 3 * 4;
constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90

struct Norm {
  float inv255;      // bfloat16(1/255), as a float
  float m0, m1, m2;  // float32(255 * IMAGENET_MEAN)
  float s0, s1, s2;  // float32(255 * IMAGENET_STD)
};

__host__ __device__ constexpr int band_rows(int s) {
  return (s + kCluster - 1) / kCluster;
}

// A band row's pitch in bytes: 3 S rounded up to an odd number of 16-byte
// units.
__host__ __device__ constexpr int band_pitch(int s) {
  const int units = (3 * s + 15) / 16;
  return 16 * (units % 2 ? units : units + 1);
}

__host__ __device__ constexpr int smem_bytes(int s) {
  return kBandOffset + band_rows(s) * band_pitch(s);
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two bfloat16 values in one word, each rounded once to nearest even, as
// the eager operations round (see the note on exactness above).
__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t badd2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// a + b rounded once, then both halves clipped to [0, 1] (the sum times 1
// is the sum: one rounding, as add.rn).
__device__ __forceinline__ uint32_t badd2_clip(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.relu.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(0x3f803f80u), "r"(b));
  asm("min.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(d), "r"(0x3f803f80u));
  return d;
}

// {bf16(x), bf16(x)} for a byte x: x as a float is exact and has at most 8
// significant bits, so its upper half is its bfloat16.
__device__ __forceinline__ uint32_t bf16x2_of_byte(uint32_t x) {
  const uint32_t f = __float_as_uint(
      __fsub_rn(__uint_as_float(0x4B000000u | x), 8388608.0f));
  return __byte_perm(f, f, 0x3232);
}

// ((m_d0 r + m_d1 g) + m_d2 b) + bias for two output channels at once (one
// a half), each operation rounded to bfloat16, clipped.
__device__ __forceinline__ uint32_t channels2(const uint32_t* m, uint32_t bias,
                                              uint32_t r, uint32_t g,
                                              uint32_t b) {
  uint32_t c = badd2(bmul2(m[0], r), bmul2(m[1], g));
  c = badd2(c, bmul2(m[2], b));
  return badd2_clip(c, bias);
}

// A clipped channel c (bfloat16 bits in the upper half) normalized in
// float32: (c * 255 - mean) / std, the quotient from y = RN(1 / std) by
// Markstein's correction, which gives the IEEE quotient (tested against it
// for every reachable c of each channel on the CPU).
__device__ __forceinline__ float normalize(uint32_t upper, float mean,
                                           float std, float y) {
  // c 255 is exact (8 by 8 significant bits): one rounding, as the plain
  // version's product then difference
  const float a = __fmaf_rn(__uint_as_float(upper), 255.0f, -mean);
  const float q0 = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-std, q0, a), y, q0);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 8)
augment_kernel(const uint8_t* __restrict__ in, const uint8_t* __restrict__ hflip,
               const uint8_t* __restrict__ vflip, const int* __restrict__ k,
               int k_words, unsigned long long d4,
               const uint16_t* __restrict__ mat, const float* __restrict__ fb,
               const float* __restrict__ fc, float* __restrict__ out, int s,
               int bulk, int vec, Norm nm) {
  extern __shared__ __align__(16) uint8_t smem[];
  auto* bar = reinterpret_cast<uint64_t*>(smem);
  auto* slot = reinterpret_cast<unsigned long long*>(smem + kSlotOffset);
  auto* coef = reinterpret_cast<float*>(smem + kCoefOffset);
  auto* warp_sums = reinterpret_cast<unsigned int*>(smem + kSumsOffset);
  auto* bufs = reinterpret_cast<float*>(smem + kBufOffset);
  uint8_t* band = smem + kBandOffset;

  cg::cluster_group cluster = cg::this_cluster();
  const int j = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = band_rows(s), pitch = band_pitch(s);
  const int row_bytes = 3 * s;
  const int r0 = j * rows;
  const int nr = max(0, min(rows, s - r0));
  const uint8_t* src = in + (static_cast<size_t>(b) * s + r0) * row_bytes;

  // the band into shared memory
  if (bulk) {
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (warp == 0 && nr > 0) {
      if (lane == 0) mbar_arrive_expect_tx(bar, nr * row_bytes);
      __syncwarp();
      for (int r = lane; r < nr; r += 32) {
        bulk_copy_g2s(band + r * pitch, src + r * row_bytes, row_bytes, bar);
      }
    }
    if (nr > 0) mbar_wait(bar, 0);
  } else {
    for (int i = threadIdx.x; i < nr * row_bytes; i += kThreads) {
      band[(i / row_bytes) * pitch + i % row_bytes] = src[i];
    }
    __syncthreads();
  }

  // the band's byte sum into this block's slot
  unsigned int acc = 0;
  if (row_bytes % 16 == 0) {
    const int q = row_bytes / 16;
    for (int i = threadIdx.x; i < nr * q; i += kThreads) {
      const uint4 w =
          *reinterpret_cast<const uint4*>(band + (i / q) * pitch + (i % q) * 16);
      acc += __vsadu4(w.x, 0u) + __vsadu4(w.y, 0u) + __vsadu4(w.z, 0u) +
             __vsadu4(w.w, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < nr * row_bytes; i += kThreads) {
      acc += band[(i / row_bytes) * pitch + i % row_bytes];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    *slot = total;
  }
  cluster_arrive();
  cluster_wait();

  // the image's sum from the cluster's slots, then the mean and the bias in
  // the plain version's order; the matrix
  if (warp == 0) {
    unsigned long long total =
        lane < kCluster ? *cluster.map_shared_rank(slot, lane) : 0ull;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      total += __shfl_down_sync(0xffffffffu, total, off);
    }
    if (lane == 0) {
      const float n = static_cast<float>(row_bytes) * static_cast<float>(s);
      const float m0 = __fdiv_rn(
          __fdiv_rn(__ll2float_rn(static_cast<long long>(total)), n), 255.0f);
      coef[9] = bf16r(__fmul_rn(__fmul_rn(__fsub_rn(1.0f, fc[b]), fb[b]), m0));
    }
    // the matrix as bfloat16 pairs: rows 0 and 1 side by side (channels 0
    // and 1 in one word), then row 2 twice
    if (lane < 6) {
      const int i = lane % 3;
      const uint32_t lo = mat[b * 9 + (lane < 3 ? i : 6 + i)];
      const uint32_t hi = mat[b * 9 + (lane < 3 ? 3 + i : 6 + i)];
      coef[lane] = __uint_as_float(lo | hi << 16);
    }
  }
  __syncthreads();
  cluster_arrive();  // this block has read the slots; waited on at the end

  const float y0r = __frcp_rn(nm.s0), y1r = __frcp_rn(nm.s1),
              y2r = __frcp_rn(nm.s2);
  uint32_t m[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) m[i] = __float_as_uint(coef[i]);
  const uint32_t bias = __float_as_uint(coef[9]) >> 16;
  const uint32_t bias2 = bias | bias << 16;
  const uint32_t inv2 = __float_as_uint(nm.inv255) >> 16 |
                        (__float_as_uint(nm.inv255) & 0xffff0000u);
  const int entry = 8 * (hflip[b] != 0) + 4 * (vflip[b] != 0) +
                    (k[b * k_words] & 3);
  const int code = static_cast<int>((d4 >> (3 * entry)) & 7);
  const bool t = code & 1, fx = code & 2, fy = code & 4;

  // the output region the band maps to: ny rows of nx pixels from
  // (y0, x0); its pixel (iy, ix) reads the band's byte org + iy dy + ix dx
  const int ny = t ? s : nr, nx = t ? nr : s;
  const int y0 = t ? 0 : (fy ? s - r0 - nr : r0);
  const int x0 = t ? (fx ? s - r0 - nr : r0) : 0;
  const int uy = t ? 3 : pitch, ux = t ? pitch : 3;
  const int org = (fy ? (ny - 1) * uy : 0) + (fx ? (nx - 1) * ux : 0);
  const int dy = fy ? -uy : uy, dx = fx ? -ux : ux;
  // runs of up to kRun pixels of a region row, a lane a pixel; a warp
  // computes kRuns of them (2^lr along a row, times kRuns >> lr rows)
  // before it stores them
  const int runs = (nx + kRun - 1) / kRun;
  const int lr = runs >= 4 ? 2 : (runs >= 2 ? 1 : 0);
  const int rows_at_once = kRuns >> lr;
  float* bufw = bufs + warp * kRuns * kRun * 3;
  for (int iy0 = warp * rows_at_once; iy0 < ny;
       iy0 += kWarps * rows_at_once) {
    for (int ix0 = 0; ix0 < nx; ix0 += kRun << lr) {
#pragma unroll
      for (int q = 0; q < kRuns; ++q) {
        const int iy = iy0 + (q >> lr);
        const int ix = ix0 + ((q & ((1 << lr) - 1)) << 5) + lane;
        if (iy < ny && ix < nx) {
          const uint8_t* p = band + org + iy * dy + ix * dx;
          const uint32_t vr = bmul2(bf16x2_of_byte(p[0]), inv2);
          const uint32_t vg = bmul2(bf16x2_of_byte(p[1]), inv2);
          const uint32_t vb = bmul2(bf16x2_of_byte(p[2]), inv2);
          const uint32_t c01 = channels2(m, bias2, vr, vg, vb);
          const uint32_t c2 = channels2(m + 3, bias2, vr, vg, vb);
          float* o = bufw + (q * kRun + lane) * 3;
          o[0] = normalize(c01 << 16, nm.m0, nm.s0, y0r);
          o[1] = normalize(c01 & 0xffff0000u, nm.m1, nm.s1, y1r);
          o[2] = normalize(c2 << 16, nm.m2, nm.s2, y2r);
        }
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kRuns; ++q) {
        const int iy = iy0 + (q >> lr);
        const int ix = ix0 + ((q & ((1 << lr) - 1)) << 5);
        if (iy < ny && ix < nx) {
          const int n = min(kRun, nx - ix);
          const float* buf = bufw + q * kRun * 3;
          float* dst = out + ((static_cast<size_t>(b) * s + y0 + iy) * s +
                              x0 + ix) * 3;
          if (vec && (x0 + ix) % 4 == 0 && n % 4 == 0) {
            if (lane < 3 * n / 4) {
              reinterpret_cast<float4*>(dst)[lane] =
                  reinterpret_cast<const float4*>(buf)[lane];
            }
          } else {
            for (int i = lane; i < 3 * n; i += 32) dst[i] = buf[i];
          }
        }
      }
      __syncwarp();
    }
  }
  cluster_wait();
}

}  // namespace

// The largest S the kernel takes: its band of rows fits a block's shared
// memory.
extern "C" int hipac_augment_max_size() {
  int s = 1;
  while (smem_bytes(s + 1) <= kMaxSmem) ++s;
  return s;
}

// in: (batch, s, s, 3) uint8; hflip, vflip: (batch,) bool; k: (batch,)
// int32 (k_words = 1) or int64 (k_words = 2) in 0..3; d4: the packed table;
// mat: (batch, 3, 3) bfloat16; fb, fc: (batch,) float32; out: (batch, s, s,
// 3) float32. Returns a cudaError_t as int (0 = launched).
extern "C" int hipac_augment(const void* in, const void* hflip,
                             const void* vflip, const void* k, int k_words,
                             unsigned long long d4, const void* mat,
                             const void* fb, const void* fc, void* out,
                             long long batch, int s, float inv255, float m0,
                             float m1, float m2, float s0, float s1, float s2,
                             void* stream) {
  if (batch <= 0 || batch > 65535 || s <= 0 ||
      s > hipac_augment_max_size() || (k_words != 1 && k_words != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Norm nm{inv255, m0, m1, m2, s0, s1, s2};
  // one bulk copy a row: rows of whole 16-byte units from an aligned base
  const int bulk = (3 * s) % 16 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;
  const int vec = s % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int smem = smem_bytes(s);
  cudaError_t err = cudaFuncSetAttribute(
      augment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(batch * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, augment_kernel, static_cast<const uint8_t*>(in),
      static_cast<const uint8_t*>(hflip), static_cast<const uint8_t*>(vflip),
      static_cast<const int*>(k), k_words, d4,
      static_cast<const uint16_t*>(mat), static_cast<const float*>(fb),
      static_cast<const float*>(fc), static_cast<float*>(out), s, bulk, vec,
      nm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
