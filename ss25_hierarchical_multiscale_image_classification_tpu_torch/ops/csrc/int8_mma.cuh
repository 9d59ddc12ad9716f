// Shared pieces of the int8 kernels (int8_conv.cu, int8_block.cu): the
// `mma.sync` product of int8 tiles with int32 accumulation (the stems; the
// warpgroup products are in int8_wgmma.cuh), and the float32 requantization
// epilogue of models/quantized.py::_requant.
//
// The epilogue is written with the explicitly rounded intrinsics so that nvcc
// contracts nothing into an FMA: the plain PyTorch version rounds after the
// multiply and again after the add, divides (IEEE quotient) by the output
// scale and rounds half to even, and the kernels equal it bit for bit.
// (`-use_fast_math` would replace the quotient; the build does not set it.)
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace hipac_int8 {

// D (16x8, int32) += A (16x32, int8, row) * B (32x8, int8, col). Thread
// (g = lane / 4, t = lane % 4) holds
//   a[0]: row g,   k 4t..4t+3      a[1]: row g+8, k 4t..4t+3
//   a[2]: row g,   k 16+4t..       a[3]: row g+8, k 16+4t..
//   b[0]: col g,   k 4t..4t+3      b[1]: col g,   k 16+4t..
//   c[0], c[1]: row g, cols 2t, 2t+1      c[2], c[3]: row g+8, same cols
// with c[j] = c[at + j] of the caller's accumulator array (`at` a
// compile-time constant after unrolling).
template <int kRegs>
__device__ __forceinline__ void mma_s8(int (&c)[kRegs], int at,
                                       const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[at]), "+r"(c[at + 1]), "+r"(c[at + 2]), "+r"(c[at + 3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 matrices of 16-bit cells (8 rows of 16 bytes each) from shared
// memory into fragments: lanes 8j..8j+7 give the row addresses of matrix j
// (16-byte aligned), and lane (g, t) receives bytes 4t..4t+3 of row g of each
// matrix, which is the int8 fragment layout of mma_s8 above. With rows
// 0-7 and 8-15 of a 16x32 int8 tile at k 0 and 16 the four results are
// a[0..3]; with rows n..n+7 of two 8-column weight tiles they are b[0..1] of
// both.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const int8_t* p) {
  const unsigned int addr =
      static_cast<unsigned int>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// 16 bytes from device memory to shared memory without passing registers;
// both addresses 16-byte aligned. Completed by cp_async_wait_all().
__device__ __forceinline__ void cp_async_16(int8_t* dst, const int8_t* src) {
  const unsigned int d =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t ld_global_u32(const int8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t ld_shared_u32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// int32 sum -> float32 (round to nearest even), times the dequantization
// scale, plus the bias: two roundings, as `y32.float() * mscale + bias`.
__device__ __forceinline__ float dequant(int acc, float mscale, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), mscale), bias);
}

// float32 of the int8 value whose byte, xor 0x80, is `biased` (0 .. 255):
// the byte becomes the low mantissa bits of 2^23, and 2^23 + 128 is taken
// off. Exact, and an add where a conversion instruction would run at an
// eighth of the float32 rate.
__device__ __forceinline__ float biased_byte_to_float(unsigned int biased) {
  return __fadd_rn(__uint_as_float(0x4B000000u | biased), -8388736.0f);
}

// The requantization round(relu?(y) / s_out) clipped to +-127, as
// `torch.round(torch.relu(y) / s_out).clamp(-127, 127)`: the IEEE quotient,
// rounded half to even, of kCount values at once. q[i] receives an int whose
// low byte is the int8 result (cast it to signed char). `inv_s` is
// __frcp_rn(s_out); `lo` is 0 with the ReLU (which the clip then includes,
// s_out being positive) and -127 without.
//
// Clipping comes first (the bounds are integers, so the order is free); the
// clipped value plus 1.5 * 2^23, where a float32 ulp is 1, rounds half to
// even as rintf does and carries the integer in its low mantissa bits, so no
// conversion instruction is spent (those run at an eighth of the float32
// rate). The product y * inv_s is within |q| * 2^-23 <= 1.6e-5 of the exact
// quotient and the IEEE quotient within 0.8e-5, so both round to the same
// integer unless the product lies within 2.4e-5 of a half-integer; within
// 2^-13 = 1.2e-4 of one, the group is done again with the quotient itself,
// which costs several times the product. One branch per group, not per
// value: a branch per value cut the epilogue into blocks too short to
// overlap anything and cost an eighth of the 16 convolutions' time
// (PERF.md).
constexpr float kUlpOne = 12582912.0f;          // 1.5 * 2^23
constexpr float kNearTie = 0.4998779296875f;    // 0.5 - 2^-13

template <int kCount>
__device__ __forceinline__ void requant_group(const float (&y)[kCount],
                                              float s_out, float inv_s,
                                              float lo, int (&q)[kCount]) {
  float t[kCount];
  float worst = 0.0f;  // the largest distance from the rounded value
#pragma unroll
  for (int i = 0; i < kCount; ++i) {
    const float c = fminf(fmaxf(__fmul_rn(y[i], inv_s), lo), 127.0f);
    t[i] = __fadd_rn(c, kUlpOne);
    worst = fmaxf(worst, fabsf(__fadd_rn(c, -__fadd_rn(t[i], -kUlpOne))));
  }
  if (worst > kNearTie) {
#pragma unroll
    for (int i = 0; i < kCount; ++i) {
      const float c = fminf(fmaxf(__fdiv_rn(y[i], s_out), lo), 127.0f);
      t[i] = __fadd_rn(c, kUlpOne);
    }
  }
#pragma unroll
  for (int i = 0; i < kCount; ++i) q[i] = __float_as_int(t[i]);
}

}  // namespace hipac_int8
