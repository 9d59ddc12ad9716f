// Shared pieces of the int8 kernels (int8_conv.cu, int8_block.cu): the
// tensor-core product of int8 tiles with int32 accumulation, and the float32
// requantization epilogue of models/quantized.py::_requant.
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
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
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

// round(y / s_out) clipped to +-127, as `torch.round(y / s_out).clamp(...)`:
// the IEEE quotient, rounded half to even. `inv_s` is __frcp_rn(s_out). The
// product y * inv_s is within 2 ulp of the quotient, so below 200 in size it
// is within 5e-5 of it and rounds to the same integer unless it lies that
// close to a half-integer; only there (within 1e-3, to be safe) is the
// quotient itself computed, which costs several times the product. At 200
// and above both clip to +-127.
__device__ __forceinline__ int requant(float y, float s_out, float inv_s) {
  float q = __fmul_rn(y, inv_s);
  if (fabsf(fabsf(q - floorf(q)) - 0.5f) < 1e-3f && fabsf(q) < 200.0f) {
    q = __fdiv_rn(y, s_out);
  }
  q = fminf(fmaxf(rintf(q), -127.0f), 127.0f);
  return static_cast<int>(q);
}

}  // namespace hipac_int8
