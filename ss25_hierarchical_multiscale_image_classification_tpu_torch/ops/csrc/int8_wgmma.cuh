// The Hopper mainloop shared by the int8 kernels (int8_conv.cu,
// int8_block.cu): warpgroup products `wgmma.mma_async.m64nNk32.s32.s8.s8`
// with the weights read by the tensor cores from shared memory, and the
// `mbarrier`, `cp.async` and bulk-copy pieces of the ring that feeds them.
//
// What bounds the kernels on this card: operations (1,979 TOP/s dense int8),
// reachable only through `wgmma`. The first design issued `mma.sync.m16n8k32`
// with A and B fragments loaded per warp by `ldmatrix` (four B loads per
// 32-byte K step in each warp) from one shared-memory buffer, and reached
// 9-12 % of the peak (PERF.md). Here one warpgroup (four warps) owns 64 output
// pixels by N channels: B is a matrix descriptor over a weight image that the
// host packs once in core-matrix order (pack_int8_kernel of ops/int8_conv.py;
// a core matrix is 8 channels by 16 bytes of K, stored as 128 contiguous
// bytes), so no B fragment passes a register; A stays in registers, loaded
// with one `ldmatrix.x4` per K step from the pixel-major patch (a tap of the
// kernel is the same tile shifted by whole pixels, so there is no im2col
// buffer) and double-buffered so that the load of step k + 1 runs under the
// product of step k. The accumulator layout per warp is the `mma.sync` C
// layout repeated along N.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "int8_mma.cuh"

namespace hipac_int8 {

// Bytes of one B tile (kN channels by 32 bytes of K) in the packed image:
// [channel / 8][K half of 16 bytes][channel % 8][16 bytes].
constexpr int kLbo = 128;  // between the two K halves of a core-matrix pair
constexpr int kSbo = 256;  // between two groups of 8 channels

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Matrix descriptor of a K-major operand without swizzle: start address,
// leading (K) and stride (channel group) byte offsets, all in 16-byte units.
// Adding bytes / 16 to the descriptor moves its start address.
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem) {
  return static_cast<uint64_t>((smem_u32(smem) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(kLbo >> 4) << 16) |
         (static_cast<uint64_t>(kSbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// The compiler does not know that a product reads and writes its registers
// after the instruction was issued: this keeps a register allocated, and its
// uses in order, up to the wait that ends the product.
__device__ __forceinline__ void keep(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void keep(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// D (64 x N, int32) (+)= A (64 x 32, int8, registers) * B (N x 32, int8,
// shared memory through `b_desc`). Warp w of the warpgroup holds rows 16w ..
// 16w + 15 with the fragment layouts of mma_s8 (int8_mma.cuh): a[0..3] as
// there, d[4 * nt + j] = c[j] of the 8-channel tile nt.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
      "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
      "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
      "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
      "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
      "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
      "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
      "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
      "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
      "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
      "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
      "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(accumulate));
}

// The K steps of 32 bytes of one warpgroup's 64 pixels: step s reads its A
// fragment at `a_lane + a_off[s]` (this lane's ldmatrix row address; `a_off`
// a table in shared memory) and its B tile at `b_desc` + s tiles of kN x 32
// bytes. kSteps is their number, or 0 for `steps` of them: only a loop that
// is unrolled in full lets the compiler keep two products in flight (around a
// loop it ends each product before the next ldmatrix). `fresh`: the first
// step overwrites the accumulators. On return every product has ended, but
// the compiler does not know it: wg_mma_finish() before the accumulators are
// read.
template <int kN, int kSteps>
__device__ __forceinline__ void wg_mma_steps(int (&acc)[kN / 2],
                                             const int8_t* a_lane,
                                             const int* a_off, int steps,
                                             uint64_t b_desc, bool fresh) {
  constexpr uint64_t kTile16 = kN * 32 / 16;  // a B tile in 16-byte units
  const int n = kSteps ? kSteps : steps;
  uint32_t af[2][4] = {};
  ldmatrix_x4(af[0], a_lane + a_off[0]);
  int accumulate = fresh ? 0 : 1;
#pragma unroll
  for (int s = 0; s < n; s += 2) {
    wgmma_fence();
    wgmma_s8(acc, af[0], b_desc + s * kTile16, accumulate);
    wgmma_commit();
    accumulate = 1;
    // the product of step s - 1 is over: its A registers take step s + 1's
    wgmma_wait<1>();
#pragma unroll
    for (int i = 0; i < 4; ++i) keep(af[1][i]);
    if (s + 1 < n) {
      ldmatrix_x4(af[1], a_lane + a_off[s + 1]);
      wgmma_fence();
      wgmma_s8(acc, af[1], b_desc + (s + 1) * kTile16, 1);
      wgmma_commit();
    }
    wgmma_wait<1>();
#pragma unroll
    for (int i = 0; i < 4; ++i) keep(af[0][i]);
    if (s + 2 < n) ldmatrix_x4(af[0], a_lane + a_off[s + 2]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    keep(af[0][i]);
    keep(af[1][i]);
  }
}

// After the last wg_mma_steps of a tile: the accumulators hold the sums.
template <int kRegs>
__device__ __forceinline__ void wg_mma_finish(int (&acc)[kRegs]) {
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kRegs; ++i) keep(acc[i]);
}

// ---- the ring: mbarriers, cp.async that reports to one, bulk copies ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(arrivals)
               : "memory");
}

// After the initialisations, before any thread or copy uses a barrier.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of bulk copies to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase of parity `parity` is complete. A wait that
// does not end (a phase that no copy completes) stops the kernel with an
// error that the next call reports, and not the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done, polls = 0;
  do {
    if (++polls > (1u << 22)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes from device memory to shared memory, or 16 zero bytes with
// `bytes` = 0 (nothing is read then); both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async_16_zfill(int8_t* dst, const int8_t* src,
                                                  int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// This thread arrives at the barrier once all its cp.async so far are done
// (an arrival counted in the barrier's initialisation).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from device memory to this block's shared memory; completes `bytes` of the
// barrier's announced total.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's ordinary shared-memory accesses with those of the
// asynchronous proxy (bulk copies, the tensor cores' operand reads).
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace hipac_int8
