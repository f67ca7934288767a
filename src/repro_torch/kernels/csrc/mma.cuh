// Warp-level tensor-core building blocks (sm_80 and later) shared by the
// port's mma.sync kernels: mma.sync m16n8k16 in bf16 with fp32
// accumulate, ldmatrix and movmatrix, cp.async, and bf16 packing,
// including the split of an fp32 pair into two bf16 terms.  Fragment
// layouts are PTX's: for lane t, gr = t / 4 and gc = 2 (t % 4); A (16 x 16,
// row-major) holds (gr, gc..gc+1), (gr+8, gc..), (gr, gc+8..),
// (gr+8, gc+8..); B (16 x 8, column-major) holds (gc..gc+1, gr) and
// (gc+8..gc+9, gr); the accumulator (16 x 8) holds (gr, gc..gc+1) and
// (gr+8, gc..gc+1).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8, and register i receives matrix i in the accumulator
// layout (.trans: its transpose)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* s) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* s) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the transpose of an 8x8 bf16 matrix held one pair a thread (row t/4,
// columns 2(t%4), 2(t%4)+1), in the same layout
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(src_bytes));
}
// 4 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(addr), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// (a, b) as two bf16 pairs whose sum is (a, b) to about 2^-17 of |a|,
// |b|: hi rounds each value, lo rounds what hi left out
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(a, b);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(a - h.x, b - h.y);
}

}  // namespace repro
