// Pieces the causal conv1d forward (conv1d.cu) and backward
// (conv1d_bwd.cu) share: a vector of V channels in registers, SiLU with
// the hardware's reciprocal, and the staging of a block's taps in shared
// memory.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

// V elements of T as 32-bit words in registers (a lone bf16 in the low
// half of one word), loaded and stored as one vector
template <typename T, int V>
struct Vec {
  static constexpr int kWords = (V * (int)sizeof(T) + 3) / 4;
  unsigned u[kWords];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (V * sizeof(T) == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      u[0] = v.x; u[1] = v.y; u[2] = v.z; u[3] = v.w;
    } else if constexpr (V * sizeof(T) == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      u[0] = v.x; u[1] = v.y;
    } else if constexpr (V * sizeof(T) == 4) {
      u[0] = *reinterpret_cast<const unsigned*>(p);
    } else {
      u[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }
  __device__ __forceinline__ void store(T* p) const {
    if constexpr (V * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
    } else if constexpr (V * sizeof(T) == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    } else if constexpr (V * sizeof(T) == 4) {
      *reinterpret_cast<unsigned*>(p) = u[0];
    } else {
      *reinterpret_cast<unsigned short*>(p) = (unsigned short)u[0];
    }
  }
  __device__ __forceinline__ float get(int e) const {
    if constexpr (std::is_same_v<T, float>) {
      return __uint_as_float(u[e]);
    } else {
      const unsigned w = u[e >> 1];
      return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
    }
  }
  // v rounded to T; bf16 pairs by one packed conversion each
  __device__ __forceinline__ void pack(const float (&v)[V]) {
    if constexpr (std::is_same_v<T, float>) {
#pragma unroll
      for (int e = 0; e < V; ++e) u[e] = __float_as_uint(v[e]);
    } else if constexpr (V == 1) {
      u[0] = __bfloat16_as_ushort(__float2bfloat16_rn(v[0]));
    } else {
#pragma unroll
      for (int q = 0; q < V / 2; ++q) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
        u[q] = (unsigned)__bfloat16_as_ushort(p.x) |
               ((unsigned)__bfloat16_as_ushort(p.y) << 16);
      }
    }
  }
};

// y * sigmoid(y) with the hardware's reciprocal: the IEEE division of
// repro::silu ends every element with a branch to its slow path, which
// keeps the compiler from interleaving elements; the result stays within
// the check's limits
__device__ __forceinline__ float silu(float y) {
  return __fmul_rn(y, __fdividef(1.0f, 1.0f + expf(-y)));
}

// a block's weights in shared memory, tap-major with one pad word per 32,
// so that the threads' reads of V neighbouring channels hit distinct banks
__host__ __device__ constexpr int padded(int c) { return c + (c >> 5); }

// n floats from src to shared dst (16-byte aligned) by a block of
// kThreads: 16-byte cp.async pieces where src is 16-byte aligned, the
// rest by element
template <int kThreads>
__device__ __forceinline__ void stage(float* dst, const float* src, int n,
                                      int tid) {
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    head = n / 4 * 4;
    for (int q = tid; q < n / 4; q += kThreads)
      repro::cp_async16(dst + 4 * q, src + 4 * q, 16);
  }
  for (int j = head + tid; j < n; j += kThreads) dst[j] = src[j];
}

}  // namespace
