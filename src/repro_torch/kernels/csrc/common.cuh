// Shared helpers for the port's kernels: element loads and stores in the
// two storage types the kernels take (float32 and bfloat16), always
// computing in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// y * sigmoid(y), the reference's SiLU
__device__ __forceinline__ float silu(float y) {
  return __fmul_rn(y, 1.0f / (1.0f + expf(-y)));
}

// max(x, 0) + log1p(exp(-|x|)): jax.nn.softplus, without torch's threshold
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// 2^x in one instruction (MUFU.EX2, ~2^-22 relative; flushes to 0 below
// 2^-126; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace repro
