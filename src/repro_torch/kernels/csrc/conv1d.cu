// Causal depthwise conv1d with bias and SiLU, for Mamba-2 prefill.
//
// Replaces the TPU kernel causal_conv1d_pallas
// (src/repro/kernels/conv1d/kernel.py:37, body _conv_kernel :16).
//
// Bound on the H100: bytes.  Each output does K multiply-adds and reads
// one input, so the work is a stream of x in and y out (about 22 MB at
// mamba2-2.7b's B=4, S=256, C=5376 in bf16, ~6.6 us at 3.35 TB/s).
//
// Design: the TPU kernel walks the sequence in order and carries the K-1
// halo rows in scratch from one block to the next.  Blocks here run in
// no order, so nothing is carried: each block covers (channel tile,
// sequence tile, batch row) and reads its own K-1 halo rows, from x or,
// for the first tile, from initial_state.  One thread per channel walks
// its rows with the last K-1 inputs in registers, so each input is read
// from memory once (plus K-1 halo rows per tile of TS rows).  Neighbouring
// threads hold neighbouring channels, so each row's loads and stores are
// coalesced.  Taps accumulate in fp32 in the reference's order
// (i = 0 .. K-1 from zero, then the bias) with rounded multiplies and adds,
// so no fused multiply-add changes the sum.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kRows = 64;       // sequence rows per block

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
conv1d_kernel(const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, const T* __restrict__ init,
              T* __restrict__ y, int S, int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int s0 = blockIdx.y * kRows;
  const int b = blockIdx.z;
  const T* xb = x + (size_t)b * S * C;
  const T* ib = init + (size_t)b * (K - 1) * C;
  T* yb = y + (size_t)b * S * C;

  float wk[K];
#pragma unroll
  for (int i = 0; i < K; ++i) wk[i] = w[c * K + i];
  const float bc = bias[c];

  // window[i] holds input row (t - (K-1) + i) for the row t being produced
  float win[K];
#pragma unroll
  for (int i = 0; i < K - 1; ++i) {
    const int r = s0 - (K - 1) + i;
    win[i] = r >= 0 ? repro::to_f32(xb[(size_t)r * C + c])
                    : repro::to_f32(ib[(size_t)(r + K - 1) * C + c]);
  }
  const int s1 = min(s0 + kRows, S);
  for (int t = s0; t < s1; ++t) {
    win[K - 1] = repro::to_f32(xb[(size_t)t * C + c]);
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < K; ++i) acc = __fadd_rn(acc, __fmul_rn(win[i], wk[i]));
    acc = __fadd_rn(acc, bc);
    yb[(size_t)t * C + c] = repro::from_f32<T>(repro::silu(acc));
#pragma unroll
    for (int i = 0; i < K - 1; ++i) win[i] = win[i + 1];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b,
                   const void* init, void* y, int B, int S, int C, int K,
                   cudaStream_t stream) {
  dim3 grid((C + kThreads - 1) / kThreads, (S + kRows - 1) / kRows, B);
  auto args = [&](auto kern) {
    kern<<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<const T*>(init),
        static_cast<T*>(y), S, C);
  };
  switch (K) {
    case 2: args(conv1d_kernel<T, 2>); break;
    case 3: args(conv1d_kernel<T, 3>); break;
    case 4: args(conv1d_kernel<T, 4>); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x, y: [B,S,C] (dtype 0 = float32, 1 = bfloat16); w: [C,K] fp32;
// b: [C] fp32; init: [B,K-1,C] in x's dtype.
extern "C" int repro_conv1d_fwd(const void* x, const void* w, const void* b,
                                const void* init, void* y, int B, int S,
                                int C, int K, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0
      ? launch<float>(x, w, b, init, y, B, S, C, K, st)
      : dtype == 1 ? launch<__nv_bfloat16>(x, w, b, init, y, B, S, C, K, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
