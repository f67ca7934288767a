// Backward of the causal depthwise conv1d with bias and SiLU, for
// training (no initial state: a training sequence starts from zeros).
//
// Replaces no TPU kernel: the reference has no backward kernel for
// causal_conv1d_pallas (src/repro/kernels/conv1d/kernel.py:37) and trains
// through its plain version.  The port launches a kernel for every CUDA
// tensor, so its gradient is a kernel too.
//
// With z = b + sum_i w_i x[t - K + 1 + i] and y = silu(z):
//   dz = dy * silu'(z) = dy * sig(z) * (1 + z * (1 - sig(z)))
//   dx[s] = sum_i dz[s + K - 1 - i] * w_i      (anti-causal correlation)
//   dw_i = sum_{b,t} dz[t] * x[t - K + 1 + i],  db = sum_{b,t} dz[t]
//
// Bound on the H100: bytes.  x and dy in, dx out (at zamba2-2.7b's
// training shape, B=4, S=2048, C=5248 in bf16, about 258 MB, ~77 us at
// 3.35 TB/s); the arithmetic is ~20 operations an element.
//
// Design: one thread owns one channel over a tile of 64 steps of one batch
// row and walks it in order, z recomputed from a register window of the
// last K inputs and dz kept in a window of the last K values, so each dx
// is emitted once the K dz it needs are known.  Neighbouring threads own
// neighbouring channels, so every row's loads and stores are coalesced.
// dw and db cross blocks (batch rows and tiles): each block writes its
// partial sums, and a second kernel adds them in tile order, so two calls
// give the same bits (no atomics).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;   // steps a thread walks

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
conv1d_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, const T* __restrict__ dy,
                  T* __restrict__ dx, float* __restrict__ part, int S, int C,
                  int tiles) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int tile = blockIdx.y, b = blockIdx.z;
  if (c >= C) return;
  const int s0 = tile * kTile, s1 = min(S, s0 + kTile);
  float wk[K];
#pragma unroll
  for (int i = 0; i < K; ++i) wk[i] = w[c * K + i];
  const float bc = bias[c];
  const T* xb = x + (size_t)b * S * C + c;
  const T* dyb = dy + (size_t)b * S * C + c;
  T* dxb = dx + (size_t)b * S * C + c;

  // xw[i] = x[t - K + 1 + i] once shifted at step t; dzw[j] = dz[t - K + 1 + j]
  float xw[K], dzw[K], dw[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int t = s0 - K + i;
    xw[i] = (i > 0 && t >= 0) ? repro::to_f32(xb[(size_t)t * C]) : 0.0f;
    dzw[i] = 0.0f;
    dw[i] = 0.0f;
  }
  float db = 0.0f;
  for (int t = s0; t <= s1 + K - 2; ++t) {
#pragma unroll
    for (int i = 0; i < K - 1; ++i) {
      xw[i] = xw[i + 1];
      dzw[i] = dzw[i + 1];
    }
    float dz = 0.0f;
    if (t < S) {
      xw[K - 1] = repro::to_f32(xb[(size_t)t * C]);
      // the forward's sum: taps in order from zero, then the bias
      float z = 0.0f;
#pragma unroll
      for (int i = 0; i < K; ++i) z = __fadd_rn(z, __fmul_rn(xw[i], wk[i]));
      z = __fadd_rn(z, bc);
      const float sg = 1.0f / (1.0f + expf(-z));
      dz = repro::to_f32(dyb[(size_t)t * C]) * sg * (1.0f + z * (1.0f - sg));
      if (t < s1) {
        db += dz;
#pragma unroll
        for (int i = 0; i < K; ++i) dw[i] = fmaf(dz, xw[i], dw[i]);
      }
    } else {
      xw[K - 1] = 0.0f;
    }
    dzw[K - 1] = dz;
    const int s = t - (K - 1);
    if (s >= s0 && s < s1) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < K; ++i) acc = fmaf(dzw[K - 1 - i], wk[i], acc);
      dxb[(size_t)s * C] = repro::from_f32<T>(acc);
    }
  }
  float* pp = part + ((size_t)(b * tiles + tile) * C + c) * (K + 1);
#pragma unroll
  for (int i = 0; i < K; ++i) pp[i] = dw[i];
  pp[K] = db;
}

// dw [C][K] and db [C]: each sum over the n partials in order
__global__ void conv1d_bwd_reduce(const float* __restrict__ part,
                                  float* __restrict__ dw,
                                  float* __restrict__ db, int n, int C,
                                  int K) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= C * (K + 1)) return;
  float s = 0.0f;
  for (int j = 0; j < n; ++j) s += part[(size_t)j * C * (K + 1) + e];
  const int c = e / (K + 1), i = e % (K + 1);
  if (i < K) dw[c * K + i] = s;
  else db[c] = s;
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* w, const void* b,
                   const void* dy, void* dx, void* dw, void* db, void* part,
                   int B, int S, int C, cudaStream_t st) {
  const int tiles = (S + kTile - 1) / kTile;
  dim3 grid((C + kThreads - 1) / kThreads, tiles, B);
  conv1d_bwd_kernel<T, K><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(part), S, C, tiles);
  const int n = C * (K + 1);
  conv1d_bwd_reduce<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw),
      static_cast<float*>(db), B * tiles, C, K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* b,
                     const void* dy, void* dx, void* dw, void* db, void* part,
                     int B, int S, int C, int K, cudaStream_t st) {
  switch (K) {
    case 2: return launch<T, 2>(x, w, b, dy, dx, dw, db, part, B, S, C, st);
    case 3: return launch<T, 3>(x, w, b, dy, dx, dw, db, part, B, S, C, st);
    case 4: return launch<T, 4>(x, w, b, dy, dx, dw, db, part, B, S, C, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, dy, dx: [B,S,C] (dtype 0 = float32, 1 = bfloat16); w: [C,K] fp32,
// b: [C] fp32; dw: [C,K] and db: [C] fp32; part: fp32 scratch of
// B * ceil(S / 64) * C * (K + 1) floats.  No initial state, SiLU.
extern "C" int repro_conv1d_bwd(const void* x, const void* w, const void* b,
                                const void* dy, void* dx, void* dw, void* db,
                                void* part, int B, int S, int C, int K,
                                int dtype, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? dispatch<float>(x, w, b, dy, dx, dw, db, part, B, S, C, K,
                                   st)
      : dtype == 1 ? dispatch<__nv_bfloat16>(x, w, b, dy, dx, dw, db, part,
                                             B, S, C, K, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
