// One Mamba-1 decode token, fused: conv window shift and SiLU over the
// d_inner channels, the x_proj product (di -> dt_rank + 2N) that gives
// (dt_low, B, C), the dt_proj product (dt_rank -> di) with bias and
// softplus, the state update h' = h*exp(dt*A) + (dt*x)*B and the readout
// y = C.h' + D*x.
//
// Replaces the TPU kernel mamba1_decode_fused_pallas
// (src/repro/kernels/decode_fused/kernel.py:138, body _m1_kernel :110).
//
// Bound on the H100: bytes.  At mamba-130m's B=4, di=1536, N=16 the step
// reads and writes the [B,di,N] fp32 state (786 KB), reads x_proj and
// dt_proj once (393 KB in bf16) and the conv weights (31 KB): ~1.3 MB,
// ~0.4 us at 3.35 TB/s.  The arithmetic is ~1 MFLOP.
//
// Design: the TPU kernel takes one batch row per grid step with the whole
// row in VMEM.  One block per row would leave all but B of the 132 SMs
// idle, so the grid here is (channel tile of 128, batch row), 48 blocks
// at B=4.  x_proj reduces over every channel, so each block runs the
// conv step for all di channels (keeping the activations in shared
// memory) and the whole x_proj product itself, out of L2 after the first
// block.  That product is the block's largest read (245 KB at
// mamba-130m), so it is read in vectors of up to 16 bytes: W columns of
// one row per load, the threads laid out as [rows][dt_rank+2N / W] so a
// block's loads cover consecutive rows, with every thread's loads
// independent of each other; the row groups' partial sums are added in a
// fixed order.  Each block then takes dt_proj for its own channels only
// (two threads per channel, each half the rank) and updates its tile of
// the state: N neighbouring lanes own the N states of one channel, read
// and write them once, and reduce C.h' with shuffles.  Exactly one block
// writes each channel of the new conv window.  The reference's dtype
// round trips are kept: the conv output, the x_proj output and the
// dt_proj output are rounded to the input type (kernel.py:114, :118,
// :124), and x_proj and dt_proj are read in the input type, as the
// reference's oracle reads them (ref.py:51, :55).  The state update uses
// rounded multiplies and adds in the oracle's order (h*dA + (dt*x)*B),
// so no fused multiply-add changes the new state.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;      // state channels per block
constexpr int kParts = kThreads / kTile;   // threads per channel for dt_proj
constexpr int kMaxK = 4;      // conv taps
constexpr int kMaxF = 128;      // dt_rank + 2N
constexpr int kMaxRed = 2048;   // floats of x_proj partial sums: R * F

// W consecutive elements of T at p (aligned to W elements), loaded as one
// vector of W * sizeof(T) bytes and widened to fp32
template <typename T, int W>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[W]) {
  if constexpr (std::is_same_v<T, float>) {
    if constexpr (W == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    } else if constexpr (W == 2) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      out[0] = v.x; out[1] = v.y;
    } else {
      out[0] = *p;
    }
  } else {                             // bfloat16: two per 32-bit word
    if constexpr (W == 1) {
      out[0] = repro::to_f32(*p);
    } else {
      constexpr int kWords = W / 2;
      unsigned u[kWords];
      if constexpr (kWords == 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        u[0] = v.x; u[1] = v.y; u[2] = v.z; u[3] = v.w;
      } else if constexpr (kWords == 2) {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        u[0] = v.x; u[1] = v.y;
      } else {
        u[0] = *reinterpret_cast<const unsigned*>(p);
      }
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        out[2 * q] = __uint_as_float(u[q] << 16);
        out[2 * q + 1] = __uint_as_float(u[q] & 0xffff0000u);
      }
    }
  }
}

template <typename T, int N, int W>
__global__ void __launch_bounds__(kThreads)
m1_decode_kernel(const T* __restrict__ conv, const float* __restrict__ ssm,
                 const T* __restrict__ xit, const float* __restrict__ w,
                 const float* __restrict__ cbias, const T* __restrict__ xp,
                 const T* __restrict__ dtp, const float* __restrict__ dt_bias,
                 const float* __restrict__ A_log, const float* __restrict__ Dv,
                 float* __restrict__ y, T* __restrict__ nconv,
                 float* __restrict__ nssm, int di, int dtr, int K) {
  static_assert(32 % N == 0 && kTile % (kThreads / N) == 0, "N: 8 or 16");
  extern __shared__ float sm[];
  const int F = dtr + 2 * N;
  const int V = F / W;                // vectors per x_proj row
  const int R = kThreads / V;         // x_proj rows in flight per block
  float* xs = sm;                     // [di]  conv + SiLU, in the input type
  float* red = xs + di;               // [R][F]  x_proj partial sums
  float* proj = red + kMaxRed;        // [F]  (dt_low, B, C)
  float* dts = proj + kMaxF;          // [kTile]  softplus(dt) of the tile

  const int tid = threadIdx.x;
  const int b = blockIdx.y, c0 = blockIdx.x * kTile;
  const T* conv_b = conv + (size_t)b * (K - 1) * di;
  T* nconv_b = nconv + (size_t)b * (K - 1) * di;

  // conv step over every channel; the new window of this block's tile.
  // The taps are unrolled to kMaxK and predicated, so a thread's loads are
  // all in flight together.
#pragma unroll 6
  for (int c = tid; c < di; c += kThreads) {
    const T xt = xit[(size_t)b * di + c];
    T raw[kMaxK];                       // the window: K-1 old inputs, xt
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < K - 1) raw[k] = conv_b[(size_t)k * di + c];
      else if (k == K - 1) raw[k] = xt;
    }
    float wk[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) wk[k] = w[c * K + k];
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K)
        acc = __fadd_rn(acc, __fmul_rn(repro::to_f32(raw[k]), wk[k]));
    acc = __fadd_rn(acc, cbias[c]);
    xs[c] = repro::to_f32(repro::from_f32<T>(repro::silu(acc)));
    if (c >= c0 && c < c0 + kTile) {
#pragma unroll
      for (int k = 0; k < kMaxK - 1; ++k)
        if (k < K - 1) nconv_b[(size_t)k * di + c] = raw[k + 1];
    }
  }
  __syncthreads();

  // proj = xi @ x_proj: thread (r, g) sums columns g*W .. g*W+W-1 over
  // rows r, r + R, r + 2R, ...
  if (tid < R * V) {
    const int r0 = tid / V, g = tid % V;
    float acc[W];
#pragma unroll
    for (int q = 0; q < W; ++q) acc[q] = 0.0f;
    const T* col = xp + (size_t)g * W;
#pragma unroll 16
    for (int c = r0; c < di; c += R) {
      float v[W];
      load_vec<T, W>(col + (size_t)c * F, v);
      const float xv = xs[c];
#pragma unroll
      for (int q = 0; q < W; ++q) acc[q] = fmaf(xv, v[q], acc[q]);
    }
#pragma unroll
    for (int q = 0; q < W; ++q) red[r0 * F + g * W + q] = acc[q];
  }
  __syncthreads();
  for (int f = tid; f < F; f += kThreads) {
    float s = 0.0f;
    for (int r = 0; r < R; ++r) s += red[r * F + f];
    proj[f] = repro::to_f32(repro::from_f32<T>(s));
  }
  __syncthreads();

  // dt = softplus(round(dt_low @ dt_proj) + dt_bias) for the tile: part p
  // of channel i sums the ranks p, p + kParts, ...
  {
    const int i = tid % kTile, p = tid / kTile;
    const int c = c0 + i;
    float s = 0.0f;
    if (c < di) {
#pragma unroll 12
      for (int r = p; r < dtr; r += kParts)
        s = fmaf(proj[r], repro::to_f32(dtp[(size_t)r * di + c]), s);
    }
    red[p * kTile + i] = s;     // red is free again after the sync above
  }
  __syncthreads();
  for (int i = tid; i < kTile; i += kThreads) {
    float s = 0.0f;
    for (int p = 0; p < kParts; ++p) s += red[p * kTile + i];
    s = repro::to_f32(repro::from_f32<T>(s));
    if (c0 + i < di) dts[i] = repro::softplus(s + dt_bias[c0 + i]);
  }
  __syncthreads();

  // state update and readout: N lanes per channel
  constexpr int kPer = kThreads / N;
  constexpr int kIters = kTile / kPer;
  const int n = tid % N;
  const float bn = proj[dtr + n], cn = proj[dtr + N + n];
  float part[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = tid / N + it * kPer;
    const int c = c0 + i;
    part[it] = 0.0f;
    if (c < di) {                        // the same for the N lanes
      const float dt = dts[i];
      const float a = -expf(A_log[(size_t)c * N + n]);
      const float da = expf(dt * a);
      const size_t idx = ((size_t)b * di + c) * N + n;
      const float hn = __fadd_rn(__fmul_rn(ssm[idx], da),
                                 __fmul_rn(__fmul_rn(dt, xs[c]), bn));
      nssm[idx] = hn;
      part[it] = __fmul_rn(hn, cn);
    }
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    float v = part[it];
#pragma unroll
    for (int off = N / 2; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    const int c = c0 + tid / N + it * kPer;
    if (c < di && n == 0)
      y[(size_t)b * di + c] = __fadd_rn(v, __fmul_rn(xs[c], Dv[c]));
  }
}

size_t smem_bytes(int di) {
  return (size_t)(di + kMaxRed + kMaxF + kTile) * sizeof(float);
}

// the widest vector (up to 16 bytes) whose columns divide a row of F
template <typename T>
int vec_width(int F) {
  for (int wv = 16 / (int)sizeof(T); wv > 1; wv /= 2)
    if (F % wv == 0) return wv;
  return 1;
}

template <typename T>
cudaError_t launch(const void* conv, const void* ssm, const void* xi,
                   const void* w, const void* cb, const void* xp,
                   const void* dtp, const void* dt_bias, const void* A_log,
                   const void* D, void* y, void* nconv, void* nssm, int B,
                   int di, int N, int dtr, int K, cudaStream_t stream) {
  dim3 grid((di + kTile - 1) / kTile, B);
  auto run = [&](auto kern) {
    kern<<<grid, kThreads, smem_bytes(di), stream>>>(
        static_cast<const T*>(conv), static_cast<const float*>(ssm),
        static_cast<const T*>(xi), static_cast<const float*>(w),
        static_cast<const float*>(cb), static_cast<const T*>(xp),
        static_cast<const T*>(dtp), static_cast<const float*>(dt_bias),
        static_cast<const float*>(A_log), static_cast<const float*>(D),
        static_cast<float*>(y), static_cast<T*>(nconv),
        static_cast<float*>(nssm), di, dtr, K);
  };
  auto with_n = [&](auto wtag) {
    constexpr int W = decltype(wtag)::value;
    switch (N) {
      case 8: run(m1_decode_kernel<T, 8, W>); return cudaSuccess;
      case 16: run(m1_decode_kernel<T, 16, W>); return cudaSuccess;
      default: return cudaErrorInvalidValue;
    }
  };
  cudaError_t err;
  switch (vec_width<T>(dtr + 2 * N)) {
    case 8: err = with_n(std::integral_constant<int, 8>{}); break;
    case 4: err = with_n(std::integral_constant<int, 4>{}); break;
    case 2: err = with_n(std::integral_constant<int, 2>{}); break;
    default: err = with_n(std::integral_constant<int, 1>{}); break;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// conv, nconv: [B,K-1,di], xi: [B,di], x_proj: [di,dtr+2N] and
// dt_proj: [dtr,di] in one dtype (0 = float32, 1 = bfloat16); ssm, nssm:
// [B,di,N], w: [di,K], cb, dt_bias, D: [di], A_log: [di,N] and y: [B,di],
// all fp32.
extern "C" int repro_mamba1_decode_fwd(
    const void* conv, const void* ssm, const void* xi, const void* w,
    const void* cb, const void* xp, const void* dtp, const void* dt_bias,
    const void* A_log, const void* D, void* y, void* nconv, void* nssm,
    int B, int di, int N, int dtr, int K, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || di <= 0 || dtr <= 0 || K < 2 || K > kMaxK ||
      dtr + 2 * N > kMaxF || smem_bytes(di) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? launch<float>(conv, ssm, xi, w, cb, xp, dtp, dt_bias,
                                 A_log, D, y, nconv, nssm, B, di, N, dtr, K,
                                 st)
      : dtype == 1 ? launch<__nv_bfloat16>(conv, ssm, xi, w, cb, xp, dtp,
                                           dt_bias, A_log, D, y, nconv, nssm,
                                           B, di, N, dtr, K, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
