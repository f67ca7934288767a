// One Mamba-2 decode token, fused: conv window shift, SiLU, softplus(dt),
// state update h' = h*exp(dt*A) + dt*B*x and readout y = C.h' + D*x.
//
// Replaces the TPU kernel mamba2_decode_fused_pallas
// (src/repro/kernels/decode_fused/kernel.py:66, body _m2_kernel :42).
//
// Bound on the H100: bytes.  Per token the [B,H,P,N] fp32 state is read
// and written once (about 21 MB at mamba2-2.7b's B=4, H=80, P=64, N=128),
// ~6.4 us per layer at 3.35 TB/s; the arithmetic is a few operations per
// state element.
//
// Design: the TPU kernel takes one batch row per grid step with the whole
// row in VMEM.  Here one block owns one (batch row, head), so 320 blocks
// stream the state at B=4.  The block first runs the conv step for the P
// x-channels of its head and the 2N B/C channels of its group, applies
// SiLU and the same round-trip through the input dtype as _m2_kernel :47,
// and keeps x, B and C in shared memory.  Then each warp walks state rows
// p: each lane reads h[p][n] for n = lane, lane+32, ..., updates it in
// registers, writes it back once (neighbouring lanes on neighbouring
// addresses), and the warp reduces C.h' over N with shuffles.  Exactly one
// block writes each channel of the new conv window: each head its own
// x-channels, and the first head of each group the group's B/C channels,
// so there is no race.  The state update uses rounded multiplies and adds
// in the reference's order (h*da + (dt*B)*x), so the new state matches the
// plain version without fused multiply-add differences.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
m2_decode_kernel(const T* __restrict__ conv, const float* __restrict__ ssm,
                 const T* __restrict__ xbc, const float* __restrict__ w,
                 const float* __restrict__ cb, const float* __restrict__ dt_raw,
                 const float* __restrict__ dt_bias,
                 const float* __restrict__ A_log, const float* __restrict__ Dv,
                 T* __restrict__ y, T* __restrict__ nconv,
                 float* __restrict__ nssm, int H, int P, int G, int N, int K) {
  extern __shared__ float sm[];
  float* xs = sm;          // [P]  conv+silu output of this head's x
  float* bsm = xs + P;     // [N]
  float* csm = bsm + N;    // [N]

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hpg = H / G, g = h / hpg;
  const int di = H * P;
  const int C = di + 2 * G * N;
  const T* conv_b = conv + (size_t)b * (K - 1) * C;
  T* nconv_b = nconv + (size_t)b * (K - 1) * C;
  const bool bc_writer = (h % hpg) == 0;

  // conv step over this block's P + 2N channels
  for (int e = tid; e < P + 2 * N; e += kThreads) {
    int c;
    float* dst;
    bool write_window = true;
    if (e < P) {
      c = h * P + e;
      dst = xs + e;
    } else if (e < P + N) {
      c = di + g * N + (e - P);
      dst = bsm + (e - P);
      write_window = bc_writer;
    } else {
      c = di + G * N + g * N + (e - P - N);
      dst = csm + (e - P - N);
      write_window = bc_writer;
    }
    float win[kMaxK];
    for (int k = 0; k < K - 1; ++k)
      win[k] = repro::to_f32(conv_b[(size_t)k * C + c]);
    const T xt = xbc[(size_t)b * C + c];
    win[K - 1] = repro::to_f32(xt);
    float acc = 0.0f;
    for (int k = 0; k < K; ++k)
      acc = __fadd_rn(acc, __fmul_rn(win[k], w[c * K + k]));
    acc = __fadd_rn(acc, cb[c]);
    // round-trip through the input dtype, as the reference does
    *dst = repro::to_f32(repro::from_f32<T>(repro::silu(acc)));
    if (write_window) {
      for (int k = 0; k < K - 2; ++k)
        nconv_b[(size_t)k * C + c] = conv_b[(size_t)(k + 1) * C + c];
      nconv_b[(size_t)(K - 2) * C + c] = xt;
    }
  }
  __syncthreads();

  const float dt = repro::softplus(dt_raw[b * H + h] + dt_bias[h]);
  const float a = -expf(A_log[h]);
  const float da = expf(dt * a);
  const float dskip = Dv[h];
  const size_t base = ((size_t)b * H + h) * P * N;
  const float* hs = ssm + base;
  float* ho = nssm + base;

  const int warp = tid / 32, lane = tid % 32;
  for (int p = warp; p < P; p += kThreads / 32) {
    const float xp = xs[p];
    float part = 0.0f;
    for (int n = lane; n < N; n += 32) {
      const float upd = __fmul_rn(__fmul_rn(dt, bsm[n]), xp);
      const float hn = __fadd_rn(__fmul_rn(hs[(size_t)p * N + n], da), upd);
      ho[(size_t)p * N + n] = hn;
      part = fmaf(hn, csm[n], part);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0)
      y[((size_t)b * H + h) * P + p] = repro::from_f32<T>(part + xp * dskip);
  }
}

template <typename T>
cudaError_t launch(const void* conv, const void* ssm, const void* xbc,
                   const void* w, const void* cb, const void* dt_raw,
                   const void* dt_bias, const void* A_log, const void* D,
                   void* y, void* nconv, void* nssm, int B, int H, int P,
                   int G, int N, int K, cudaStream_t stream) {
  const size_t bytes = (size_t)(P + 2 * N) * sizeof(float);
  m2_decode_kernel<T><<<B * H, kThreads, bytes, stream>>>(
      static_cast<const T*>(conv), static_cast<const float*>(ssm),
      static_cast<const T*>(xbc), static_cast<const float*>(w),
      static_cast<const float*>(cb), static_cast<const float*>(dt_raw),
      static_cast<const float*>(dt_bias), static_cast<const float*>(A_log),
      static_cast<const float*>(D), static_cast<T*>(y),
      static_cast<T*>(nconv), static_cast<float*>(nssm), H, P, G, N, K);
  return cudaGetLastError();
}

}  // namespace

// conv, nconv: [B,K-1,C] and xbc: [B,C] in one dtype (0 = float32,
// 1 = bfloat16), y: [B,H,P] in that dtype; ssm, nssm: [B,H,P,N] fp32;
// w: [C,K], cb: [C], dt_raw: [B,H], dt_bias, A_log, D: [H], all fp32.
extern "C" int repro_mamba2_decode_fwd(
    const void* conv, const void* ssm, const void* xbc, const void* w,
    const void* cb, const void* dt_raw, const void* dt_bias,
    const void* A_log, const void* D, void* y, void* nconv, void* nssm,
    int B, int H, int P, int G, int N, int K, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G || K < 2 || K > kMaxK ||
      (P + 2 * N) * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? launch<float>(conv, ssm, xbc, w, cb, dt_raw, dt_bias,
                                 A_log, D, y, nconv, nssm, B, H, P, G, N, K,
                                 st)
      : dtype == 1 ? launch<__nv_bfloat16>(conv, ssm, xbc, w, cb, dt_raw,
                                           dt_bias, A_log, D, y, nconv, nssm,
                                           B, H, P, G, N, K, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
