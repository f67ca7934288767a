// One Mamba-2 decode token, fused: conv window shift, SiLU, softplus(dt),
// state update h' = h*exp(dt*A) + dt*B*x and readout y = C.h' + D*x.
//
// Replaces the TPU kernel mamba2_decode_fused_pallas
// (src/repro/kernels/decode_fused/kernel.py:66, body _m2_kernel :42).
//
// Bound on the H100: bytes.  Per token the [B,H,P,N] fp32 state is read
// and written once (about 21 MB at mamba2-2.7b's B=4, H=80, P=64, N=128,
// 10.5 MB at zamba2-2.7b's N=64), ~6.4 / ~3.3 us at 3.35 TB/s; the
// arithmetic is a few operations per state element.
//
// Design: the TPU kernel takes one batch row per grid step with the whole
// row in VMEM.  Here one block owns one (batch row, head), 320 blocks at
// B=4, all resident at once.  Streaming 3.35 TB/s needs megabytes in
// flight, so each thread first issues every load of its share of the
// block's [P, N] state tile as 16-byte vectors (N/16 of them: 8 at
// N=128, 4 at N=64; N is a template argument) and only then runs the conv
// step for the P x-channels of its head and the 2N B/C channels of its
// group, which the state loads do not wait for.  The conv step applies
// SiLU and the same round-trip through the input dtype as _m2_kernel :47,
// and keeps x, B and C in shared memory.  Exactly one block writes each
// channel of the new conv window: each head its own x-channels, and the
// first head of each group the group's B/C channels, so there is no race.
// Then each thread updates its vectors in registers, writes them once
// (neighbouring threads on neighbouring addresses), and the N/4 lanes
// that share a state row reduce C.h' with shuffles.  The state update
// uses rounded multiplies and adds in the reference's order
// (h*da + (dt*B)*x), so the new state matches the plain version without
// fused multiply-add differences.  The new window and state go to the
// caller's destination, a slot of the new cache when it gives one.
//
// Head-slice mode (a rank of a plan that splits ssm_heads): the launch
// covers Hl of the H heads, from head h0.  The state, y, dt_raw and the
// per-head parameters are the rank's ([B,Hl,P,N], [B,Hl,P], [B,Hl],
// [Hl]); the window, the token and the conv parameters are whole, read
// at the global channels of the rank's heads and their groups.  nconv is
// null there: the caller keeps its own even shard of the shifted window,
// which does not line up with the heads.  The unsharded call is h0 = 0,
// Hl = H.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 8;
constexpr int kMaxP = 64;   // state rows a block

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
m2_decode_kernel(const T* __restrict__ conv, const float* __restrict__ ssm,
                 const T* __restrict__ xbc, const float* __restrict__ w,
                 const float* __restrict__ cb, const float* __restrict__ dt_raw,
                 const float* __restrict__ dt_bias,
                 const float* __restrict__ A_log, const float* __restrict__ Dv,
                 T* __restrict__ y, T* __restrict__ nconv,
                 float* __restrict__ nssm, int H, int P, int G, int K,
                 int h0, int Hl) {
  constexpr int LPR = N / 4;                      // lanes a state row
  constexpr int KL = kMaxP * N / 4 / kThreads;    // vectors a thread
  static_assert(KL >= 1 && 32 % LPR == 0, "tile shapes");
  __shared__ float xs[kMaxP];   // conv+silu output of this head's x
  __shared__ float bsm[N];
  __shared__ float csm[N];

  const int tid = threadIdx.x;
  // hl: the head among this launch's Hl, h: among all H
  const int b = blockIdx.x / Hl, hl = blockIdx.x % Hl, h = h0 + hl;
  const size_t base = ((size_t)b * Hl + hl) * P * N;
  const int nv = P * LPR;                         // vectors in the tile

  // every state load of this thread, in flight before the conv step
  const float4* hs = reinterpret_cast<const float4*>(ssm + base);
  float4 hv[KL];
#pragma unroll
  for (int k = 0; k < KL; ++k) {
    const int f = tid + k * kThreads;
    if (f < nv) hv[k] = __ldcs(hs + f);
  }

  const int hpg = H / G, g = h / hpg;
  const int di = H * P;
  const int C = di + 2 * G * N;
  const T* conv_b = conv + (size_t)b * (K - 1) * C;
  T* nconv_b = nconv != nullptr ? nconv + (size_t)b * (K - 1) * C : nullptr;
  const bool bc_writer = (h % hpg) == 0 && nconv != nullptr;

  // conv step over this block's P + 2N channels
  for (int e = tid; e < P + 2 * N; e += kThreads) {
    int c;
    float* dst;
    bool write_window = nconv != nullptr;
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
    // the window (K-1 cached inputs, then this token's) times the taps,
    // summed in order; unrolled to kMaxK so nothing goes to local memory
    const T xt = xbc[(size_t)b * C + c];
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < K) {
        const float v = k < K - 1 ? repro::to_f32(conv_b[(size_t)k * C + c])
                                  : repro::to_f32(xt);
        acc = __fadd_rn(acc, __fmul_rn(v, w[c * K + k]));
      }
    }
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

  const float dt = repro::softplus(dt_raw[b * Hl + hl] + dt_bias[hl]);
  const float a = -expf(A_log[hl]);
  const float da = expf(dt * a);
  const float dskip = Dv[hl];
  float4* ho = reinterpret_cast<float4*>(nssm + base);
#pragma unroll
  for (int k = 0; k < KL; ++k) {
    const int f = tid + k * kThreads;
    const int p = f / LPR, n = (f % LPR) * 4;
    float part = 0.0f;
    float xp = 0.0f;
    if (f < nv) {
      xp = xs[p];
      // h * da + (dt * B) * x, rounded as the reference rounds it
      auto step = [&](float hval, int nn) {
        const float upd = __fmul_rn(__fmul_rn(dt, bsm[nn]), xp);
        return __fadd_rn(__fmul_rn(hval, da), upd);
      };
      float4 v;
      v.x = step(hv[k].x, n);
      v.y = step(hv[k].y, n + 1);
      v.z = step(hv[k].z, n + 2);
      v.w = step(hv[k].w, n + 3);
      part = fmaf(v.x, csm[n], part);
      part = fmaf(v.y, csm[n + 1], part);
      part = fmaf(v.z, csm[n + 2], part);
      part = fmaf(v.w, csm[n + 3], part);
      __stcs(ho + f, v);
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (f < nv && f % LPR == 0)
      y[((size_t)b * Hl + hl) * P + p] =
          repro::from_f32<T>(part + xp * dskip);
  }
}

template <typename T, int N>
cudaError_t launch(const void* conv, const void* ssm, const void* xbc,
                   const void* w, const void* cb, const void* dt_raw,
                   const void* dt_bias, const void* A_log, const void* D,
                   void* y, void* nconv, void* nssm, int B, int H, int P,
                   int G, int K, int h0, int Hl, cudaStream_t stream) {
  m2_decode_kernel<T, N><<<B * Hl, kThreads, 0, stream>>>(
      static_cast<const T*>(conv), static_cast<const float*>(ssm),
      static_cast<const T*>(xbc), static_cast<const float*>(w),
      static_cast<const float*>(cb), static_cast<const float*>(dt_raw),
      static_cast<const float*>(dt_bias), static_cast<const float*>(A_log),
      static_cast<const float*>(D), static_cast<T*>(y),
      static_cast<T*>(nconv), static_cast<float*>(nssm), H, P, G, K, h0,
      Hl);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* conv, const void* ssm, const void* xbc,
                     const void* w, const void* cb, const void* dt_raw,
                     const void* dt_bias, const void* A_log, const void* D,
                     void* y, void* nconv, void* nssm, int B, int H, int P,
                     int G, int N, int K, int h0, int Hl, cudaStream_t st) {
  switch (N) {
    case 16: return launch<T, 16>(conv, ssm, xbc, w, cb, dt_raw, dt_bias,
                                  A_log, D, y, nconv, nssm, B, H, P, G, K, h0,
                                  Hl, st);
    case 64: return launch<T, 64>(conv, ssm, xbc, w, cb, dt_raw, dt_bias,
                                  A_log, D, y, nconv, nssm, B, H, P, G, K, h0,
                                  Hl, st);
    case 128: return launch<T, 128>(conv, ssm, xbc, w, cb, dt_raw, dt_bias,
                                    A_log, D, y, nconv, nssm, B, H, P, G, K,
                                    h0, Hl, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// conv, nconv: [B,K-1,C] and xbc: [B,C] in one dtype (0 = float32,
// 1 = bfloat16), y: [B,H,P] in that dtype; ssm, nssm: [B,H,P,N] fp32,
// 16-byte aligned, N in {16, 64, 128}, P <= 64; w: [C,K], cb: [C],
// dt_raw: [B,H], dt_bias, A_log, D: [H], all fp32.  nconv and nssm may be
// views into a larger cache (a slot of a stacked leaf); they must not
// overlap conv and ssm.  Head-slice mode: heads h0 .. h0 + Hl - 1 of H,
// with ssm, nssm [B,Hl,P,N], y [B,Hl,P], dt_raw [B,Hl], dt_bias, A_log,
// D [Hl] and nconv null (no window written); h0 = 0, Hl = H otherwise.
extern "C" int repro_mamba2_decode_fwd(
    const void* conv, const void* ssm, const void* xbc, const void* w,
    const void* cb, const void* dt_raw, const void* dt_bias,
    const void* A_log, const void* D, void* y, void* nconv, void* nssm,
    int B, int H, int P, int G, int N, int K, int h0, int Hl, int dtype,
    void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G || K < 2 || K > kMaxK || P <= 0 ||
      P > kMaxP || h0 < 0 || Hl <= 0 || h0 + Hl > H ||
      (Hl < H && nconv != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? dispatch<float>(conv, ssm, xbc, w, cb, dt_raw, dt_bias,
                                   A_log, D, y, nconv, nssm, B, H, P, G, N, K,
                                   h0, Hl, st)
      : dtype == 1 ? dispatch<__nv_bfloat16>(conv, ssm, xbc, w, cb, dt_raw,
                                             dt_bias, A_log, D, y, nconv,
                                             nssm, B, H, P, G, N, K, h0, Hl,
                                             st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
