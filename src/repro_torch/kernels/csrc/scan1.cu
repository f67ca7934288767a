// Mamba-1 selective scan (S6), for prefill.
//
// Replaces the TPU kernel selective_scan_pallas
// (src/repro/kernels/scan1/kernel.py:52, body _scan_kernel :23).
//
// Per step t and channel c, for the N states n of that channel:
//   h[c,n] = h[c,n] * exp(dt[t,c] * A[c,n]) + (dt[t,c] * x[t,c]) * B[t,n]
//   y[t,c] = sum_n C[t,n] * h[c,n] + D[c] * x[t,c]
//
// Bound on the H100: bytes and exponentials.  At mamba-130m's B=4,
// S=256, C=1536, N=16 the scan moves about 13.5 MB (x and y in the
// input type, dt in fp32), ~4 us at 3.35 TB/s, and takes 25.2 M
// exponentials (one per state and step), ~6 us at the special-function
// units' rate; the multiply-adds are a few per exponential.
//
// Design: the TPU kernel walks sequence blocks along a sequential grid
// axis with the [block_ch, N] state in VMEM scratch.  Blocks here run in
// no order, so one block owns a tile of channels of one batch row and
// walks the whole sequence itself; nothing crosses blocks.  The state
// never leaves registers: L = N/2 neighbouring lanes own one channel, two
// states each, so a block of 128 threads holds 128/L channels (16 at
// N=16).  The sequence is walked in tiles of 32 steps: x and dt of the
// block's channels and B and C of the steps (shared by every channel) are
// staged in shared memory, and the next tile is fetched into registers
// while the current one is walked, so the loads overlap the recurrence.
// The walk over a tile is unrolled and has no branch and no shuffle: steps
// past S hold dt = 0 (exp = 1, no input), so they leave the state as it
// is.  The only chain from step to step is one multiply-add per state;
// exp(dt*A) (one ex2 with A scaled by log2(e) once) and the input term do
// not depend on the state, so the compiler can issue them ahead.  Each
// thread writes its partial readout C.h over its two states to shared
// memory; after the tile the L partials of each (step, channel) are added,
// D*x is added, and y is written row by row, neighbouring threads on
// neighbouring channels.  Any S and C are taken: the last tile and the
// channels past C are masked.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kR = 2;          // states per thread
constexpr int kTS = 32;        // sequence steps per tile
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
scan1_kernel(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bm,
             const T* __restrict__ Cm, const float* __restrict__ Dv,
             const float* __restrict__ init, T* __restrict__ y,
             float* __restrict__ final_state, int S, int C) {
  constexpr int L = N / kR;                  // lanes per channel
  constexpr int CT = kThreads / L;           // channels per block
  constexpr int XE = kTS * CT / kThreads;    // x, dt elements per thread
  constexpr int BE = kTS * N / kThreads;     // B, C elements per thread
  static_assert(L % 2 == 0 && 32 % L == 0, "N must be 8 or 16");
  static_assert(XE * kThreads == kTS * CT && BE * kThreads == kTS * N,
                "tile must divide among the threads");

  __shared__ float xs[kTS][CT];
  __shared__ float dts[kTS][CT];
  __shared__ __align__(16) float yp[kTS][kThreads];   // partial C.h
  __shared__ __align__(16) float bs[kTS][N];
  __shared__ __align__(16) float cs[kTS][N];
  __shared__ float ds[CT];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CT;
  const int j = tid / L;                     // channel within the tile
  const int n0 = (tid % L) * kR;             // first state of this thread
  const int c = c0 + j;
  const bool live = c < C;

  float h[kR], a2[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    h[r] = live ? init[((size_t)b * C + c) * N + n0 + r] : 0.0f;
    a2[r] = live ? A[(size_t)c * N + n0 + r] * kLog2e : 0.0f;
  }
  for (int i = tid; i < CT; i += kThreads)
    ds[i] = c0 + i < C ? Dv[c0 + i] : 0.0f;

  const T* xb = x + (size_t)b * S * C;
  const float* dtb = dt + (size_t)b * S * C;
  const T* bb = Bm + (size_t)b * S * N;
  const T* cb = Cm + (size_t)b * S * N;
  T* yb = y + (size_t)b * S * C;

  // the next tile, held in registers in the input type while the current
  // one is walked (converted only when staged, so nothing waits on the
  // loads before the walk); zeros past S and past C
  const T zero = repro::from_f32<T>(0.0f);
  T px[XE], pb[BE], pc[BE];
  float pdt[XE];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int e = 0; e < XE; ++e) {
      const int idx = tid + e * kThreads;
      const int t = t0 + idx / CT, cc = c0 + idx % CT;
      const bool ok = t < S && cc < C;
      px[e] = ok ? xb[(size_t)t * C + cc] : zero;
      pdt[e] = ok ? dtb[(size_t)t * C + cc] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < BE; ++e) {
      const int idx = tid + e * kThreads;
      const int t = t0 + idx / N;
      const bool ok = t < S;
      pb[e] = ok ? bb[(size_t)t * N + idx % N] : zero;
      pc[e] = ok ? cb[(size_t)t * N + idx % N] : zero;
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < S; t0 += kTS) {
#pragma unroll
    for (int e = 0; e < XE; ++e) {
      const int idx = tid + e * kThreads;
      xs[idx / CT][idx % CT] = repro::to_f32(px[e]);
      dts[idx / CT][idx % CT] = pdt[e];
    }
#pragma unroll
    for (int e = 0; e < BE; ++e) {
      const int idx = tid + e * kThreads;
      bs[idx / N][idx % N] = repro::to_f32(pb[e]);
      cs[idx / N][idx % N] = repro::to_f32(pc[e]);
    }
    __syncthreads();
    if (t0 + kTS < S) fetch(t0 + kTS);

#pragma unroll
    for (int i = 0; i < kTS; ++i) {
      const float dtv = dts[i][j];
      const float dtx = dtv * xs[i][j];
      float part = 0.0f;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        h[r] = fmaf(h[r], ex2(dtv * a2[r]), dtx * bs[i][n0 + r]);
        part = fmaf(h[r], cs[i][n0 + r], part);
      }
      yp[i][tid] = part;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < XE; ++e) {
      const int idx = tid + e * kThreads;
      const int i = idx / CT, jj = idx % CT;
      const int t = t0 + i, cc = c0 + jj;
      float sum = 0.0f;
#pragma unroll
      for (int l = 0; l < L; l += 2) {
        const float2 v = *reinterpret_cast<const float2*>(&yp[i][jj * L + l]);
        sum += v.x + v.y;
      }
      if (t < S && cc < C)
        yb[(size_t)t * C + cc] =
            repro::from_f32<T>(sum + xs[i][jj] * ds[jj]);
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < kR; ++r)
      final_state[((size_t)b * C + c) * N + n0 + r] = h[r];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* D,
                   const void* init, void* y, void* fin, int B, int S, int C,
                   int N, cudaStream_t stream) {
  auto run = [&](auto kern, int ct) {
    dim3 grid((C + ct - 1) / ct, B);
    kern<<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), static_cast<const float*>(D),
        static_cast<const float*>(init), static_cast<T*>(y),
        static_cast<float*>(fin), S, C);
  };
  switch (N) {
    case 8: run(scan1_kernel<T, 8>, kThreads / (8 / kR)); break;
    case 16: run(scan1_kernel<T, 16>, kThreads / (16 / kR)); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x, y: [B,S,C] and Bm, Cm: [B,S,N] in one dtype (0 = float32,
// 1 = bfloat16); dt: [B,S,C], A: [C,N], D: [C], init, fin: [B,C,N], fp32.
extern "C" int repro_scan1_fwd(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, const void* D,
                               const void* init, void* y, void* fin, int B,
                               int S, int C, int N, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? launch<float>(x, dt, A, Bm, Cm, D, init, y, fin, B, S, C,
                                 N, st)
      : dtype == 1 ? launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, init, y, fin,
                                           B, S, C, N, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
