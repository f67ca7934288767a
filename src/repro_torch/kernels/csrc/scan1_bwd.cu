// Backward of the Mamba-1 selective scan (S6) from a zero initial state,
// for training.
//
// Replaces no TPU kernel: the reference has no backward kernel for
// selective_scan_pallas (src/repro/kernels/scan1/kernel.py:52) and trains
// through its plain version.  The port launches a kernel for every CUDA
// tensor, so its gradient is a kernel too.
//
// Forward (scan1.cu): h_t = a_t h_{t-1} + dt_t x_t B_t with a_t =
// exp(dt_t A), y_t = C_t . h_t + D x_t, h_{-1} = 0.  With g_t the gradient
// of h_t (g_t = C_t dy_t + a_{t+1} g_{t+1}; the final state's gradient,
// when given, joins at the last step), walking time in reverse:
//   dx_t  = dt_t sum_n B_t g_t + D dy_t
//   ddt_t = sum_n (x_t B_t + A a_t h_{t-1}) g_t
//   dA    = sum_{b,t} dt_t a_t h_{t-1} g_t
//   dB_t  = sum_c dt_t x_t g_t,   dC_t = sum_c h_t dy_t
//   dD    = sum_{b,t} x_t dy_t
//
// Bound on the H100: the exponentials, one a_t per (step, channel,
// state), as the forward's (4.18e12 ex2 a second); at mamba-130m's
// training shape (B=8, S=2048, C=1536, N=16) 4.0e8 of them, 0.096 ms,
// over 0.075 ms of bytes.
//
// The simple form, right first.  A block owns one batch row and CB =
// 256 / N channels; thread (c, n) owns one state of one channel, so a
// channel's N states are N neighbouring lanes.  Two passes in one kernel:
//   1. forward over the whole sequence in chunks of kChunk steps,
//      storing h at each chunk's start in an fp32 scratch (the thread's
//      own values: it reads back only what it wrote);
//   2. the chunks in reverse: the chunk's h recomputed from its start
//      into shared memory, then its steps walked backwards with the
//      carried g.  Sums over the states (dx, ddt) are shuffles over the
//      channel's N lanes; sums over the block's channels (dB, dC) are
//      shuffles within a warp and then the warps' values in order from
//      shared memory, one partial a (step, block); dA and dD sum over the
//      steps in registers, one partial a batch row.
// A second kernel sums the partials in a fixed order (dB, dC over the
// channel blocks, dA, dD over the batch rows).  No atomics: every sum
// runs in one order, so two calls give the same bits.  Steps past S are
// zeros (dt = 0: a = 1, no input, no output), channels past C are zeros
// and never written.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;      // steps a chunk (scratch: h at its start)
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;

template <int N>
struct Scan1BwdSmem {
  static constexpr int CB = kThreads / N;   // channels a block
  float h[kChunk][kThreads];                // the chunk's recomputed h
  float x[kChunk][CB], dt[kChunk][CB], dy[kChunk][CB];
  float bm[kChunk][N], cm[kChunk][N];
  float dx[kChunk][CB], ddt[kChunk][CB];
  float red_b[kChunk][kWarps][N], red_c[kChunk][kWarps][N];
};

// one chunk's x, dt, dy of the block's channels and B, C into shared
// memory as fp32, zeros past S and C
template <typename T, int N>
__device__ __forceinline__ void load_chunk(Scan1BwdSmem<N>& sm, const T* x,
                                           const float* dt, const T* dy,
                                           const T* bm, const T* cm, int b,
                                           int t0, int c0, int S, int C) {
  constexpr int CB = Scan1BwdSmem<N>::CB;
  for (int e = threadIdx.x; e < kChunk * CB; e += kThreads) {
    const int t = e / CB, cl = e % CB, tt = t0 + t, c = c0 + cl;
    const bool ok = tt < S && c < C;
    const size_t at = ((size_t)b * S + tt) * C + c;
    sm.x[t][cl] = ok ? repro::to_f32(x[at]) : 0.0f;
    sm.dt[t][cl] = ok ? dt[at] : 0.0f;
    sm.dy[t][cl] = ok ? repro::to_f32(dy[at]) : 0.0f;
  }
  for (int e = threadIdx.x; e < kChunk * N; e += kThreads) {
    const int t = e / N, n = e % N, tt = t0 + t;
    const size_t at = ((size_t)b * S + tt) * N + n;
    sm.bm[t][n] = tt < S ? repro::to_f32(bm[at]) : 0.0f;
    sm.cm[t][n] = tt < S ? repro::to_f32(cm[at]) : 0.0f;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
scan1_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ bm,
                 const T* __restrict__ cm, const float* __restrict__ Dv,
                 const T* __restrict__ dy, const float* __restrict__ dfin,
                 float* __restrict__ hs, T* __restrict__ dx,
                 float* __restrict__ ddt, float* __restrict__ dA_part,
                 float* __restrict__ dD_part, float* __restrict__ dB_part,
                 float* __restrict__ dC_part, int S, int C) {
  using Sm = Scan1BwdSmem<N>;
  constexpr int CB = Sm::CB;
  extern __shared__ __align__(16) unsigned char scan1_bwd_smem[];
  Sm& sm = *reinterpret_cast<Sm*>(scan1_bwd_smem);
  const int blk = blockIdx.x, b = blockIdx.y, nblk = gridDim.x;
  const int tid = threadIdx.x, cl = tid / N, n = tid % N;
  const int warp = tid >> 5, lane = tid & 31;
  const int c0 = blk * CB, c = c0 + cl;
  const bool live = c < C;
  const int nch = (S + kChunk - 1) / kChunk;
  const float al2 = live ? A[(size_t)c * N + n] * kLog2e : 0.0f;
  const float a_nat = live ? A[(size_t)c * N + n] : 0.0f;
  const float dd = live ? Dv[c] : 0.0f;
  const size_t hrow = ((size_t)b * nch) * C * N + (size_t)c * N + n;

  // 1. forward: h at each chunk's start
  float h = 0.0f;
  for (int ch = 0; ch < nch; ++ch) {
    __syncthreads();
    load_chunk<T, N>(sm, x, dt, dy, bm, cm, b, ch * kChunk, c0, S, C);
    __syncthreads();
    if (live) hs[hrow + (size_t)ch * C * N] = h;
#pragma unroll 4
    for (int t = 0; t < kChunk; ++t) {
      const float d = sm.dt[t][cl];
      h = repro::exp2_approx(d * al2) * h + d * sm.x[t][cl] * sm.bm[t][n];
    }
  }

  // 2. the chunks in reverse
  float carry = (live && dfin != nullptr)
                    ? dfin[((size_t)b * C + c) * N + n] : 0.0f;
  float da_acc = 0.0f, dd_acc = 0.0f;
  for (int ch = nch - 1; ch >= 0; --ch) {
    const int t0 = ch * kChunk;
    __syncthreads();   // the last chunk's readers of the tiles are done
    load_chunk<T, N>(sm, x, dt, dy, bm, cm, b, t0, c0, S, C);
    __syncthreads();
    const float h0 = live ? hs[hrow + (size_t)ch * C * N] : 0.0f;
    float hh = h0;
#pragma unroll 4
    for (int t = 0; t < kChunk; ++t) {
      const float d = sm.dt[t][cl];
      hh = repro::exp2_approx(d * al2) * hh + d * sm.x[t][cl] * sm.bm[t][n];
      sm.h[t][tid] = hh;
    }
    for (int t = kChunk - 1; t >= 0; --t) {
      const float d = sm.dt[t][cl], xv = sm.x[t][cl], dyv = sm.dy[t][cl];
      const float hprev = t > 0 ? sm.h[t - 1][tid] : h0;
      const float a = repro::exp2_approx(d * al2);
      const float g = fmaf(sm.cm[t][n], dyv, carry);
      const float ga = a * hprev * g;
      float u = sm.bm[t][n] * g, v = a_nat * ga;
      float rb = d * xv * g, rc = sm.h[t][tid] * dyv;
      da_acc = fmaf(d, ga, da_acc);
      carry = a * g;
      // over the channel's N states
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1) {
        u += __shfl_xor_sync(0xffffffffu, u, off);
        v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      // over the warp's channels
#pragma unroll
      for (int off = N; off < 32; off <<= 1) {
        rb += __shfl_xor_sync(0xffffffffu, rb, off);
        rc += __shfl_xor_sync(0xffffffffu, rc, off);
      }
      if (lane < N) {
        sm.red_b[t][warp][n] = rb;
        sm.red_c[t][warp][n] = rc;
      }
      if (n == 0) {
        sm.dx[t][cl] = fmaf(d, u, dd * dyv);
        sm.ddt[t][cl] = fmaf(xv, u, v);
        dd_acc = fmaf(xv, dyv, dd_acc);
      }
    }
    __syncthreads();
    for (int e = tid; e < kChunk * CB; e += kThreads) {
      const int t = e / CB, k = e % CB, tt = t0 + t, cc = c0 + k;
      if (tt < S && cc < C) {
        const size_t at = ((size_t)b * S + tt) * C + cc;
        dx[at] = repro::from_f32<T>(sm.dx[t][k]);
        ddt[at] = sm.ddt[t][k];
      }
    }
    for (int e = tid; e < kChunk * N; e += kThreads) {
      const int t = e / N, k = e % N, tt = t0 + t;
      if (tt >= S) continue;
      float sb = 0.0f, sc = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sb += sm.red_b[t][w][k];
        sc += sm.red_c[t][w][k];
      }
      const size_t at = (((size_t)b * S + tt) * nblk + blk) * N + k;
      dB_part[at] = sb;
      dC_part[at] = sc;
    }
  }
  if (live) {
    dA_part[((size_t)b * C + c) * N + n] = da_acc;
    if (n == 0) dD_part[(size_t)b * C + c] = dd_acc;
  }
}

// the partials summed in a fixed order: dB, dC over the channel blocks,
// dA, dD over the batch rows
template <typename T, int N>
__global__ void scan1_bwd_finish(const float* __restrict__ dA_part,
                                 const float* __restrict__ dD_part,
                                 const float* __restrict__ dB_part,
                                 const float* __restrict__ dC_part,
                                 float* __restrict__ dA,
                                 float* __restrict__ dD, T* __restrict__ dB,
                                 T* __restrict__ dC, int B, int S, int C,
                                 int nblk) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long rows = (long long)B * S * N;
  if (i < rows) {
    const long long bt = i / N;
    const int n = (int)(i % N);
    const float* pb = dB_part + bt * nblk * N + n;
    const float* pc = dC_part + bt * nblk * N + n;
    float sb = 0.0f, sc = 0.0f;
    for (int k = 0; k < nblk; ++k) {
      sb += pb[(size_t)k * N];
      sc += pc[(size_t)k * N];
    }
    dB[i] = repro::from_f32<T>(sb);
    dC[i] = repro::from_f32<T>(sc);
  }
  if (i < (long long)C * N) {
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s += dA_part[(size_t)b * C * N + i];
    dA[i] = s;
  }
  if (i < C) {
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s += dD_part[(size_t)b * C + i];
    dD[i] = s;
  }
}

template <typename T, int N>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* bm, const void* cm, const void* D,
                   const void* dy, const void* dfin, void* scratch, void* dx,
                   void* ddt, void* dA, void* dB, void* dC, void* dD, int B,
                   int S, int C, cudaStream_t st) {
  using Sm = Scan1BwdSmem<N>;
  constexpr int CB = Sm::CB;
  const int nblk = (C + CB - 1) / CB;
  const int nch = (S + kChunk - 1) / kChunk;
  // scratch (scan1/ops.py mirrors it: scan1_bwd_plan): hs [B,nch,C,N],
  // dA [B,C,N], dD [B,C], dB and dC [B,S,nblk,N] partials
  float* hs = static_cast<float*>(scratch);
  float* pa = hs + (size_t)B * nch * C * N;
  float* pd = pa + (size_t)B * C * N;
  float* pb = pd + (size_t)B * C;
  float* pc = pb + (size_t)B * S * nblk * N;
  static const cudaError_t attr = cudaFuncSetAttribute(
      scan1_bwd_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Sm));
  if (attr != cudaSuccess) return attr;
  scan1_bwd_kernel<T, N><<<dim3(nblk, B), kThreads, sizeof(Sm), st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(D),
      static_cast<const T*>(dy), static_cast<const float*>(dfin), hs,
      static_cast<T*>(dx), static_cast<float*>(ddt), pa, pd, pb, pc, S, C);
  long long jobs = (long long)B * S * N;
  if ((long long)C * N > jobs) jobs = (long long)C * N;
  scan1_bwd_finish<T, N><<<(unsigned)((jobs + 255) / 256), 256, 0, st>>>(
      pa, pd, pb, pc, static_cast<float*>(dA), static_cast<float*>(dD),
      static_cast<T*>(dB), static_cast<T*>(dC), B, S, C, nblk);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx: [B,S,C]; bm, cm, dB, dC: [B,S,N] (dtype 0 = float32, 1 =
// bfloat16, shared by them); dt, ddt: [B,S,C], A, dA: [C,N], D, dD: [C],
// dfin: [B,C,N] or null (the final state's gradient), all fp32 and all
// contiguous.  scratch: fp32, B*(nch*C*N + C*N + C + 2*S*nblk*N)
// elements, nch = ceil(S / 32), nblk = ceil(C / (256 / N)).  N = 8 or 16.
extern "C" int repro_scan1_bwd(const void* x, const void* dt, const void* A,
                               const void* bm, const void* cm, const void* D,
                               const void* dy, const void* dfin,
                               void* scratch, void* dx, void* ddt, void* dA,
                               void* dB, void* dC, void* dD, int B, int S,
                               int C, int N, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto tag, auto n) {
    using T = decltype(tag);
    return (int)launch<T, decltype(n)::value>(x, dt, A, bm, cm, D, dy, dfin,
                                              scratch, dx, ddt, dA, dB, dC,
                                              dD, B, S, C, st);
  };
  using N8 = std::integral_constant<int, 8>;
  using N16 = std::integral_constant<int, 16>;
  if (dtype == 0 && N == 8) return go(float{}, N8{});
  if (dtype == 0 && N == 16) return go(float{}, N16{});
  if (dtype == 1 && N == 8) return go(__nv_bfloat16{}, N8{});
  if (dtype == 1 && N == 16) return go(__nv_bfloat16{}, N16{});
  return (int)cudaErrorInvalidValue;
}
