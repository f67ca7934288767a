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
// row in VMEM.  Here a thread block cluster of kCluster blocks covers one
// batch row's channels, each block owning a tile of tc = di / kCluster
// channels (rounded up to 8).  x_proj reduces over every channel, so each
// block computes the conv step of its own channels only and its rows'
// share of the x_proj product, a partial sum of F = dt_rank + 2N floats,
// which it writes into its row of every block's shared memory (distributed
// shared memory); after one cluster barrier each block adds the kCluster
// rows in rank order, so all blocks hold the same bits of (dt_low, B, C),
// and no block reads another's memory, so none waits for the others to
// exit.  Each block then takes dt_proj and the state update for its own
// channels.  So x_proj and the conv inputs are read once per cluster, and
// the only traffic between blocks is kCluster x F floats.
//
// kHalves clusters per batch row split each tile's state: every one
// computes the tile's conv and x_proj partial, each then runs dt_proj and
// the state update for its part, so a block stages and updates half the
// state.
//
// After the conv step's few inputs, everything a block reads that does not
// depend on the conv output (its x_proj rows, state rows, A_log rows and
// dt_proj columns) is requested with cp.async, x_proj first, so those
// bytes are in flight while the conv step and the cluster barrier wait on
// their latencies.  The state update takes N neighbouring lanes per
// channel, reads and writes each state once, with every pass of the tile
// unrolled, and reduces C.h' with shuffles; the new conv window and state
// go to the caller's destinations.  The reference's
// dtype round trips are kept: the conv output, the x_proj output and the
// dt_proj output are rounded to the input type (kernel.py:114, :118,
// :124), and x_proj and dt_proj are read in the input type, as the
// reference's oracle reads them (ref.py:51, :55).  The state update uses
// rounded multiplies and adds in the oracle's order (h*dA + (dt*x)*B),
// so no fused multiply-add changes the new state.
#include "common.cuh"
#include "mma.cuh"

#include <cooperative_groups.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kCluster = 8;     // blocks per batch row (the portable most)
constexpr int kMaxTile = kThreads;   // channels per block: one thread each
constexpr int kMaxK = 4;      // conv taps
constexpr int kMaxF = 128;      // dt_rank + 2N
constexpr int kMaxRed = 2048;   // floats of partial sums: R * F, P * ts
constexpr int kSmemLimit = 232448;   // bytes of shared memory a block may use
constexpr int kHalves = 2;      // clusters per batch row (state split)

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

// rows x n elements of T from src (rows src_ld apart) to shared dst (16-byte
// aligned, rows dst_ld apart): 16-byte cp.async pieces where every source
// row starts 16-byte aligned, the rest by element.  Each thread takes one
// column of 16-byte pieces and walks the rows, so the loop divides once.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int dst_ld, const T* src,
                                      size_t src_ld, int rows, int n,
                                      int tid) {
  constexpr int kPer = 16 / sizeof(T);
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                   (src_ld * sizeof(T)) % 16 == 0 && dst_ld % kPer == 0;
  const int vecs = vec ? n / kPer : 0;        // per row
  if (vecs > kThreads) {                      // a row wider than the block
    for (int r = 0; r < rows; ++r)
      for (int v = tid; v < vecs; v += kThreads)
        repro::cp_async16(dst + r * dst_ld + v * kPer,
                          src + r * src_ld + v * kPer, 16);
  } else if (vecs > 0) {
    const int per = kThreads / vecs;          // rows a pass
    const int r0 = tid / vecs, v = tid - r0 * vecs;
    if (r0 < per)
      for (int r = r0; r < rows; r += per)
        repro::cp_async16(dst + r * dst_ld + v * kPer,
                          src + r * src_ld + v * kPer, 16);
  }
  const int head = vecs * kPer, rest = n - head;
  for (int e = tid; e < rows * rest; e += kThreads) {
    const int r = e / rest, i = head + e - r * rest;
    dst[r * dst_ld + i] = src[r * src_ld + i];
  }
}

// the block's shared memory, in floats, for a tile of tc channels whose
// state is split kHalves ways
struct Layout {
  int xp, dtp, h, al, xs, xd, dts, red, parts, proj, total_bytes;
  __host__ __device__ constexpr Layout(int tc, int F, int dtr, int N,
                                       int esz)
      : xp(0), dtp(0), h(0), al(0), xs(0), xd(0), dts(0), red(0), parts(0),
        proj(0), total_bytes(0) {
    auto up4 = [](int v) { return (v + 3) & ~3; };   // 16-byte aligned
    const int ts = tc / kHalves;
    dtp = xp + up4(tc * F * esz / 4 + 1);
    h = dtp + up4(dtr * ts * esz / 4 + 1);
    al = h + ts * N;
    xs = al + ts * N;
    xd = xs + up4(tc);
    dts = xd + up4(tc);
    red = dts + up4(tc);
    parts = red + kMaxRed;
    proj = parts + kCluster * kMaxF;
    total_bytes = (proj + kMaxF) * 4;
  }
};
// the widest tile, in fp32, at either d_state: every shape the entry point
// takes fits
static_assert(Layout(kMaxTile, kMaxF, kMaxF - 16, 8, 4).total_bytes <=
                  kSmemLimit &&
              Layout(kMaxTile, kMaxF, kMaxF - 32, 16, 4).total_bytes <=
                  kSmemLimit, "shared memory");

template <typename T, int N, int W>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
m1_decode_kernel(const T* __restrict__ conv, const float* __restrict__ ssm,
                 const T* __restrict__ xit, const float* __restrict__ w,
                 const float* __restrict__ cbias, const T* __restrict__ xp,
                 const T* __restrict__ dtp, const float* __restrict__ dt_bias,
                 const float* __restrict__ A_log, const float* __restrict__ Dv,
                 float* __restrict__ y, T* __restrict__ nconv,
                 float* __restrict__ nssm, int di, int dtr, int K, int tc) {
  static_assert(32 % N == 0, "N: 8 or 16");
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int F = dtr + 2 * N;
  const Layout L(tc, F, dtr, N, (int)sizeof(T));
  T* xps = reinterpret_cast<T*>(sm + L.xp);      // [tc][F]  x_proj rows
  T* dps = reinterpret_cast<T*>(sm + L.dtp);     // [dtr][tc]  dt_proj cols
  float* hs = sm + L.h;                          // [tc][N]  state rows
  float* als = sm + L.al;                        // [tc][N]  A_log rows
  float* xs = sm + L.xs;    // [tc]  conv + SiLU, in the input type
  float* xd = sm + L.xd;    // [tc]  xs * D
  float* dts = sm + L.dts;  // [tc]  softplus(dt)
  float* red = sm + L.red;  // partial sums inside the block
  float* parts = sm + L.parts;  // [kCluster][F]  every block's partial
  float* proj = sm + L.proj;    // [F]  (dt_low, B, C), the cluster's sum

  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y / kHalves, c0 = rank * tc;
  const int nc = max(0, min(tc, di - c0));       // this block's channels
  // the channels s0 .. s0 + ns of the tile whose state this block updates
  const int ts = tc / kHalves, s0 = blockIdx.y % kHalves * ts;
  const int ns = max(0, min(ts, nc - s0));

  // the conv step's inputs (one channel a thread) first, so that they do
  // not queue behind the staged bytes
  const int c = c0 + tid;
  T raw[kMaxK];                       // the window: K-1 old inputs, xt
  float wk[kMaxK], bc = 0.0f, dv = 0.0f, dtb = 0.0f;
  if (tid < nc) {
    const T* conv_b = conv + (size_t)b * (K - 1) * di;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < K - 1) raw[k] = conv_b[(size_t)k * di + c];
      else if (k == K - 1) raw[k] = xit[(size_t)b * di + c];
      if (k < K) wk[k] = w[c * K + k];
    }
    bc = cbias[c];
    dv = Dv[c];
  }
  if (tid < ns) dtb = dt_bias[c0 + s0 + tid];
  // then requests that do not wait on the conv step: x_proj first (the
  // next phase needs it), then the state, A_log and dt_proj rows
  stage(xps, 0, xp + (size_t)c0 * F, 0, 1, nc * F, tid);
  repro::cp_async_commit();
  stage(hs, 0, ssm + ((size_t)b * di + c0 + s0) * N, 0, 1, ns * N, tid);
  stage(als, 0, A_log + (size_t)(c0 + s0) * N, 0, 1, ns * N, tid);
  stage(dps, ts, dtp + c0 + s0, di, dtr, ns, tid);
  repro::cp_async_commit();
  // every block of the cluster has started (its shared memory may be
  // written) once this phase completes; waited on just before the
  // exchange
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // conv step of the tile's channels; the new window (once)
  if (tid < nc) {
    T* nconv_b = nconv + (size_t)b * (K - 1) * di;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K)
        acc = __fadd_rn(acc, __fmul_rn(repro::to_f32(raw[k]), wk[k]));
    acc = __fadd_rn(acc, bc);
    const float xv = repro::to_f32(repro::from_f32<T>(repro::silu(acc)));
    xs[tid] = xv;
    xd[tid] = __fmul_rn(xv, dv);
    if (s0 == 0) {
#pragma unroll
      for (int k = 0; k < kMaxK - 1; ++k)
        if (k < K - 1) nconv_b[(size_t)k * di + c] = raw[k + 1];
    }
  }
  repro::cp_async_wait<1>();
  __syncthreads();

  // the tile's share of xi @ x_proj: thread (r, g) sums columns
  // g*W .. g*W+W-1 over rows r, r + R, r + 2R, ...; then the R row groups
  // in order
  {
    const int V = F / W;
    const int R = kThreads / V;
    if (tid < R * V) {
      const int r0 = tid / V, g = tid % V;
      float acc[W];
#pragma unroll
      for (int q = 0; q < W; ++q) acc[q] = 0.0f;
#pragma unroll 4
      for (int i = r0; i < nc; i += R) {
        float v[W];
        load_vec<T, W>(xps + i * F + g * W, v);
        const float xv = xs[i];
#pragma unroll
        for (int q = 0; q < W; ++q) acc[q] = fmaf(xv, v[q], acc[q]);
      }
#pragma unroll
      for (int q = 0; q < W; ++q) red[r0 * F + g * W + q] = acc[q];
    }
    __syncthreads();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    // this block's partial into row `rank` of every block's parts
    for (int f = tid; f < F; f += kThreads) {
      float s = 0.0f;
      for (int r = 0; r < R; ++r) s += red[r * F + f];
#pragma unroll
      for (int q = 0; q < kCluster; ++q)
        cluster.map_shared_rank(parts, q)[rank * F + f] = s;
    }
  }
  // every block's partial, added in rank order, so each block holds the
  // same bits; past this barrier no block touches another's memory, so
  // none has to wait for the others before it exits
  cluster.sync();
  for (int f = tid; f < F; f += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) s += parts[q * F + f];
    proj[f] = repro::to_f32(repro::from_f32<T>(s));
  }
  repro::cp_async_wait<0>();
  __syncthreads();

  // dt = softplus(round(dt_low @ dt_proj) + dt_bias): part p of channel i
  // sums the ranks p, p + P, ...
  {
    const int P = kThreads / ts;
    if (tid < P * ts) {
      const int i = tid % ts, p = tid / ts;
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // four chains, then summed
      if (i < ns) {
        for (int r = p; r < dtr; r += 4 * P) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (r + q * P < dtr)
              s[q] = fmaf(proj[r + q * P],
                          repro::to_f32(dps[(r + q * P) * ts + i]), s[q]);
        }
      }
      red[p * ts + i] = (s[0] + s[1]) + (s[2] + s[3]);   // red is free again
    }
    __syncthreads();
    if (tid < ns) {
      float s = 0.0f;
      for (int p = 0; p < P; ++p) s += red[p * ts + tid];
      s = repro::to_f32(repro::from_f32<T>(s));
      dts[tid] = repro::softplus(s + dtb);
    }
    __syncthreads();
  }

  // state update and readout: N lanes per channel, every pass of the tile
  // unrolled so that the passes' exponentials and shuffles overlap
  constexpr int kPer = kThreads / N;              // channels a pass
  constexpr int kPasses = kMaxTile / kHalves / kPer;
  const int n = tid % N;
  const float bn = proj[dtr + n], cn = proj[dtr + N + n];
  float v[kPasses];
#pragma unroll
  for (int it = 0; it < kPasses; ++it) {
    const int i = it * kPer + tid / N;
    v[it] = 0.0f;
    if (i < ns) {                        // the same for the N lanes
      const float dt = dts[i];
      const float a = -expf(als[i * N + n]);
      const float da = expf(dt * a);
      const float hn = __fadd_rn(__fmul_rn(hs[i * N + n], da),
                                 __fmul_rn(__fmul_rn(dt, xs[s0 + i]), bn));
      nssm[((size_t)b * di + c0 + s0 + i) * N + n] = hn;
      v[it] = __fmul_rn(hn, cn);
    }
  }
#pragma unroll
  for (int it = 0; it < kPasses; ++it) {
    if (it * kPer < ns) {                // the same for the whole block
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        v[it] += __shfl_xor_sync(0xffffffffu, v[it], off);
      const int i = it * kPer + tid / N;
      if (i < ns && n == 0)
        y[(size_t)b * di + c0 + s0 + i] = __fadd_rn(v[it], xd[s0 + i]);
    }
  }
}

template <auto Kern>
using Kernel = std::integral_constant<decltype(Kern), Kern>;

// once per instance, so a launch inside CUDA-graph capture makes no
// configuration call
template <auto Kern>
cudaError_t allow_smem() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  return attr;
}

// channels per block: di over the cluster, rounded up to 8 so that each
// tile's x_proj rows start 16-byte aligned
int tile(int di) { return ((di + kCluster - 1) / kCluster + 7) / 8 * 8; }

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
  const int tc = tile(di);
  if (tc > kMaxTile) return cudaErrorInvalidValue;
  const int smem =
      Layout(tc, dtr + 2 * N, dtr, N, (int)sizeof(T)).total_bytes;
  dim3 grid(kCluster, B * kHalves);
  auto run = [&](auto tag) {
    constexpr auto kern = decltype(tag)::value;
    const cudaError_t attr = allow_smem<kern>();
    if (attr != cudaSuccess) return attr;
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(conv), static_cast<const float*>(ssm),
        static_cast<const T*>(xi), static_cast<const float*>(w),
        static_cast<const float*>(cb), static_cast<const T*>(xp),
        static_cast<const T*>(dtp), static_cast<const float*>(dt_bias),
        static_cast<const float*>(A_log), static_cast<const float*>(D),
        static_cast<float*>(y), static_cast<T*>(nconv),
        static_cast<float*>(nssm), di, dtr, K, tc);
    return cudaGetLastError();
  };
  auto with_n = [&](auto wtag) {
    constexpr int W = decltype(wtag)::value;
    switch (N) {
      case 8: return run(Kernel<m1_decode_kernel<T, 8, W>>{});
      case 16: return run(Kernel<m1_decode_kernel<T, 16, W>>{});
      default: return cudaErrorInvalidValue;
    }
  };
  switch (vec_width<T>(dtr + 2 * N)) {
    case 8: return with_n(std::integral_constant<int, 8>{});
    case 4: return with_n(std::integral_constant<int, 4>{});
    case 2: return with_n(std::integral_constant<int, 2>{});
    default: return with_n(std::integral_constant<int, 1>{});
  }
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
  if (B <= 0 || B > 65535 / kHalves || di <= 0 || dtr <= 0 || K < 2 ||
      K > kMaxK || dtr + 2 * N > kMaxF)
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
