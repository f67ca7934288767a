// Mamba-1 selective scan (S6), for prefill.
//
// Replaces the TPU kernel selective_scan_pallas
// (src/repro/kernels/scan1/kernel.py:52, body _scan_kernel :23).
//
// Per step t and channel c, for the N states n of that channel:
//   h[c,n] = h[c,n] * exp(dt[t,c] * A[c,n]) + (dt[t,c] * x[t,c]) * B[t,n]
//   y[t,c] = sum_n C[t,n] * h[c,n] + D[c] * x[t,c]
//
// Bound on the H100: the exponentials.  One exp(dt * A) per (step,
// channel, state) runs as one ex2 on the special-function units, which
// issue 16 a clock per SM: 4.18e12 a second over 132 SMs at 1.98 GHz.
// At mamba-130m's B=4, S=256, C=1536, N=16 that is 25.2 M, 6.0 us,
// against 13.5 MB of bytes, 4.0 us at 3.35 TB/s; at B=1, S=16384, 402.7
// M, 96 us, against 60 us.  So exp(dt * A) is computed once per (step,
// channel, state) and never again, and every other operation (about six
// multiply-adds per exponential) has to fit in the issue slots the
// exponentials leave.
//
// Design: parallel in time inside a warp, the state carried from one
// tile of steps to the next.  A warp owns one channel of a batch row;
// lane l owns the K consecutive steps l*K .. l*K + K - 1 of a tile of
// 32 K steps.  For each state, in groups of G:
//   1. the lane computes its K pairs (a, b) = (ex2(dt * A * log2 e),
//      dt * x * B) in registers and folds them into one map h -> a h + b;
//   2. five shuffle levels give the warp's inclusive scan of those maps
//      under (a1, b1) then (a2, b2) = (a1 a2, a2 b1 + b2);
//   3. the map of lanes 0..l applied to the carried state gives h at the
//      end of lane l's run; lane l - 1's is where lane l's run starts,
//      and lane 31's is the next tile's carry;
//   4. the lane walks its K steps again from the registers (multiply-
//      adds only) and adds C[t,n] h_t into K y partials.
// The only chain from tile to tile is the carry; a lane has K G
// exponentials in flight.  A warp's carries and A * log2 e sit one per
// lane (lane g holds state g's) and are broadcast by shuffles.
//
// Staging: x and dt are channel-contiguous, so a block takes CT
// channels of one batch row and stages each tile of x and dt
// ([32 K steps x CT channels]) and of B and C ([32 K x N], shared by
// every channel of the block) into shared memory with 8- and 16-byte
// cp.async, issued as soon as the last tile's B and C are cooked, so the
// next tile loads while this one is scanned.  B and C are then copied
// into runs of K rows padded by one word (see Layout), where the 32
// lanes' reads of a state pair never share a bank.  Each warp's y
// values go to shared memory; after the tile D * x is added and y is
// written a row (CT channels) a thread.  Steps past S are zero (dt = 0:
// exp = 1, no input), so they leave the state as it is; channels past C
// are zero and never written.  The final state goes to ``fin`` (which
// may be ``init``: each warp reads its states before it writes them).
// The launch plan (K, CT, G) comes from scan1_plan in
// kernels/scan1/ops.py.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 8 bytes global -> shared, asynchronously; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(src_bytes));
}

// Shared memory of one block.  x and dt of a tile arrive as rows (CT
// channels), two stages deep, each run of K rows (one lane's steps)
// followed by 16 bytes; B and C arrive as the tile's contiguous [32 K][N]
// rows and are copied ("cooked") into runs of K rows followed by one
// word, so the 32 lanes' reads of one state pair (a word) in their own
// runs fall in 32 banks.  The y values sit in runs of K rows of CT
// floats and one word, for the same reason.
template <typename T, int N, int K, int CT>
struct Layout {
  static constexpr int kWarps = CT;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTile = 32 * K;     // steps a tile
  static constexpr int kEsz = sizeof(T);
  // row bytes: x, dt, B and C
  static constexpr int kWX = CT * kEsz, kWD = CT * 4, kWB = N * kEsz;
  static constexpr int kPX = kWX < 16 ? kWX : 16;   // x's copy pieces
  static constexpr int kRunX = K * kWX + 16, kRunD = K * kWD + 16;
  static constexpr int kRunB = K * kWB / 4 + 1;     // words
  static constexpr int kRunY = K * CT + 1;          // words
  static constexpr int kOffX = 0;
  static constexpr int kOffD = kOffX + 32 * kRunX;
  static constexpr int kStage = kOffD + 32 * kRunD;
  static constexpr int kOffRawB = 2 * kStage;
  static constexpr int kOffRawC = kOffRawB + kTile * kWB;
  static constexpr int kOffB = kOffRawC + kTile * kWB;
  static constexpr int kOffC = kOffB + 128 * kRunB;
  static constexpr int kOffY = kOffC + 128 * kRunB;
  static constexpr int kBytes = kOffY + 128 * kRunY;
  static_assert(kWX % 8 == 0 && kWB % 16 == 0 && kWD % 16 == 0,
                "rows must be 8- or 16-byte pieces");
  static_assert((K * kWB / 4) % 32 == 0, "cooked runs must skew by a bank");
};

// rows t < rows of a tile (W bytes each, ld bytes apart from src) into
// shared memory at dst (each run of K rows followed by 16 bytes where
// RunPad), in P-byte pieces; zeros past ``rows`` and past ``valid``
// bytes of a row
template <int W, int P, int K, int Tile, int Threads, bool RunPad>
__device__ __forceinline__ void stage_rows(char* dst, const char* src,
                                           size_t ld, int rows, int valid,
                                           int tid) {
  constexpr int kPer = W / P, kPieces = Tile * kPer;
  static_assert(W % P == 0, "pieces must divide a row");
#pragma unroll
  for (int r = 0; r < (kPieces + Threads - 1) / Threads; ++r) {
    const int q = tid + r * Threads;
    if (kPieces % Threads && q >= kPieces) break;
    const int t = q / kPer, cb = (q % kPer) * P;
    const bool ok = t < rows && cb < valid;
    char* d = dst + cb + (RunPad ? (t / K) * (K * W + 16) + (t % K) * W
                                 : t * W);
    const char* s = ok ? src + (size_t)t * ld + cb : src;
    if constexpr (P == 16)
      repro::cp_async16(d, s, ok ? 16 : 0);
    else
      cp_async8(d, s, ok ? 8 : 0);
  }
}

// one row of CT elements, moved in 8-byte pieces (a row of x in shared
// memory and of y in global memory starts 8-byte aligned)
template <typename T, int CT>
struct Row {
  static_assert(CT * sizeof(T) % 8 == 0, "rows are 8-byte pieces");
  T v[CT];
  __device__ __forceinline__ void load(const char* p) {
#pragma unroll
    for (int k = 0; k < (int)(CT * sizeof(T) / 8); ++k)
      reinterpret_cast<uint2*>(v)[k] = reinterpret_cast<const uint2*>(p)[k];
  }
  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int k = 0; k < (int)(CT * sizeof(T) / 8); ++k)
      reinterpret_cast<uint2*>(p)[k] = reinterpret_cast<const uint2*>(v)[k];
  }
};

// G consecutive elements of a cooked row as floats (word-aligned)
template <typename T, int G>
__device__ __forceinline__ void load_g(const uint32_t* p, float (&v)[G]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int g = 0; g < G; ++g) v[g] = __uint_as_float(p[g]);
  } else {
#pragma unroll
    for (int g = 0; g < G; g += 2) {
      const float2 u = repro::unpack_bf16(p[g / 2]);
      v[g] = u.x;
      v[g + 1] = u.y;
    }
  }
}

template <typename T, int N, int K, int CT, int G, int MINB>
__global__ void __launch_bounds__(Layout<T, N, K, CT>::kThreads, MINB)
scan1_kernel(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bm,
             const T* __restrict__ Cm, const float* __restrict__ Dv,
             const float* init, T* __restrict__ y, float* fin, int S,
             int C, int ldc) {
  using L = Layout<T, N, K, CT>;
  constexpr int kT = L::kTile, kN = L::kThreads;
  constexpr int kRowW = L::kWB / 4;            // words of a B or C row
  static_assert(N % G == 0 && G % 2 == 0, "state groups must divide");
  extern __shared__ __align__(16) char smem[];

  const int tid = threadIdx.x, lane = tid & 31, j = tid >> 5;  // channel
  const int b = blockIdx.y, c0 = blockIdx.x * CT, c = c0 + j;
  const bool live = c < C;

  // lane g < N holds state g's carry and A * log2 e
  float hc = 0.0f, a2r = 0.0f;
  if (lane < N && live) {
    hc = init[((size_t)b * C + c) * N + lane];
    a2r = A[(size_t)c * N + lane] * kLog2e;
  }
  float dj[CT];                                // D of the block's channels
#pragma unroll
  for (int i = 0; i < CT; ++i) dj[i] = c0 + i < C ? Dv[c0 + i] : 0.0f;

  const char* xb = reinterpret_cast<const char*>(x + (size_t)b * S * ldc + c0);
  const char* db = reinterpret_cast<const char*>(dt + (size_t)b * S * ldc + c0);
  const char* bb = reinterpret_cast<const char*>(Bm + (size_t)b * S * N);
  const char* cb = reinterpret_cast<const char*>(Cm + (size_t)b * S * N);
  T* yb = y + (size_t)b * S * ldc + c0;
  const int xvalid = (ldc - c0) * L::kEsz, dvalid = (ldc - c0) * 4;
  const uint32_t* bw = reinterpret_cast<const uint32_t*>(smem + L::kOffB);
  const uint32_t* cw = reinterpret_cast<const uint32_t*>(smem + L::kOffC);

  // one tile: x and dt into stage s, B and C into their raw rows; zeros
  // past S and past the row's last channel
  auto stage = [&](int s, int t0) {
    char* st = smem + s * L::kStage;
    const int rows = min(kT, S - t0);
    stage_rows<L::kWX, L::kPX, K, kT, kN, true>(
        st + L::kOffX, xb + (size_t)t0 * ldc * L::kEsz,
        (size_t)ldc * L::kEsz, rows, xvalid, tid);
    stage_rows<L::kWD, 16, K, kT, kN, true>(
        st + L::kOffD, db + (size_t)t0 * ldc * 4, (size_t)ldc * 4, rows,
        dvalid, tid);
    stage_rows<L::kWB, 16, K, kT, kN, false>(
        smem + L::kOffRawB, bb + (size_t)t0 * L::kWB, L::kWB, rows, L::kWB,
        tid);
    stage_rows<L::kWB, 16, K, kT, kN, false>(
        smem + L::kOffRawC, cb + (size_t)t0 * L::kWB, L::kWB, rows, L::kWB,
        tid);
    repro::cp_async_commit();
  };

  // B and C of the tile that has landed, from their raw rows to the
  // cooked runs: word q to q + q / (K row words)
  auto cook = [&]() {
    const uint32_t* rb = reinterpret_cast<const uint32_t*>(smem + L::kOffRawB);
    const uint32_t* rc = reinterpret_cast<const uint32_t*>(smem + L::kOffRawC);
    uint32_t* ob = reinterpret_cast<uint32_t*>(smem + L::kOffB);
    uint32_t* oc = reinterpret_cast<uint32_t*>(smem + L::kOffC);
#pragma unroll
    for (int r = 0; r < kT * kRowW / kN; ++r) {
      const int q = tid + r * kN, o = q + q / (K * kRowW);
      ob[o] = rb[q];
      oc[o] = rc[q];
    }
  };

  // Two barriers a tile: after the scan (the y values are complete and
  // the next tile has landed), and after the y rows and the next tile's
  // cooking (its B and C are ready, and the stage and raw rows just read
  // are free for the tile after it, whose loads then start).
  const int tiles = (S + kT - 1) / kT;
  stage(0, 0);
  repro::cp_async_wait<0>();
  __syncthreads();
  cook();
  __syncthreads();
  if (tiles > 1) stage(1, kT);
  for (int it = 0; it < tiles; ++it) {
    const int t0 = it * kT;
    const char* st = smem + (it & 1) * L::kStage;

    float dtv[K], dtx[K], acc[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      dtv[i] = *reinterpret_cast<const float*>(
          st + L::kOffD + lane * L::kRunD + i * L::kWD + 4 * j);
      const float xv = repro::to_f32(*reinterpret_cast<const T*>(
          st + L::kOffX + lane * L::kRunX + i * L::kWX + L::kEsz * j));
      dtx[i] = dtv[i] * xv;
      acc[i] = 0.0f;
    }
    const uint32_t* brow = bw + lane * L::kRunB;
    const uint32_t* crow = cw + lane * L::kRunB;

#pragma unroll 1
    for (int g0 = 0; g0 < N; g0 += G) {
      float a[G][K], u[G][K], h[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float a2 = __shfl_sync(0xffffffffu, a2r, g0 + g);
#pragma unroll
        for (int i = 0; i < K; ++i) a[g][i] = ex2(dtv[i] * a2);
      }
#pragma unroll
      for (int i = 0; i < K; ++i) {
        float bv[G];
        load_g<T, G>(brow + i * kRowW + g0 * L::kEsz / 4, bv);
#pragma unroll
        for (int g = 0; g < G; ++g) u[g][i] = dtx[i] * bv[g];
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        // the lane's K steps as one map, then the warp's inclusive scan
        float pa = a[g][0], pb = u[g][0];
#pragma unroll
        for (int i = 1; i < K; ++i) {
          pb = fmaf(a[g][i], pb, u[g][i]);
          pa *= a[g][i];
        }
#pragma unroll
        for (int off = 1; off < 32; off *= 2) {
          const float qa = __shfl_up_sync(0xffffffffu, pa, off);
          const float qb = __shfl_up_sync(0xffffffffu, pb, off);
          if (lane >= off) {
            pb = fmaf(pa, qb, pb);
            pa *= qa;
          }
        }
        const float hin = __shfl_sync(0xffffffffu, hc, g0 + g);
        const float hend = fmaf(pa, hin, pb);
        const float hprev = __shfl_up_sync(0xffffffffu, hend, 1);
        const float carry = __shfl_sync(0xffffffffu, hend, 31);
        h[g] = lane == 0 ? hin : hprev;
        if (lane == g0 + g) hc = carry;
      }
      // the lane's steps again, from the registers
#pragma unroll
      for (int i = 0; i < K; ++i) {
        float cv[G];
        load_g<T, G>(crow + i * kRowW + g0 * L::kEsz / 4, cv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          h[g] = fmaf(a[g][i], h[g], u[g][i]);
          acc[i] = fmaf(cv[g], h[g], acc[i]);
        }
      }
    }

    float* yp = reinterpret_cast<float*>(smem + L::kOffY);
#pragma unroll
    for (int i = 0; i < K; ++i) yp[lane * L::kRunY + i * CT + j] = acc[i];
    if (it + 1 < tiles) repro::cp_async_wait<0>();
    __syncthreads();
    // y rows, a thread a row: C . h, then D * x
    const int rows = min(kT, S - t0);
    const float* ys = reinterpret_cast<const float*>(smem + L::kOffY);
    for (int t = tid; t < rows; t += kN) {
      const float* yr = ys + (t / K) * L::kRunY + (t % K) * CT;
      Row<T, CT> xr, out;
      xr.load(st + L::kOffX + (t / K) * L::kRunX + (t % K) * L::kWX);
#pragma unroll
      for (int jj = 0; jj < CT; ++jj)
        out.v[jj] = repro::from_f32<T>(yr[jj] + repro::to_f32(xr.v[jj]) * dj[jj]);
      T* dst = yb + (size_t)(t0 + t) * ldc;
      if (c0 + CT <= C) {
        out.store(dst);
      } else {
        for (int jj = 0; jj < C - c0; ++jj) dst[jj] = out.v[jj];
      }
    }
    if (it + 1 < tiles) cook();
    __syncthreads();
    if (it + 2 < tiles) stage(it & 1, t0 + 2 * kT);
  }
  if (lane < N && live) fin[((size_t)b * C + c) * N + lane] = hc;
}

template <typename T, int N, int K, int CT, int G, int MINB>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* D,
                   const void* init, void* y, void* fin, int B, int S, int C,
                   int ldc, cudaStream_t stream) {
  using L = Layout<T, N, K, CT>;
  auto kern = scan1_kernel<T, N, K, CT, G, MINB>;
  // once per instantiation, so a launch inside CUDA-graph capture makes
  // no configuration call
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid((ldc + CT - 1) / CT, B);
  kern<<<grid, L::kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(init), static_cast<T*>(y),
      static_cast<float*>(fin), S, C, ldc);
  return cudaGetLastError();
}

// the plans scan1_plan (kernels/scan1/ops.py) picks from, by index:
// (steps a lane K, channels a block CT, states a group G, blocks an SM
// the registers must allow)
template <typename T, int N>
cudaError_t launch_plan(int plan, const void* x, const void* dt,
                        const void* A, const void* Bm, const void* Cm,
                        const void* D, const void* init, void* y, void* fin,
                        int B, int S, int C, int ldc, cudaStream_t st) {
  switch (plan) {
    case 0:
      return launch<T, N, 8, 4, 2, 4>(x, dt, A, Bm, Cm, D, init, y, fin, B,
                                      S, C, ldc, st);
    case 1:
      return launch<T, N, 8, 8, 2, 2>(x, dt, A, Bm, Cm, D, init, y, fin, B,
                                      S, C, ldc, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: [B,S,ldc] (C channels live) and Bm, Cm: [B,S,N] in one dtype
// (0 = float32, 1 = bfloat16); dt: [B,S,ldc], A: [C,N], D: [C], init,
// fin: [B,C,N], fp32.  ldc is a multiple of 8 and every pointer 4-byte
// aligned; plan indexes launch_plan.
extern "C" int repro_scan1_fwd(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, const void* D,
                               const void* init, void* y, void* fin, int B,
                               int S, int C, int ldc, int N, int plan,
                               int dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || C <= 0 || ldc < C || ldc % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto tag, auto n) {
    using T = decltype(tag);
    return launch_plan<T, decltype(n)::value>(plan, x, dt, A, Bm, Cm, D,
                                              init, y, fin, B, S, C, ldc,
                                              st);
  };
  using N8 = std::integral_constant<int, 8>;
  using N16 = std::integral_constant<int, 16>;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = N == 8 ? go(float{}, N8{}) : N == 16 ? go(float{}, N16{}) : err;
  else if (dtype == 1)
    err = N == 8 ? go(__nv_bfloat16{}, N8{})
        : N == 16 ? go(__nv_bfloat16{}, N16{}) : err;
  return (int)err;
}
