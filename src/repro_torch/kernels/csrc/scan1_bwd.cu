// Backward of the Mamba-1 selective scan (S6) from a zero initial state,
// for training.
//
// Replaces no TPU kernel: the reference has no backward kernel for
// selective_scan_pallas (src/repro/kernels/scan1/kernel.py:52) and trains
// through its plain version.  The port launches a kernel for every CUDA
// tensor, so its gradient is a kernel too.
//
// Forward (scan1.cu): h_t = a_t h_{t-1} + b_t with a_t = exp(dt_t A) and
// b_t = dt_t x_t B_t, y_t = C_t . h_t + D x_t, h_{-1} = 0.  With g_t the
// gradient of h_t (g_t = C_t dy_t + a_{t+1} g_{t+1}; the final state's
// gradient, when given, joins at the last step):
//   dx_t  = dt_t sum_n B_t g_t + D dy_t
//   ddt_t = x_t sum_n B_t g_t + sum_n A a_t h_{t-1} g_t
//   dA    = sum_{b,t} dt_t a_t h_{t-1} g_t
//   dB_t  = sum_c dt_t x_t g_t,   dC_t = sum_c h_t dy_t
//   dD    = sum_{b,t} x_t dy_t
//
// Bound on the H100: bytes (x, dt, dy read once, dx, ddt written once;
// dt and ddt in fp32) over the exponentials, one a_t per (step, channel,
// state) at 4.18e12 ex2 a second: at mamba-130m's training shape (B=8,
// S=2048, C=1536, N=16) 352 MB, 0.105 ms, over 4.0e8 ex2, 0.096 ms.
// In fact it is bound by its instruction rate: the backward pass's group
// loop runs about 36 instructions a (step, channel, state) (one
// exponential, about 17 fp32 operations, the rest loads, shuffles, stores
// and addresses; scripts/sass_loops.py), besides the block's dB / dC sum.
//
// Design: parallel in time, as the forward.  Lane l owns the K
// consecutive steps l*K .. l*K + K - 1 of a tile of 32 K steps of one
// channel of a batch row; the states are walked in groups of G, in
// registers, so the sums over a channel's states (dx, ddt) are register
// adds.  Three launches:
//   1. scan1_bwd_states, the forward's states only, two channels a warp
//      (B's loads shared by both): for each tile each lane folds its K
//      maps h -> a h + b, a five-level shuffle scan joins the lanes from
//      the carried state, and h where every lane's run starts goes to an
//      fp32 scratch [B, tiles, ldc, N, 32 lanes].  No y, no C.
//   2. scan1_bwd_kernel, a channel a warp, the tiles in reverse, one
//      exponential a (step, channel, state): for each group the lane
//      reads h where its run starts, computes its K G values a once,
//      folds the gradient's map c -> a (C dy + c) backward over its run
//      and joins the lanes with a suffix scan (__shfl_down_sync) from the
//      carry out of the tile above (seeded from the final state's
//      gradient), walks its run backwards once to hold each g_t, and
//      forwards once to form h_t and every contribution.  The only chain
//      from tile to tile is the gradient's carry.  dA sums in registers
//      over a lane's run, then over the warp by shuffles in a fixed order
//      (riding along with the next group's scan); dD likewise at the end.
//      dB and dC sum over the block's channels before they reach memory:
//      each warp's contributions of a group go to shared memory and the
//      block sums its warps in warp order: one fp32 partial a (step,
//      block).  (Two channels a warp, their sum in registers and two
//      contribution buffers, one barrier a group, ran slower at half the
//      warps an SM; a further sum over a thread-block cluster's blocks
//      through distributed shared memory, one cluster barrier a group,
//      cost more than the partials' traffic it saves.)
//   3. scan1_bwd_finish sums the partials in a fixed order: dB, dC over
//      the channel blocks, dA and dD over the batch rows.
// No atomics: every sum runs in one order, so two calls give the same
// bits.  Staging as in the forward: x, dt, dy, B and C arrive in 16-byte
// cp.async pieces, two stages deep (the next tile loads while this one
// runs), and B and C are copied into runs of K rows padded by one word so
// that the 32 lanes' reads of a state pair fall in 32 banks.
// Steps past S are zeros (dt = 0: a = 1, no input, no output, the carry
// passes); channels past C (the wrapper pads rows to ldc, a multiple of
// a block's channels) are zeros and never written.  The launch plan
// comes from scan1_bwd_plan in kernels/scan1/ops.py, which mirrors the
// layouts below.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kK = 8;         // steps a lane (a tile is 32 kK steps)
// channels (warps) a block: 16 in bf16, at one block an SM (half the
// partials of 8 a block at two, and B and C staged once for 16 channels:
// kernel_variants.py bwd_scan1_cuts); 8 in fp32, whose rows and B / C
// take twice the shared memory
template <typename T>
constexpr int kCT = sizeof(T) == 2 ? 16 : 8;
constexpr int kG = 2;         // states a group

// 2^x on the special-function unit (relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The staging geometry both passes share: x (and dy) and dt rows of CT
// channels, two stages deep, each run of K rows (one lane's steps)
// followed by 16 bytes; B and C as the tile's contiguous [32 K][N] rows,
// copied ("cooked") into runs of K rows followed by one word.
template <typename T, int N, int K, int CT, int Threads>
struct Geo {
  static constexpr int kThreads = Threads;
  static constexpr int kTile = 32 * K;
  static constexpr int kEsz = sizeof(T);
  static constexpr int kWX = CT * kEsz, kWD = CT * 4, kWB = N * kEsz;
  static constexpr int kRunX = K * kWX + 16, kRunD = K * kWD + 16;
  static constexpr int kRunB = K * kWB / 4 + 1;     // words
  static constexpr int kRawB = kTile * kWB;         // bytes
  static constexpr int kCookB = 128 * kRunB;        // bytes: 32 runs
  static_assert(kWX % 16 == 0 && kWB % 16 == 0, "rows are 16-byte pieces");
  static_assert((K * kWB / 4) % 32 == 0, "cooked runs must skew by a bank");
  static_assert(kTile * (kWB / 4) % kThreads == 0, "cook covers the tile");
};

// pass 1 (two channels a warp): two stages of x and dt, B raw and cooked
template <typename T, int N, int K, int CT>
struct StatesLayout : Geo<T, N, K, CT, 16 * CT> {
  using B_ = Geo<T, N, K, CT, 16 * CT>;
  static constexpr int kOffX = 0;
  static constexpr int kOffD = kOffX + 32 * B_::kRunX;
  static constexpr int kStage = kOffD + 32 * B_::kRunD;
  static constexpr int kOffRawB = 2 * kStage;
  static constexpr int kOffB = kOffRawB + B_::kRawB;
  static constexpr int kBytes = kOffB + B_::kCookB;
};

// pass 2 (a channel a warp): two stages of x, dt and dy; B and C raw and
// cooked; and each warp's dB / dC contributions of a group, [CT][2][G]
// [32 lanes][K + 1] floats (also the tile's dx and ddt values before
// their rows are written)
template <typename T, int N, int K, int CT, int G>
struct BwdLayout : Geo<T, N, K, CT, 32 * CT> {
  using B_ = Geo<T, N, K, CT, 32 * CT>;
  static constexpr int kOffX = 0;
  static constexpr int kOffD = kOffX + 32 * B_::kRunX;
  static constexpr int kOffY = kOffD + 32 * B_::kRunD;
  static constexpr int kStage = kOffY + 32 * B_::kRunX;
  static constexpr int kOffRawB = 2 * kStage;
  static constexpr int kOffRawC = kOffRawB + B_::kRawB;
  static constexpr int kOffB = kOffRawC + B_::kRawB;
  static constexpr int kOffC = kOffB + B_::kCookB;
  static constexpr int kOffRed = kOffC + B_::kCookB;
  static constexpr int kRedRow = 32 * (K + 1);        // floats: lane runs
  static constexpr int kRedWarp = 2 * G * kRedRow;    // floats a warp
  static constexpr int kBytes = kOffRed + CT * kRedWarp * 4;
  static constexpr int kRunO = K * CT + 1;   // words of a dx / ddt run
  static_assert(B_::kThreads % (2 * G * 32) == 0 &&
                    K % (B_::kThreads / (2 * G * 32)) == 0,
                "the block sum: a thread a part of one lane's run");
  static_assert(2 * 32 * kRunO <= CT * kRedWarp, "dx, ddt fit the red area");
};

// rows t < rows of a tile (W bytes each, ld bytes apart from src) into
// shared memory at dst (each run of K rows followed by 16 bytes where
// RunPad), in 16-byte pieces; zeros past ``rows``
template <int W, int K, int Tile, int Threads, bool RunPad>
__device__ __forceinline__ void stage_rows(char* dst, const char* src,
                                           size_t ld, int rows, int tid) {
  constexpr int kPer = W / 16, kPieces = Tile * kPer;
#pragma unroll
  for (int r = 0; r < (kPieces + Threads - 1) / Threads; ++r) {
    const int q = tid + r * Threads;
    if (kPieces % Threads && q >= kPieces) break;
    const int t = q / kPer, cb = (q % kPer) * 16;
    const bool ok = t < rows;
    char* d = dst + cb + (RunPad ? (t / K) * (K * W + 16) + (t % K) * W
                                 : t * W);
    const char* s = ok ? src + (size_t)t * ld + cb : src;
    repro::cp_async16(d, s, ok ? 16 : 0);
  }
}

// raw rows -> cooked runs: word q to q + q / (K row words)
template <int K, int RowW, int Tile, int Threads>
__device__ __forceinline__ void cook_rows(uint32_t* out, const uint32_t* in,
                                          int tid) {
#pragma unroll
  for (int r = 0; r < Tile * RowW / Threads; ++r) {
    const int q = tid + r * Threads;
    out[q + q / (K * RowW)] = in[q];
  }
}

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

// ---------------------------------------------------------------- pass 1

template <typename T, int N, int K, int CT, int G>
__global__ void __launch_bounds__(16 * CT)
scan1_bwd_states(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 float* __restrict__ hs, int S, int C, int ldc) {
  using L = StatesLayout<T, N, K, CT>;
  constexpr int kT = L::kTile, kN = L::kThreads, kRowW = L::kWB / 4;
  static_assert(N % G == 0 && G % 2 == 0, "state groups must divide");
  extern __shared__ __align__(16) char smem[];

  // warp w: the block's channels 2w and 2w + 1
  const int tid = threadIdx.x, lane = tid & 31, j = 2 * (tid >> 5);
  const int b = blockIdx.y, c0 = blockIdx.x * CT;
  const int tiles = (S + kT - 1) / kT;

  // lane g < N holds state g's carry and A * log2 e, each channel
  float hc[2] = {0.0f, 0.0f}, a2r[2] = {0.0f, 0.0f};
#pragma unroll
  for (int ch = 0; ch < 2; ++ch)
    if (lane < N && c0 + j + ch < C)
      a2r[ch] = A[(size_t)(c0 + j + ch) * N + lane] * kLog2e;

  const char* xb = reinterpret_cast<const char*>(x + (size_t)b * S * ldc + c0);
  const char* db = reinterpret_cast<const char*>(dt + (size_t)b * S * ldc + c0);
  const char* bb = reinterpret_cast<const char*>(Bm + (size_t)b * S * N);
  const uint32_t* bw = reinterpret_cast<const uint32_t*>(smem + L::kOffB);

  auto stage = [&](int s, int t0) {
    char* st = smem + s * L::kStage;
    const int rows = min(kT, S - t0);
    stage_rows<L::kWX, K, kT, kN, true>(
        st + L::kOffX, xb + (size_t)t0 * ldc * L::kEsz,
        (size_t)ldc * L::kEsz, rows, tid);
    stage_rows<L::kWD, K, kT, kN, true>(
        st + L::kOffD, db + (size_t)t0 * ldc * 4, (size_t)ldc * 4, rows, tid);
    stage_rows<L::kWB, K, kT, kN, false>(
        smem + L::kOffRawB, bb + (size_t)t0 * L::kWB, L::kWB, rows, tid);
    repro::cp_async_commit();
  };
  auto cook = [&]() {
    cook_rows<K, kRowW, kT, kN>(
        reinterpret_cast<uint32_t*>(smem + L::kOffB),
        reinterpret_cast<const uint32_t*>(smem + L::kOffRawB), tid);
  };

  // h where each lane's run starts, every tile: [B, tiles, ldc, N, 32]
  float* hrow = hs + ((size_t)b * tiles * ldc + c0 + j) * N * 32 + lane;
  stage(0, 0);
  repro::cp_async_wait<0>();
  __syncthreads();
  cook();
  __syncthreads();
  if (tiles > 1) stage(1, kT);
  for (int it = 0; it < tiles; ++it) {
    const char* st = smem + (it & 1) * L::kStage;
    float dtv[2][K], dtx[2][K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float2 d = *reinterpret_cast<const float2*>(
          st + L::kOffD + lane * L::kRunD + i * L::kWD + 4 * j);
      const T* xp = reinterpret_cast<const T*>(
          st + L::kOffX + lane * L::kRunX + i * L::kWX + L::kEsz * j);
      dtv[0][i] = d.x;
      dtv[1][i] = d.y;
      dtx[0][i] = d.x * repro::to_f32(xp[0]);
      dtx[1][i] = d.y * repro::to_f32(xp[1]);
    }
    const uint32_t* brow = bw + lane * L::kRunB;
    float* hout = hrow + (size_t)it * ldc * N * 32;
#pragma unroll 1
    for (int g0 = 0; g0 < N; g0 += G) {
      float a2[2][G], pa[2][G], pb[2][G];
#pragma unroll
      for (int ch = 0; ch < 2; ++ch)
#pragma unroll
        for (int g = 0; g < G; ++g)
          a2[ch][g] = __shfl_sync(0xffffffffu, a2r[ch], g0 + g);
#pragma unroll
      for (int i = 0; i < K; ++i) {
        float bv[G];
        load_g<T, G>(brow + i * kRowW + g0 * L::kEsz / 4, bv);
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float a = ex2(dtv[ch][i] * a2[ch][g]);
            const float u = dtx[ch][i] * bv[g];
            if (i == 0) {
              pa[ch][g] = a;
              pb[ch][g] = u;
            } else {
              pb[ch][g] = fmaf(a, pb[ch][g], u);
              pa[ch][g] *= a;
            }
          }
        }
      }
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float qa = __shfl_up_sync(0xffffffffu, pa[ch][g], off);
            const float qb = __shfl_up_sync(0xffffffffu, pb[ch][g], off);
            if (lane >= off) {
              pb[ch][g] = fmaf(pa[ch][g], qb, pb[ch][g]);
              pa[ch][g] *= qa;
            }
          }
        }
      }
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float hin = __shfl_sync(0xffffffffu, hc[ch], g0 + g);
          const float hend = fmaf(pa[ch][g], hin, pb[ch][g]);
          const float hp = __shfl_up_sync(0xffffffffu, hend, 1);
          const float carry = __shfl_sync(0xffffffffu, hend, 31);
          hout[((size_t)ch * N + g0 + g) * 32] = lane == 0 ? hin : hp;
          if (lane == g0 + g) hc[ch] = carry;
        }
      }
    }
    if (it + 1 < tiles) repro::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < tiles) cook();
    __syncthreads();
    if (it + 2 < tiles) stage(it & 1, (it + 2) * kT);
  }
}

// ---------------------------------------------------------------- pass 2

template <typename T, int N, int K, int CT, int G, int MINB>
__global__ void __launch_bounds__(32 * CT, MINB)
scan1_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, const float* __restrict__ Dv,
                 const T* __restrict__ dy, const float* __restrict__ dfin,
                 const float* __restrict__ hs, T* __restrict__ dx,
                 float* __restrict__ ddt, float* __restrict__ dA_part,
                 float* __restrict__ dD_part, float* __restrict__ dbc_part,
                 int S, int C, int ldc) {
  using L = BwdLayout<T, N, K, CT, G>;
  constexpr int kT = L::kTile, kN = L::kThreads, kRowW = L::kWB / 4;
  static_assert(N % G == 0 && G % 2 == 0, "state groups must divide");
  extern __shared__ __align__(16) char smem[];

  const int tid = threadIdx.x, lane = tid & 31, j = tid >> 5;  // channel
  const int b = blockIdx.y, c0 = blockIdx.x * CT, c = c0 + j;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const bool live = c < C;
  const int tiles = (S + kT - 1) / kT;

  // lane g < N holds state g's A, A * log2 e, gradient carry and dA
  float anr = 0.0f, a2r = 0.0f, gc = 0.0f, da = 0.0f;
  if (lane < N && live) {
    anr = A[(size_t)c * N + lane];
    a2r = anr * kLog2e;
    if (dfin != nullptr) gc = dfin[((size_t)b * C + c) * N + lane];
  }
  const float dj = live ? Dv[c] : 0.0f;
  float dd = 0.0f;   // x dy over the lane's steps

  const char* xb = reinterpret_cast<const char*>(x + (size_t)b * S * ldc + c0);
  const char* db = reinterpret_cast<const char*>(dt + (size_t)b * S * ldc + c0);
  const char* yb = reinterpret_cast<const char*>(dy + (size_t)b * S * ldc + c0);
  const char* bb = reinterpret_cast<const char*>(Bm + (size_t)b * S * N);
  const char* cb = reinterpret_cast<const char*>(Cm + (size_t)b * S * N);
  const uint32_t* bw = reinterpret_cast<const uint32_t*>(smem + L::kOffB);
  const uint32_t* cw = reinterpret_cast<const uint32_t*>(smem + L::kOffC);
  float* red = reinterpret_cast<float*>(smem + L::kOffRed);
  const float* hrow = hs + ((size_t)b * tiles * ldc + c) * N * 32 + lane;

  auto stage = [&](int s, int t0) {
    char* st = smem + s * L::kStage;
    const int rows = min(kT, S - t0);
    stage_rows<L::kWX, K, kT, kN, true>(
        st + L::kOffX, xb + (size_t)t0 * ldc * L::kEsz,
        (size_t)ldc * L::kEsz, rows, tid);
    stage_rows<L::kWD, K, kT, kN, true>(
        st + L::kOffD, db + (size_t)t0 * ldc * 4, (size_t)ldc * 4, rows, tid);
    stage_rows<L::kWX, K, kT, kN, true>(
        st + L::kOffY, yb + (size_t)t0 * ldc * L::kEsz,
        (size_t)ldc * L::kEsz, rows, tid);
    stage_rows<L::kWB, K, kT, kN, false>(
        smem + L::kOffRawB, bb + (size_t)t0 * L::kWB, L::kWB, rows, tid);
    stage_rows<L::kWB, K, kT, kN, false>(
        smem + L::kOffRawC, cb + (size_t)t0 * L::kWB, L::kWB, rows, tid);
    repro::cp_async_commit();
  };
  auto cook = [&]() {
    cook_rows<K, kRowW, kT, kN>(
        reinterpret_cast<uint32_t*>(smem + L::kOffB),
        reinterpret_cast<const uint32_t*>(smem + L::kOffRawB), tid);
    cook_rows<K, kRowW, kT, kN>(
        reinterpret_cast<uint32_t*>(smem + L::kOffC),
        reinterpret_cast<const uint32_t*>(smem + L::kOffRawC), tid);
  };

  // the tiles in reverse: stage s holds tile tiles - 1 - s
  stage(0, (tiles - 1) * kT);
  repro::cp_async_wait<0>();
  __syncthreads();
  cook();
  __syncthreads();
  if (tiles > 1) stage(1, (tiles - 2) * kT);
  // the last group's dA share, until the next group's scans
  int pend = -1;
  float dprev[G];
#pragma unroll
  for (int g = 0; g < G; ++g) dprev[g] = 0.0f;
  for (int s = 0; s < tiles; ++s) {
    const int it = tiles - 1 - s, t0 = it * kT;
    const char* st = smem + (s & 1) * L::kStage;
    const float* hin_t = hrow + (size_t)it * ldc * N * 32;

    float dtv[K], dtx[K], dyv[K], uacc[K], vacc[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      dtv[i] = *reinterpret_cast<const float*>(
          st + L::kOffD + lane * L::kRunD + i * L::kWD + 4 * j);
      dtx[i] = dtv[i] * repro::to_f32(*reinterpret_cast<const T*>(
          st + L::kOffX + lane * L::kRunX + i * L::kWX + L::kEsz * j));
      dyv[i] = repro::to_f32(*reinterpret_cast<const T*>(
          st + L::kOffY + lane * L::kRunX + i * L::kWX + L::kEsz * j));
      uacc[i] = 0.0f;
      vacc[i] = 0.0f;
    }
    const uint32_t* brow = bw + lane * L::kRunB;
    const uint32_t* crow = cw + lane * L::kRunB;

#pragma unroll 1
    for (int g0 = 0; g0 < N; g0 += G) {
      // h where the lane's run starts (pass 1), read first
      float hst[G];
#pragma unroll
      for (int g = 0; g < G; ++g) hst[g] = hin_t[(g0 + g) * 32];
      float a[G][K], q[G][K];   // q: C dy, then the gradient g
      float a2[G], an[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        a2[g] = __shfl_sync(0xffffffffu, a2r, g0 + g);
        an[g] = __shfl_sync(0xffffffffu, anr, g0 + g);
      }
      // the exponentials, and the gradient's map c -> a (C dy + c) folded
      // backwards over the lane's run
      float P[G], Q[G];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        float cv[G];
        load_g<T, G>(crow + i * kRowW + g0 * L::kEsz / 4, cv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          a[g][i] = ex2(dtv[i] * a2[g]);
          q[g][i] = cv[g] * dyv[i];
          P[g] = i == 0 ? a[g][0] : P[g] * a[g][i];
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        Q[g] = a[g][K - 1] * q[g][K - 1];
#pragma unroll
        for (int i = K - 2; i >= 0; --i) Q[g] = a[g][i] * (q[g][i] + Q[g]);
      }
      // the warp's suffix scan of those maps (higher lanes first), with
      // the last group's dA summed over the lanes
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float qp = __shfl_down_sync(0xffffffffu, P[g], off);
          const float qq = __shfl_down_sync(0xffffffffu, Q[g], off);
          dprev[g] += __shfl_xor_sync(0xffffffffu, dprev[g], off);
          if (lane + off < 32) {
            Q[g] = fmaf(P[g], qq, Q[g]);
            P[g] *= qp;
          }
        }
      }
      // the gradient's carry into each lane's last step, from the carry
      // out of the tile above, and out of this tile into the one below
      float cin[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (pend >= 0 && lane == pend + g) da += dprev[g];
        const float gin = __shfl_sync(0xffffffffu, gc, g0 + g);
        const float cend = fmaf(P[g], gin, Q[g]);
        const float cn = __shfl_down_sync(0xffffffffu, cend, 1);
        const float out = __shfl_sync(0xffffffffu, cend, 0);
        cin[g] = lane == 31 ? gin : cn;
        if (lane == g0 + g) gc = out;
      }
      // backwards over the run: g_t
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float cc = cin[g];
#pragma unroll
        for (int i = K - 1; i >= 0; --i) {
          const float gv = q[g][i] + cc;
          q[g][i] = gv;
          cc = a[g][i] * gv;
        }
      }
      // every thread has read the last group's contributions
      __syncthreads();
      // forwards over the run: h_t and every contribution
      float* rw = red + j * L::kRedWarp + lane * (K + 1);
      float h[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        h[g] = hst[g];
        dprev[g] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < K; ++i) {
        float bv[G];
        load_g<T, G>(brow + i * kRowW + g0 * L::kEsz / 4, bv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float gv = q[g][i], ah = a[g][i] * h[g];
          h[g] = fmaf(dtx[i], bv[g], ah);
          const float w = ah * gv;
          uacc[i] = fmaf(bv[g], gv, uacc[i]);
          vacc[i] = fmaf(an[g], w, vacc[i]);
          dprev[g] = fmaf(dtv[i], w, dprev[g]);
          rw[(0 * G + g) * L::kRedRow + i] = dtx[i] * gv;   // dB
          rw[(1 * G + g) * L::kRedRow + i] = h[g] * dyv[i];  // dC
        }
      }
      __syncthreads();
      // the block's warps in order: one partial a (step, block), [B,
      // blocks, 2, N, S]; a thread takes kH consecutive steps of a lane's
      // run of one kind and state, a warp's threads 32 lanes' runs (their
      // reads in 32 banks)
      {
        constexpr int kParts = kN / (2 * G * 32), kH = K / kParts;
        const int l = tid % 32, half = tid / 32 % kParts;
        const int kg = tid / (32 * kParts);
        const int at = kg * L::kRedRow + l * (K + 1) + half * kH;
        float sum[kH];
#pragma unroll
        for (int i = 0; i < kH; ++i) sum[i] = red[at + i];
#pragma unroll
        for (int w = 1; w < CT; ++w) {
#pragma unroll
          for (int i = 0; i < kH; ++i) sum[i] += red[w * L::kRedWarp + at + i];
        }
        const int stp = l * K + half * kH;
        float* dst = dbc_part + ((((size_t)b * nblk + blk) * 2 + kg / G) * N +
                                 g0 + kg % G) * S + t0 + stp;
        if (kH % 4 == 0 && t0 + stp + kH <= S && (S & 3) == 0) {
#pragma unroll
          for (int i = 0; i < kH; i += 4)
            *reinterpret_cast<float4*>(dst + i) =
                make_float4(sum[i], sum[i + 1], sum[i + 2], sum[i + 3]);
        } else {
#pragma unroll
          for (int i = 0; i < kH; ++i)
            if (t0 + stp + i < S) dst[i] = sum[i];
        }
      }
      pend = g0;
    }

    // dx and ddt of the lane's steps, through shared memory to their rows
    __syncthreads();   // every thread has read the contribution area
    float* dxs = red;
    float* dts = red + 32 * L::kRunO;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float xv = repro::to_f32(*reinterpret_cast<const T*>(
          st + L::kOffX + lane * L::kRunX + i * L::kWX + L::kEsz * j));
      dxs[lane * L::kRunO + i * CT + j] = fmaf(dtv[i], uacc[i], dj * dyv[i]);
      dts[lane * L::kRunO + i * CT + j] = fmaf(xv, uacc[i], vacc[i]);
      dd = fmaf(xv, dyv[i], dd);
    }
    if (s + 1 < tiles) repro::cp_async_wait<0>();
    __syncthreads();
    const int rows = min(kT, S - t0);
    for (int t = tid; t < rows; t += kN) {
      const float* px = dxs + (t / K) * L::kRunO + (t % K) * CT;
      const float* pt = dts + (t / K) * L::kRunO + (t % K) * CT;
      T* ox = dx + ((size_t)b * S + t0 + t) * ldc + c0;
      float* ot = ddt + ((size_t)b * S + t0 + t) * ldc + c0;
#pragma unroll
      for (int k = 0; k < CT; k += 4)
        *reinterpret_cast<float4*>(ot + k) =
            make_float4(pt[k], pt[k + 1], pt[k + 2], pt[k + 3]);
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int k = 0; k < CT; k += 4)
          *reinterpret_cast<float4*>(ox + k) =
              make_float4(px[k], px[k + 1], px[k + 2], px[k + 3]);
      } else {
#pragma unroll
        for (int k = 0; k < CT; k += 8)
          *reinterpret_cast<uint4*>(ox + k) = make_uint4(
              repro::pack_bf16(px[k], px[k + 1]),
              repro::pack_bf16(px[k + 2], px[k + 3]),
              repro::pack_bf16(px[k + 4], px[k + 5]),
              repro::pack_bf16(px[k + 6], px[k + 7]));
      }
    }
    if (s + 1 < tiles) cook();
    __syncthreads();
    if (s + 2 < tiles) stage(s & 1, (it - 2) * kT);
  }
  // the last group's dA share
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 1; off < 32; off *= 2)
      dprev[g] += __shfl_xor_sync(0xffffffffu, dprev[g], off);
    if (lane == pend + g) da += dprev[g];
  }
  if (lane < N) dA_part[((size_t)b * ldc + c) * N + lane] = da;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dd += __shfl_xor_sync(0xffffffffu, dd, off);
  if (lane == 0) dD_part[(size_t)b * ldc + c] = dd;
}

// ---------------------------------------------------------------- pass 3

// the partials summed in a fixed order: dB, dC over the channel blocks,
// dA, dD over the batch rows
template <typename T, int N>
__global__ void scan1_bwd_finish(const float* __restrict__ dA_part,
                                 const float* __restrict__ dD_part,
                                 const float* __restrict__ dbc_part,
                                 float* __restrict__ dA,
                                 float* __restrict__ dD, T* __restrict__ dB,
                                 T* __restrict__ dC, int B, int S, int C,
                                 int ldc, int nblk) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < (long long)B * 2 * N * S) {
    const int t = (int)(i % S), n = (int)(i / S % N);
    const int kind = (int)(i / ((long long)S * N) % 2);
    const int b = (int)(i / (2LL * S * N));
    const float* p = dbc_part + (((size_t)b * nblk * 2 + kind) * N + n) * S + t;
    float sum = 0.0f;
    for (int k = 0; k < nblk; ++k) sum += p[(size_t)k * 2 * N * S];
    (kind ? dC : dB)[((size_t)b * S + t) * N + n] = repro::from_f32<T>(sum);
  }
  if (i < (long long)C * N) {
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s += dA_part[(size_t)b * ldc * N + i];
    dA[i] = s;
  }
  if (i < C) {
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s += dD_part[(size_t)b * ldc + i];
    dD[i] = s;
  }
}

template <typename T, int N>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* bm, const void* cm, const void* D,
                   const void* dy, const void* dfin, void* scratch, void* dx,
                   void* ddt, void* dA, void* dB, void* dC, void* dD, int B,
                   int S, int C, int ldc, cudaStream_t st) {
  constexpr int CT = kCT<T>;
  using LA = StatesLayout<T, N, kK, CT>;
  using LB = BwdLayout<T, N, kK, CT, kG>;
  auto states = scan1_bwd_states<T, N, kK, CT, kG>;
  auto bwd = scan1_bwd_kernel<T, N, kK, CT, kG, 1>;
  static const cudaError_t attr_a = cudaFuncSetAttribute(
      states, cudaFuncAttributeMaxDynamicSharedMemorySize, LA::kBytes);
  static const cudaError_t attr_b = cudaFuncSetAttribute(
      bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, LB::kBytes);
  if (attr_a != cudaSuccess) return attr_a;
  if (attr_b != cudaSuccess) return attr_b;
  const int tiles = (S + LB::kTile - 1) / LB::kTile;
  const int nblk = ldc / CT;
  // scratch (scan1/ops.py mirrors it: scan1_bwd_plan): hs [B,tiles,ldc,N,
  // 32 lanes], dA [B,ldc,N], dD [B,ldc], dB / dC partials [B,blocks,2,N,S]
  float* hs = static_cast<float*>(scratch);
  float* pa = hs + (size_t)B * tiles * ldc * N * 32;
  float* pd = pa + (size_t)B * ldc * N;
  float* pbc = pd + (size_t)B * ldc;
  states<<<dim3(nblk, B), LA::kThreads, LA::kBytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(bm), hs, S, C, ldc);
  bwd<<<dim3(nblk, B), LB::kThreads, LB::kBytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(D),
      static_cast<const T*>(dy), static_cast<const float*>(dfin), hs,
      static_cast<T*>(dx), static_cast<float*>(ddt), pa, pd, pbc, S, C, ldc);
  long long jobs = (long long)B * 2 * N * S;
  if ((long long)C * N > jobs) jobs = (long long)C * N;
  scan1_bwd_finish<T, N><<<(unsigned)((jobs + 255) / 256), 256, 0, st>>>(
      pa, pd, pbc, static_cast<float*>(dA), static_cast<float*>(dD),
      static_cast<T*>(dB), static_cast<T*>(dC), B, S, C, ldc, nblk);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx: [B,S,ldc]; bm, cm, dB, dC: [B,S,N] (dtype 0 = float32, 1 =
// bfloat16, shared by them); dt, ddt: [B,S,ldc], A, dA: [C,N], D, dD: [C],
// dfin: [B,C,N] or null (the final state's gradient), all fp32 and all
// contiguous, rows 16-byte aligned.  ldc (>= C) is a multiple of CT (16
// in bf16, 8 in fp32), the channels past C zeros.  scratch: fp32,
// B*(tiles*ldc*N*32 + ldc*N + ldc + 2*(ldc/CT)*N*S) elements, tiles =
// ceil(S / 256).  N = 8 or 16.
extern "C" int repro_scan1_bwd(const void* x, const void* dt, const void* A,
                               const void* bm, const void* cm, const void* D,
                               const void* dy, const void* dfin,
                               void* scratch, void* dx, void* ddt, void* dA,
                               void* dB, void* dC, void* dD, int B, int S,
                               int C, int ldc, int N, int dtype,
                               void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || C <= 0 || ldc < C ||
      ldc % (dtype == 1 ? kCT<__nv_bfloat16> : kCT<float>))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto tag, auto n) {
    using T = decltype(tag);
    return (int)launch<T, decltype(n)::value>(x, dt, A, bm, cm, D, dy, dfin,
                                              scratch, dx, ddt, dA, dB, dC,
                                              dD, B, S, C, ldc, st);
  };
  using N8 = std::integral_constant<int, 8>;
  using N16 = std::integral_constant<int, 16>;
  if (dtype == 0 && N == 8) return go(float{}, N8{});
  if (dtype == 0 && N == 16) return go(float{}, N16{});
  if (dtype == 1 && N == 8) return go(__nv_bfloat16{}, N8{});
  if (dtype == 1 && N == 16) return go(__nv_bfloat16{}, N16{});
  return (int)cudaErrorInvalidValue;
}
