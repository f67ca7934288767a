// Mamba-2 chunked SSD scan (state-space dual form), for prefill.
//
// Replaces the TPU kernel ssd_pallas (src/repro/kernels/ssd/kernel.py:68,
// body _ssd_kernel :25).
//
// Bound on the H100: bytes.  At mamba2-2.7b's shapes (B=4, S=256, H=80,
// P=64, N=128, chunk Q=128) the scan moves about 43 MB (x, y, the fp32
// state in and out; B and C are shared by all heads) and does about
// 6.7 GFLOP: ~13 us for the bytes, ~7 us for the operations on bf16 tensor
// cores.
//
// Per chunk, as in _ssd_kernel :42-61, with cum the prefix sum of dt*A:
//   y   = exp(cum) * (C . state^T) + D*x                 (inter-chunk)
//       + ((C B^T) (.) L (.) dt) x                        (intra-chunk)
//   state = state * exp(cum_last) + (x (.) dt*exp(cum_last - cum))^T B
// The TPU iterates chunks along a sequential grid axis and keeps the [P,N]
// state in VMEM scratch.  Blocks here run in no order, so a block owns
// one (batch row, head) and loops over the chunks itself.
//
// bf16 at (Q, P, N) = (128, 64, 128) and (128, 64, 64) (mamba2-2.7b,
// zamba2-2.7b) runs the four products on tensor cores, mma.sync m16n8k16
// with fp32 accumulate, eight warps a block:
// - x, B and C stay bf16, as they arrive, in shared memory rows padded by
//   16 bytes (ldmatrix hits eight distinct bank groups); cp.async streams
//   the next chunk's x, B, C and dt into a second buffer while this chunk
//   computes.
// - y: warp w owns 16 rows of the chunk (row tiles 0-3, 7-4, so the two
//   warps of each SM sub-partition share the causal work evenly).  Its C
//   fragments feed both C . state^T and C B^T.  C B^T is exact in fp32 and
//   only the 16-column blocks on or below the diagonal are computed; the
//   masked, decayed scores feed the product with x from registers, as
//   flash attention's P.V.  Every decay is 2^(x log2 e) on the SFU
//   (ex2.approx), with cum * log2 e kept per token: the accurate expf was
//   a fifth of the kernel's time (scripts/kernel_variants.py
//   ssd_breakdown).
// - The fp32 state lives in registers, in the accumulator layout of the
//   update (x (.) w)^T B: warp w owns 16 state rows and a range of
//   columns.  The state's hi and lo terms are kept in shared memory for the
//   next chunk's C . state^T; its last value goes straight to its
//   destination (the cache slot when the caller gives one).
// - Every fp32 operand (the scores, the state in C . state^T, x (.) w in
//   the update) is split into two bf16 terms, hi + lo, two products, which
//   keeps it to ~2^-17 of its size.  One bf16 term would carry 2^-9 of
//   it: into a state that adds it up chunk after chunk, and into rows of y
//   whose terms cancel (the diagonal score's x against D*x), which then
//   break their per-row limit (scripts/kernel_variants.py ssd_operands
//   measures each operand rounded to one term).
// Other instances (fp32, and the reduced (16, 16, 16) test shape) run the
// first kernel below on the CUDA cores, in fp32: one block per (batch row,
// head), x, B and C staged as padded fp32, the four products as 8 x 4
// register tiles out of shared memory.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;   // a 16 x 16 thread grid

template <int Q, int P, int N>
struct Smem {
  static constexpr int kRB = Q < 32 ? Q : 32;        // score rows per pass
  static constexpr int kStride = N + 1;              // padded row of B, C, state
  static constexpr int kSStride = Q + 16;            // row of the score block
  static constexpr size_t kFloats =
      (size_t)P * kStride + 2 * (size_t)Q * kStride + (size_t)Q * P +
      (size_t)kRB * kSStride + 3 * (size_t)Q;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <typename T, int Q, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ Dv,
           const float* __restrict__ init, T* __restrict__ y,
           float* __restrict__ final_state, float* __restrict__ chunk_states,
           int S, int H, int G) {
  using L = Smem<Q, P, N>;
  constexpr int RB = L::kRB, ST = L::kStride, SS = L::kSStride;
  constexpr int YR = Q / 16, YC = P / 16;   // y tile: rows x columns
  constexpr int SR = P / 16, SC = N / 16;   // state tile
  constexpr int BR = RB / 16;               // score rows per thread per pass
  constexpr int QC = Q / 16;                // score columns per thread
  static_assert(Q % 32 == 0 || Q == 16, "chunk 16 or a multiple of 32");
  static_assert(P % 16 == 0 && N % 16 == 0 && Q <= 128, "tile shapes");

  extern __shared__ float smem[];
  float* st = smem;                       // [P][ST]
  float* bs = st + P * ST;                // [Q][ST]
  float* cs = bs + Q * ST;                // [Q][ST]
  float* xs = cs + Q * ST;                // [Q][P]
  float* sb = xs + Q * P;                 // [RB][SS] scores * L * dt
  float* dts = sb + RB * SS;              // [Q]
  float* cum = dts + Q;                   // [Q]
  float* wend = cum + Q;                  // [Q] dt * exp(cum_last - cum)

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const float a = A[h];
  const float dskip = Dv[h];
  const int nc = S / Q;

  const float* init_bh = init + (size_t)bh * P * N;
  for (int e = tid; e < P * N; e += kThreads)
    st[(e / N) * ST + (e % N)] = init_bh[e];

  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * Q;
    __syncthreads();   // previous chunk's readers of xs/bs/cs/st are done
    if (chunk_states != nullptr) {
      // the state entering the chunk, for the backward (training)
      float* cst = chunk_states + ((size_t)bh * nc + ci) * P * N;
      for (int e = tid; e < P * N; e += kThreads)
        cst[e] = st[(e / N) * ST + (e % N)];
    }
    for (int e = tid; e < Q * P; e += kThreads) {
      const int i = e / P, p = e % P;
      xs[e] = repro::to_f32(x[(((size_t)b * S + t0 + i) * H + h) * P + p]);
    }
    for (int e = tid; e < Q * N; e += kThreads) {
      const int i = e / N, n = e % N;
      const size_t off = (((size_t)b * S + t0 + i) * G + g) * N + n;
      bs[i * ST + n] = repro::to_f32(Bm[off]);
      cs[i * ST + n] = repro::to_f32(Cm[off]);
    }
    if (tid < 32) {
      // inclusive prefix sum of dt*A over the chunk, Q/32 rows per lane
      constexpr int kPer = Q / 32 > 0 ? Q / 32 : 1;
      float v[kPer];
      float run = 0.0f;
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int i = tid * kPer + r;
        float d = 0.0f;
        if (i < Q) {
          d = dt[((size_t)b * S + t0 + i) * H + h];
          dts[i] = d;
        }
        run += d * a;
        v[r] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      const float base = incl - run;
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int i = tid * kPer + r;
        if (i < Q) cum[i] = base + v[r];
      }
    }
    __syncthreads();
    const float last = cum[Q - 1];
    for (int j = tid; j < Q; j += kThreads)
      wend[j] = dts[j] * expf(last - cum[j]);

    // inter-chunk term and the skip: exp(cum_i) * C_i . state_p + D x_ip
    float acc[YR][YC];
#pragma unroll
    for (int r = 0; r < YR; ++r)
#pragma unroll
      for (int c = 0; c < YC; ++c) acc[r][c] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      float av[YR], bv[YC];
#pragma unroll
      for (int r = 0; r < YR; ++r) av[r] = cs[(ty + 16 * r) * ST + k];
#pragma unroll
      for (int c = 0; c < YC; ++c) bv[c] = st[(tx + 16 * c) * ST + k];
#pragma unroll
      for (int r = 0; r < YR; ++r)
#pragma unroll
        for (int c = 0; c < YC; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < YR; ++r) {
      const int i = ty + 16 * r;
      const float e = expf(cum[i]);
#pragma unroll
      for (int c = 0; c < YC; ++c)
        acc[r][c] = e * acc[r][c] + dskip * xs[i * P + tx + 16 * c];
    }

    // intra-chunk term, RB score rows per pass; the thread's score rows
    // rb*RB + ty + 16q are its y rows r = rb*BR + q
#pragma unroll
    for (int rb = 0; rb < Q / RB; ++rb) {
      const int cm = min(QC, (rb + 1) * RB / 16);   // column tiles at or below
      __syncthreads();   // sb of the previous pass fully consumed
      float sv[BR][QC];
#pragma unroll
      for (int q = 0; q < BR; ++q)
#pragma unroll
        for (int c = 0; c < QC; ++c) sv[q][c] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < N; ++k) {
        float av[BR], bv[QC];
#pragma unroll
        for (int q = 0; q < BR; ++q)
          av[q] = cs[(rb * RB + ty + 16 * q) * ST + k];
#pragma unroll
        for (int c = 0; c < QC; ++c)
          if (c < cm) bv[c] = bs[(tx + 16 * c) * ST + k];
#pragma unroll
        for (int q = 0; q < BR; ++q)
#pragma unroll
          for (int c = 0; c < QC; ++c)
            if (c < cm) sv[q][c] = fmaf(av[q], bv[c], sv[q][c]);
      }
#pragma unroll
      for (int q = 0; q < BR; ++q) {
        const int ii = ty + 16 * q, i = rb * RB + ii;
#pragma unroll
        for (int c = 0; c < QC; ++c) {
          const int j = tx + 16 * c;
          sb[ii * SS + j] = (c < cm && j <= i)
              ? sv[q][c] * expf(cum[i] - cum[j]) * dts[j] : 0.0f;
        }
      }
      __syncthreads();
      const int jend = (rb + 1) * RB;
#pragma unroll 4
      for (int j = 0; j < jend; ++j) {
        float av[BR], bv[YC];
#pragma unroll
        for (int q = 0; q < BR; ++q) av[q] = sb[(ty + 16 * q) * SS + j];
#pragma unroll
        for (int c = 0; c < YC; ++c) bv[c] = xs[j * P + tx + 16 * c];
#pragma unroll
        for (int q = 0; q < BR; ++q)
#pragma unroll
          for (int c = 0; c < YC; ++c)
            acc[rb * BR + q][c] = fmaf(av[q], bv[c], acc[rb * BR + q][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < YR; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < YC; ++c)
        y[(((size_t)b * S + t0 + i) * H + h) * P + tx + 16 * c] =
            repro::from_f32<T>(acc[r][c]);
    }

    // state update: state * exp(cum_last) + sum_j x_jp dt_j e^(last-cum_j) B_jn
    __syncthreads();   // every reader of st and of the raw xs is done
    for (int e = tid; e < Q * P; e += kThreads) xs[e] *= wend[e / P];
    __syncthreads();
    const float decay = expf(last);
    float sacc[SR][SC];
#pragma unroll
    for (int r = 0; r < SR; ++r)
#pragma unroll
      for (int c = 0; c < SC; ++c) sacc[r][c] = 0.0f;
#pragma unroll 4
    for (int j = 0; j < Q; ++j) {
      float av[SR], bv[SC];
#pragma unroll
      for (int r = 0; r < SR; ++r) av[r] = xs[j * P + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < SC; ++c) bv[c] = bs[j * ST + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < SR; ++r)
#pragma unroll
        for (int c = 0; c < SC; ++c) sacc[r][c] = fmaf(av[r], bv[c], sacc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < SR; ++r)
#pragma unroll
      for (int c = 0; c < SC; ++c) {
        float* sp = st + (ty + 16 * r) * ST + tx + 16 * c;
        *sp = *sp * decay + sacc[r][c];
      }
  }
  __syncthreads();
  float* fin = final_state + (size_t)bh * P * N;
  for (int e = tid; e < P * N; e += kThreads)
    fin[e] = st[(e / N) * ST + (e % N)];
}

template <typename T, int Q, int P, int N>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* D,
                   const void* init, void* y, void* fin, void* cst, int B,
                   int S, int H, int G, cudaStream_t stream) {
  auto kern = ssd_kernel<T, Q, P, N>;
  const size_t bytes = Smem<Q, P, N>::kBytes;
  // once per instantiation (the port drives one card per process), so a
  // launch inside CUDA-graph capture makes no configuration call
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  kern<<<B * H, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(init), static_cast<T*>(y),
      static_cast<float*>(fin), static_cast<float*>(cst), S, H, G);
  return cudaGetLastError();
}

// ------------------------------------------ bf16 on tensor cores

constexpr int kTQ = 128;         // chunk
constexpr int kTWarps = 8;
constexpr int kTThreads = kTWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

// shared memory of the tensor-core kernel: two stages of x [Q][P], B and
// C [Q][N] in bf16, the state's hi and lo terms [P][N] in bf16 (rows
// padded by 8 elements), dt [2][Q], exp(cum) and
// the update weights [Q], and (cum * log2(e), dt) [Q] in fp32 (mirrored
// by ssd/ops.py: ssd_plan)
template <int P, int N>
struct TcSmem {
  static constexpr int XS = P + 8, BS = N + 8;
  static constexpr size_t kX = (size_t)kTQ * XS, kB = (size_t)kTQ * BS;
  static constexpr size_t kStage = kX + 2 * kB;
  static constexpr size_t kState = (size_t)P * BS;
  static constexpr size_t kBytes =
      (2 * kStage + 2 * kState) * 2 + 6 * (size_t)kTQ * 4;
};

using repro::exp2_approx;

template <int P, int N>
__global__ void __launch_bounds__(kTThreads, 1)
ssd_tc_kernel(const __nv_bfloat16* __restrict__ x,
              const float* __restrict__ dt, const float* __restrict__ A,
              const __nv_bfloat16* __restrict__ Bm,
              const __nv_bfloat16* __restrict__ Cm,
              const float* __restrict__ Dv, const float* __restrict__ init,
              __nv_bfloat16* __restrict__ y, float* __restrict__ final_state,
              float* __restrict__ chunk_states, int S, int H, int G) {
  using L = TcSmem<P, N>;
  constexpr int Q = kTQ, XS = L::XS, BS = L::BS;
  constexpr int NK = N / 16;          // k-steps over the state's columns
  constexpr int PT = P / 8;           // n-tiles of y
  constexpr int MT = P / 16;          // m-tiles of the state
  constexpr int WN = kTWarps / MT;    // warps sharing one state m-tile
  constexpr int NT = N / 8 / WN;      // state n-tiles a warp owns
  static_assert(P % 16 == 0 && kTWarps % MT == 0 && (N / 8) % WN == 0 &&
                NT % 2 == 0 && PT % 2 == 0, "tile shapes");
  using repro::ldmatrix_x4;
  using repro::ldmatrix_x4_trans;
  using repro::mma_bf16;
  using repro::pack_bf16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stage0 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sthi = stage0 + 2 * L::kStage;
  __nv_bfloat16* stlo = sthi + L::kState;
  float* dts = reinterpret_cast<float*>(stlo + L::kState);   // [2][Q]
  float* ecum = dts + 2 * Q;    // exp(cum)
  float* wend = ecum + Q;       // dt * exp(cum_last - cum)
  float2* cdt = reinterpret_cast<float2*>(wend + Q);   // (cum log2 e, dt)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, gc = (lane & 3) * 2;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const float a = A[h], dskip = Dv[h];
  const int nc = S / Q;

  // chunk ci's x, B, C and dt into stage st
  auto load_chunk = [&](int ci, int st) {
    const int t0 = ci * Q;
    __nv_bfloat16* xd = stage0 + st * L::kStage;
    __nv_bfloat16* bd = xd + L::kX;
    __nv_bfloat16* cd = bd + L::kB;
    constexpr int XV = P / 8, BV = N / 8;    // 16-byte vectors a row
    for (int e = tid; e < Q * XV; e += kTThreads) {
      const int i = e / XV, c = e % XV;
      repro::cp_async16(xd + i * XS + c * 8,
                        x + (((size_t)b * S + t0 + i) * H + h) * P + c * 8,
                        16);
    }
    for (int e = tid; e < Q * BV; e += kTThreads) {
      const int i = e / BV, c = e % BV;
      const size_t off = (((size_t)b * S + t0 + i) * G + g) * N + c * 8;
      repro::cp_async16(bd + i * BS + c * 8, Bm + off, 16);
      repro::cp_async16(cd + i * BS + c * 8, Cm + off, 16);
    }
    if (tid < Q)
      repro::cp_async4(dts + st * Q + tid,
                        dt + ((size_t)b * S + t0 + tid) * H + h);
  };

  load_chunk(0, 0);
  repro::cp_async_commit();

  // this warp's state tile: rows pm + gr (+8), n-tiles nb .. nb + NT - 1
  const int pm = (warp % MT) * 16, nb = (warp / MT) * NT;
  float sacc[NT][4];
  const size_t sbase = (size_t)bh * P * N;
  {
    const float* in = init + sbase;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int n = (nb + t) * 8 + gc;
      const float2 v0 = *reinterpret_cast<const float2*>(
          in + (size_t)(pm + gr) * N + n);
      const float2 v1 = *reinterpret_cast<const float2*>(
          in + (size_t)(pm + gr + 8) * N + n);
      sacc[t][0] = v0.x;
      sacc[t][1] = v0.y;
      sacc[t][2] = v1.x;
      sacc[t][3] = v1.y;
    }
  }
  // the state's hi and lo bf16 terms, for C . state^T
  auto store_terms = [&]() {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int n = (nb + t) * 8 + gc;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t hi, lo;
        repro::split_bf16(sacc[t][2 * r], sacc[t][2 * r + 1], hi, lo);
        const int off = (pm + gr + 8 * r) * BS + n;
        *reinterpret_cast<uint32_t*>(sthi + off) = hi;
        *reinterpret_cast<uint32_t*>(stlo + off) = lo;
      }
    }
  };
  store_terms();

  // y row tile: 0-3 for warps 0-3, 7-4 for warps 4-7
  const int i0 = (warp < 4 ? warp : 11 - warp) * 16;
  const int rt = i0 / 16;

  for (int ci = 0; ci < nc; ++ci) {
    const int st = ci & 1;
    if (chunk_states != nullptr) {
      // the state entering the chunk, for the backward (training)
      float* cst = chunk_states + ((size_t)bh * nc + ci) * P * N;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int n = (nb + t) * 8 + gc;
        *reinterpret_cast<float2*>(cst + (size_t)(pm + gr) * N + n) =
            make_float2(sacc[t][0], sacc[t][1]);
        *reinterpret_cast<float2*>(cst + (size_t)(pm + gr + 8) * N + n) =
            make_float2(sacc[t][2], sacc[t][3]);
      }
    }
    if (ci + 1 < nc) load_chunk(ci + 1, st ^ 1);
    repro::cp_async_commit();
    repro::cp_async_wait<1>();
    __syncthreads();   // stage st, and the state's terms, are in place
    const __nv_bfloat16* xs = stage0 + st * L::kStage;
    const __nv_bfloat16* bs = xs + L::kX;
    const __nv_bfloat16* cs = bs + L::kB;
    const float* dtc = dts + st * Q;
    if (warp == 0) {
      // inclusive prefix sum of dt*A, four rows a lane, as the CUDA-core
      // kernel takes it
      constexpr int kPer = Q / 32;
      float v[kPer];
      float run = 0.0f;
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        run += dtc[lane * kPer + r] * a;
        v[r] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      const float base = incl - run;
      const float last2 =
          __shfl_sync(0xffffffffu, base + v[kPer - 1], 31) * kLog2e;
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int i = lane * kPer + r;
        const float c2 = (base + v[r]) * kLog2e;
        ecum[i] = exp2_approx(c2);
        wend[i] = dtc[i] * exp2_approx(last2 - c2);
        cdt[i] = make_float2(c2, dtc[i]);
      }
    }
    __syncthreads();

    // ---- y for rows i0 .. i0 + 15
    uint32_t ca[NK][4];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      ldmatrix_x4(ca[kk], cs + (i0 + (lane & 7) + ((lane >> 3) & 1) * 8) * BS +
                          kk * 16 + (lane >> 4) * 8);
    float acc[PT][4];
#pragma unroll
    for (int t = 0; t < PT; ++t)
      acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
    // inter-chunk: C . state^T, the state as hi + lo
#pragma unroll
    for (int pp = 0; pp < PT / 2; ++pp) {
      const int off = (pp * 16 + (lane & 7) + (lane >> 4) * 8) * BS +
                      ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t bh4[4], bl4[4];
        ldmatrix_x4(bh4, sthi + off + kk * 16);
        ldmatrix_x4(bl4, stlo + off + kk * 16);
        mma_bf16(acc[2 * pp], ca[kk], bh4[0], bh4[1]);
        mma_bf16(acc[2 * pp + 1], ca[kk], bh4[2], bh4[3]);
        mma_bf16(acc[2 * pp], ca[kk], bl4[0], bl4[1]);
        mma_bf16(acc[2 * pp + 1], ca[kk], bl4[2], bl4[3]);
      }
    }
    const int ia = i0 + gr, ib = ia + 8;
    {
      const float e0 = ecum[ia], e1 = ecum[ib];
#pragma unroll
      for (int t = 0; t < PT; ++t) {
        acc[t][0] *= e0;
        acc[t][1] *= e0;
        acc[t][2] *= e1;
        acc[t][3] *= e1;
      }
    }
    // intra-chunk: the 16-column blocks of C B^T on or below the diagonal
    const float cuma = cdt[ia].x, cumb = cdt[ib].x;
    for (int cb = 0; cb <= rt; ++cb) {
      float sc[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.0f;
      const __nv_bfloat16* brow =
          bs + (cb * 16 + (lane & 7) + (lane >> 4) * 8) * BS +
          ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t r[4];
        ldmatrix_x4(r, brow + kk * 16);
        mma_bf16(sc[0], ca[kk], r[0], r[1]);
        mma_bf16(sc[1], ca[kk], r[2], r[3]);
      }
      // (C B^T) (.) exp(cum_i - cum_j) (.) dt_j on and below the diagonal,
      // the decay as 2^((cum_i - cum_j) log2 e)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j0 = cb * 16 + t * 8 + gc;
        const float4 cd = *reinterpret_cast<const float4*>(cdt + j0);
        const float cj[2] = {cd.x, cd.z}, dj[2] = {cd.y, cd.w};
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = j0 + jj;
          sc[t][jj] = j <= ia ? sc[t][jj] * exp2_approx(cuma - cj[jj]) *
                                    dj[jj] : 0.0f;
          sc[t][2 + jj] = j <= ib ? sc[t][2 + jj] *
                                        exp2_approx(cumb - cj[jj]) * dj[jj]
                                  : 0.0f;
        }
      }
      // the scores as the A operand, hi + lo: y is a signed sum, and where
      // its terms cancel (the diagonal's against D*x) one bf16 term's
      // 2^-9 would be far above the row's own size
      uint32_t phi[4], plo[4];
      repro::split_bf16(sc[0][0], sc[0][1], phi[0], plo[0]);
      repro::split_bf16(sc[0][2], sc[0][3], phi[1], plo[1]);
      repro::split_bf16(sc[1][0], sc[1][1], phi[2], plo[2]);
      repro::split_bf16(sc[1][2], sc[1][3], phi[3], plo[3]);
      const __nv_bfloat16* xrow =
          xs + (cb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * XS +
          (lane >> 4) * 8;
#pragma unroll
      for (int pp = 0; pp < PT / 2; ++pp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, xrow + pp * 16);
        mma_bf16(acc[2 * pp], phi, vb[0], vb[1]);
        mma_bf16(acc[2 * pp + 1], phi, vb[2], vb[3]);
        mma_bf16(acc[2 * pp], plo, vb[0], vb[1]);
        mma_bf16(acc[2 * pp + 1], plo, vb[2], vb[3]);
      }
    }
    // the skip term, and y
    {
      const size_t t0 = (size_t)ci * Q;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r ? ib : ia;
        __nv_bfloat16* yrow =
            y + (((size_t)b * S + t0 + i) * H + h) * P;
#pragma unroll
        for (int t = 0; t < PT; ++t) {
          const int col = t * 8 + gc;
          const float2 xv = repro::unpack_bf16(
              *reinterpret_cast<const uint32_t*>(xs + i * XS + col));
          *reinterpret_cast<uint32_t*>(yrow + col) = pack_bf16(
              acc[t][2 * r] + dskip * xv.x, acc[t][2 * r + 1] + dskip * xv.y);
        }
      }
    }

    // ---- state = state * exp(cum_last) + (x (.) w)^T B, x (.) w as hi + lo
    {
      const float decay = ecum[Q - 1];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        sacc[t][0] *= decay;
        sacc[t][1] *= decay;
        sacc[t][2] *= decay;
        sacc[t][3] *= decay;
      }
    }
#pragma unroll 2
    for (int kk = 0; kk < Q / 16; ++kk) {
      uint32_t xr[4], ahi[4], alo[4];
      ldmatrix_x4_trans(xr, xs + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * XS +
                            pm + ((lane >> 3) & 1) * 8);
      const int j0 = kk * 16 + gc;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + (q >> 1) * 8;
        const float2 xv = repro::unpack_bf16(xr[q]);
        repro::split_bf16(xv.x * wend[j], xv.y * wend[j + 1], ahi[q],
                            alo[q]);
      }
      const __nv_bfloat16* brow =
          bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * BS +
          nb * 8 + (lane >> 4) * 8;
#pragma unroll
      for (int t = 0; t < NT; t += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, brow + t * 8);
        mma_bf16(sacc[t], ahi, r[0], r[1]);
        mma_bf16(sacc[t], alo, r[0], r[1]);
        mma_bf16(sacc[t + 1], ahi, r[2], r[3]);
        mma_bf16(sacc[t + 1], alo, r[2], r[3]);
      }
    }
    __syncthreads();   // every read of stage st and of the state's terms done
    if (ci + 1 < nc) store_terms();
  }

  float* out = final_state + sbase;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int n = (nb + t) * 8 + gc;
    *reinterpret_cast<float2*>(out + (size_t)(pm + gr) * N + n) =
        make_float2(sacc[t][0], sacc[t][1]);
    *reinterpret_cast<float2*>(out + (size_t)(pm + gr + 8) * N + n) =
        make_float2(sacc[t][2], sacc[t][3]);
  }
}

template <int P, int N>
cudaError_t launch_tc(const void* x, const void* dt, const void* A,
                      const void* Bm, const void* Cm, const void* D,
                      const void* init, void* y, void* fin, void* cst,
                      int B, int S, int H, int G, cudaStream_t stream) {
  auto kern = ssd_tc_kernel<P, N>;
  const size_t bytes = TcSmem<P, N>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  kern<<<B * H, kTThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(init), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(fin), static_cast<float*>(cst), S, H, G);
  return cudaGetLastError();
}

// the CUDA-core instances: fp32 at the served shapes, both types at the
// reduced (16, 16, 16)
template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, const void* D,
                     const void* init, void* y, void* fin, void* cst, int B,
                     int S, int H, int P, int G, int N, int Q,
                     cudaStream_t st) {
  if constexpr (sizeof(T) == 4) {
    if (Q == 128 && P == 64 && N == 128)
      return launch<T, 128, 64, 128>(x, dt, A, Bm, Cm, D, init, y, fin, cst, B, S,
                                     H, G, st);
    if (Q == 128 && P == 64 && N == 64)
      return launch<T, 128, 64, 64>(x, dt, A, Bm, Cm, D, init, y, fin, cst, B, S,
                                    H, G, st);
  }
  if (Q == 16 && P == 16 && N == 16)
    return launch<T, 16, 16, 16>(x, dt, A, Bm, Cm, D, init, y, fin, cst, B, S, H,
                                 G, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, y: [B,S,H,P]; B, C: [B,S,G,N] (dtype 0 = float32, 1 = bfloat16, shared
// by x, B, C and y); dt: [B,S,H], A, D: [H], init, final: [B,H,P,N] fp32;
// chunk_states: null, or [B,H,S/Q,P,N] fp32, which receives the state
// entering each chunk (the backward's input, when training).
// The tensor-core instances (bf16 at Q = 128, P = 64, N = 128 or 64) need
// x, B and C 16-byte aligned.
extern "C" int repro_ssd_fwd(const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* D,
                             const void* init, void* y, void* fin,
                             void* chunk_states, int B, int S, int H, int P,
                             int G, int N, int Q, int dtype, void* stream) {
  void* cst = chunk_states;
  if (B <= 0 || S <= 0 || Q <= 0 || S % Q || G <= 0 || H % G)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && Q == kTQ && P == 64 && (N == 128 || N == 64))
    return N == 128 ? (int)launch_tc<64, 128>(x, dt, A, Bm, Cm, D, init, y,
                                              fin, cst, B, S, H, G, st)
                    : (int)launch_tc<64, 64>(x, dt, A, Bm, Cm, D, init, y,
                                             fin, cst, B, S, H, G, st);
  cudaError_t err =
      dtype == 0 ? dispatch<float>(x, dt, A, Bm, Cm, D, init, y, fin, cst, B, S, H,
                                   P, G, N, Q, st)
      : dtype == 1 ? dispatch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, init, y,
                                             fin, cst, B, S, H, P, G, N,
                                             Q, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
