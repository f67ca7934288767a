// Mamba-2 chunked SSD scan (state-space dual form), for prefill.
//
// Replaces the TPU kernel ssd_pallas (src/repro/kernels/ssd/kernel.py:68,
// body _ssd_kernel :25).
//
// Bound on the H100: at mamba2-2.7b's shapes (B=4, S=256, H=80, P=64,
// N=128, chunk Q=128) the scan moves about 43 MB and does about 6.7 GFLOP;
// in fp32 outside the tensor cores the operations bound it (~0.1 ms at
// 67 TFLOP/s), against ~13 us for the bytes.  This first kernel computes
// on the CUDA cores in fp32; moving the three chunk products onto wgmma
// is later work.
//
// Design: the TPU iterates chunks along a sequential grid axis and keeps
// the [P,N] state in VMEM scratch.  Blocks here run in no order, so one
// block owns one (batch row, head) and loops over the chunks itself; the
// fp32 state (32 KB) stays in shared memory for the whole sequence and
// is read from and written to device memory once.  Per chunk the block
// stages x [Q,P], B and C [Q,N] (fp32) and dt [Q] in shared memory, takes
// the prefix sum of dt*A with one warp, and then computes
//   y   = exp(cum) * (C . state^T) + D*x                 (inter-chunk)
//       + ((C B^T) (.) L (.) dt) x                        (intra-chunk)
//   state = state * exp(cum_last) + (x (.) dt*exp(cum_last - cum))^T B
// as in _ssd_kernel :42-61.  Each of the four products is a small matrix
// product out of shared memory; the 256 threads form a 16x16 grid and each
// computes a register tile (rows ty + 16r, columns tx + 16c), so one
// shared-memory load feeds several multiply-adds instead of one.  The QxQ
// score matrix is built 32 rows at a time (16 KB) and consumed at once,
// and blocks above the diagonal are skipped, which keeps the block's shared
// memory near 215 KB at N=128 (mamba2-2.7b) and 136 KB at N=64
// (zamba2-2.7b).  Rows of B, C and the state are padded by one float
// so that threads reading down a column hit distinct banks.
#include "common.cuh"

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
           float* __restrict__ final_state, int S, int H, int G) {
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
                   const void* init, void* y, void* fin, int B, int S, int H,
                   int G, cudaStream_t stream) {
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
      static_cast<float*>(fin), S, H, G);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, const void* D,
                     const void* init, void* y, void* fin, int B, int S,
                     int H, int P, int G, int N, int Q, cudaStream_t st) {
  if (Q == 128 && P == 64 && N == 128)
    return launch<T, 128, 64, 128>(x, dt, A, Bm, Cm, D, init, y, fin, B, S,
                                   H, G, st);
  if (Q == 128 && P == 64 && N == 64)
    return launch<T, 128, 64, 64>(x, dt, A, Bm, Cm, D, init, y, fin, B, S,
                                  H, G, st);
  if (Q == 16 && P == 16 && N == 16)
    return launch<T, 16, 16, 16>(x, dt, A, Bm, Cm, D, init, y, fin, B, S, H,
                                 G, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, y: [B,S,H,P]; B, C: [B,S,G,N] (dtype 0 = float32, 1 = bfloat16, shared
// by x, B, C and y); dt: [B,S,H], A, D: [H], init, final: [B,H,P,N] fp32.
extern "C" int repro_ssd_fwd(const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* D,
                             const void* init, void* y, void* fin, int B,
                             int S, int H, int P, int G, int N, int Q,
                             int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Q <= 0 || S % Q || G <= 0 || H % G)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? dispatch<float>(x, dt, A, Bm, Cm, D, init, y, fin, B, S, H,
                                   P, G, N, Q, st)
      : dtype == 1 ? dispatch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, init, y,
                                             fin, B, S, H, P, G, N, Q, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
