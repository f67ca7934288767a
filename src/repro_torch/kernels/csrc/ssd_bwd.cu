// Backward of the Mamba-2 chunked SSD scan, for training (no initial state
// and no gradient into the final state: a training sequence starts from
// zeros and its last state feeds nothing).
//
// Replaces no TPU kernel: the reference has no backward kernel for
// ssd_pallas (src/repro/kernels/ssd/kernel.py:68) and trains through its
// plain version.  The port launches a kernel for every CUDA tensor, so its
// gradient is a kernel too.
//
// Per chunk (cum the prefix sum of dt*A, h the state entering the chunk,
// saved by the forward, dh' the gradient of the state leaving it):
//   y_i = e^cum_i C_i.h + sum_{j<=i} (C_i.B_j) e^(cum_i-cum_j) dt_j x_j + D x_i
//   h'  = e^cum_last h + sum_j e^(cum_last-cum_j) dt_j x_j B_j^T
// so with w_j = dt_j e^(cum_last - cum_j), M_ij = (C_i.B_j) e^(cum_i-cum_j)
// dt_j and dM_ij = dy_i.x_j (j <= i):
//   dx_j = D dy_j + w_j (dh' B_j) + sum_i M_ij dy_i
//   dB_j = w_j (dh'^T x_j) + sum_i dM_ij e^(cum_i-cum_j) dt_j C_i
//   dC_i = e^cum_i (dy_i h) + sum_j dM_ij e^(cum_i-cum_j) dt_j B_j
//   dh   = e^cum_last dh' + sum_i e^cum_i dy_i C_i^T   (carried to the
//          chunk before)
// and the gradient of each cum, summed back over the prefix sum into
// d(dt*A), gives ddt and dA; dD = sum dy.x.
//
// Bound on the H100: operations.  About 8 Q*P*N-sized products a chunk
// (at zamba2-2.7b's training shape, B=4, S=2048, H=80, P=64, N=64, Q=128,
// ~40 GFLOP, ~0.6 ms at 67 TFLOP/s in fp32 on CUDA cores, ~40 us at
// 989 TFLOP/s); the bytes (x, dy, dx, B, C and their gradients, the saved
// chunk states) are ~0.2 GB, ~60 us.
//
// Design (the simple form, fp32 on CUDA cores): one block owns one (batch
// row, head) and walks its chunks in reverse, carrying dh.  The chunk's x,
// dy, B and C sit in shared memory in their own type (a lossless copy);
// dh' lives in a global scratch of the block, in both [P][N] and [N][P]
// order so that every product reads it along contiguous addresses, and
// the saved chunk state is read from global memory.  The quadratic
// intra-chunk terms run in passes of 16 query rows against the key rows
// on and below them.  dx, dB and dC accumulate in fp32 scratch that the
// block owns (dB and dC per head); a second kernel casts dx, adds dB and
// dC over the heads of each group and dA and dD over batch rows, in a
// fixed order, so two calls give the same bits (no atomics).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // a 16 x 16 thread grid
constexpr int kRB = 16;         // query rows a pass

template <typename T, int Q, int P, int N>
struct BwdLayout {
  // rows of x, dy (P) and B, C (N) in T, padded to an odd count of words
  static constexpr int kPad = sizeof(T) == 4 ? 1 : 2;
  static constexpr int XS = P + kPad, BS = N + kPad, SS = Q + 1;
  static constexpr size_t kOps =
      (2 * (size_t)Q * XS + 2 * (size_t)Q * BS) * sizeof(T);
  // three score rows of kRB x Q, seven per-token rows, a reduction row
  static constexpr size_t kFloats = 3 * (size_t)kRB * SS + 7 * (size_t)Q + 32;
  static constexpr size_t kBytes = (kOps + 15) / 16 * 16 + kFloats * 4;
};

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;
  const void* dy;
  const float* states;   // [B,H,nc,P,N] chunk start states
  float* dxf;            // [B,S,H,P]
  float* dBf;            // [B,S,H,N]
  float* dCf;            // [B,S,H,N]
  float* ddt;            // [B,S,H]
  float* dAp;            // [B,H]
  float* dDp;            // [B,H]
  float* dh;             // [B*H][P][N]
  float* dhT;            // [B*H][N][P]
  int S, H, G;
};

// sum over the 16 threads of a row of the thread grid (one half-warp)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sum over the block, in a fixed order, returned to every thread
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

template <typename T, int Q, int P, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_kernel(BwdArgs a) {
  using L = BwdLayout<T, Q, P, N>;
  constexpr int XS = L::XS, BS = L::BS, SS = L::SS;
  constexpr int QR = Q / 16, PC = P / 16, NC = N / 16;
  static_assert(Q % 16 == 0 && P % 16 == 0 && N % 16 == 0 && Q <= 128,
                "tile shapes");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);   // [Q][XS]
  T* dys = xs + Q * XS;                     // [Q][XS]
  T* bs = dys + Q * XS;                     // [Q][BS]
  T* cs = bs + Q * BS;                      // [Q][BS]
  float* fl = reinterpret_cast<float*>(smem_raw + (L::kOps + 15) / 16 * 16);
  float* sM = fl;                 // [kRB][SS] M_ij
  float* sdG = sM + kRB * SS;     // [kRB][SS] dM_ij e^(cum_i-cum_j) dt_j
  float* sE = sdG + kRB * SS;     // [kRB][SS] (C_i.B_j) e^(cum_i-cum_j) dM_ij
  float* dts = sE + kRB * SS;     // [Q]
  float* cum = dts + Q;
  float* ecum = cum + Q;
  float* wend = ecum + Q;
  float* dcum = wend + Q;
  float* ddts = dcum + Q;
  float* dwj = ddts + Q;
  float* red = dwj + Q;           // [32]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x, H = a.H, S = a.S, G = a.G;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int nc = S / Q;
  const float Ah = a.A[h], Dh = a.D[h];
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);
  float* dh = a.dh + (size_t)bh * P * N;
  float* dhT = a.dhT + (size_t)bh * P * N;
  for (int e = tid; e < P * N; e += kThreads) dh[e] = dhT[e] = 0.0f;
  float dA_acc = 0.0f, dD_acc = 0.0f;
  auto f = [](T v) { return repro::to_f32(v); };

  for (int ci = nc - 1; ci >= 0; --ci) {
    const int t0 = ci * Q;
    __syncthreads();   // the previous chunk's readers and dh writes are done
    for (int e = tid; e < Q * P; e += kThreads) {
      const int i = e / P, p = e % P;
      const size_t off = (((size_t)b * S + t0 + i) * H + h) * P + p;
      xs[i * XS + p] = x[off];
      dys[i * XS + p] = dy[off];
    }
    for (int e = tid; e < Q * N; e += kThreads) {
      const int i = e / N, n = e % N;
      const size_t off = (((size_t)b * S + t0 + i) * G + g) * N + n;
      bs[i * BS + n] = Bm[off];
      cs[i * BS + n] = Cm[off];
    }
    for (int i = tid; i < Q; i += kThreads) {
      dts[i] = a.dt[((size_t)b * S + t0 + i) * H + h];
      dcum[i] = ddts[i] = 0.0f;
    }
    __syncthreads();
    if (tid < 32) {
      // inclusive prefix sum of dt*A, as the forward takes it
      constexpr int kPer = Q / 32 > 0 ? Q / 32 : 1;
      float v[kPer];
      float run = 0.0f;
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int i = tid * kPer + r;
        run += (i < Q ? dts[i] : 0.0f) * Ah;
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
    const float last = cum[Q - 1], elast = expf(last);
    for (int i = tid; i < Q; i += kThreads) {
      ecum[i] = expf(cum[i]);
      wend[i] = dts[i] * expf(last - cum[i]);
    }
    __syncthreads();
    const float* hc = a.states + ((size_t)bh * nc + ci) * P * N;

    // (1) dx_j = D dy_j + w_j (dh' B_j); dw_j = x_j . (dh' B_j)
    {
      float acc[QR][PC];
#pragma unroll
      for (int r = 0; r < QR; ++r)
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[r][c] = 0.0f;
#pragma unroll 2
      for (int n = 0; n < N; ++n) {
        float bv[QR], hv[PC];
#pragma unroll
        for (int r = 0; r < QR; ++r) bv[r] = f(bs[(ty + 16 * r) * BS + n]);
#pragma unroll
        for (int c = 0; c < PC; ++c) hv[c] = dhT[n * P + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < QR; ++r)
#pragma unroll
          for (int c = 0; c < PC; ++c) acc[r][c] = fmaf(bv[r], hv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < QR; ++r) {
        const int j = ty + 16 * r;
        float dw = 0.0f;
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const int p = tx + 16 * c;
          const float xv = f(xs[j * XS + p]), yv = f(dys[j * XS + p]);
          dw = fmaf(xv, acc[r][c], dw);
          dD_acc = fmaf(xv, yv, dD_acc);
          a.dxf[(((size_t)b * S + t0 + j) * H + h) * P + p] =
              Dh * yv + wend[j] * acc[r][c];
        }
        dw = row_sum(dw);
        if (tx == 0) dwj[j] = dw;
      }
    }
    // (2) dB_j = w_j (dh'^T x_j)
    {
      float acc[QR][NC];
#pragma unroll
      for (int r = 0; r < QR; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;
#pragma unroll 2
      for (int p = 0; p < P; ++p) {
        float xv[QR], hv[NC];
#pragma unroll
        for (int r = 0; r < QR; ++r) xv[r] = f(xs[(ty + 16 * r) * XS + p]);
#pragma unroll
        for (int c = 0; c < NC; ++c) hv[c] = dh[p * N + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < QR; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(xv[r], hv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < QR; ++r) {
        const int j = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          a.dBf[(((size_t)b * S + t0 + j) * H + h) * N + tx + 16 * c] =
              wend[j] * acc[r][c];
      }
    }
    // (3) dC_i = e^cum_i (dy_i h); dcum_i = C_i . dC_i so far
    {
      float acc[QR][NC];
#pragma unroll
      for (int r = 0; r < QR; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;
#pragma unroll 2
      for (int p = 0; p < P; ++p) {
        float yv[QR], hv[NC];
#pragma unroll
        for (int r = 0; r < QR; ++r) yv[r] = f(dys[(ty + 16 * r) * XS + p]);
#pragma unroll
        for (int c = 0; c < NC; ++c) hv[c] = hc[p * N + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < QR; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(yv[r], hv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < QR; ++r) {
        const int i = ty + 16 * r;
        float dc = 0.0f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int n = tx + 16 * c;
          const float v = ecum[i] * acc[r][c];
          dc = fmaf(f(cs[i * BS + n]), v, dc);
          a.dCf[(((size_t)b * S + t0 + i) * H + h) * N + n] = v;
        }
        dc = row_sum(dc);
        if (tx == 0) dcum[i] = dc;
      }
    }
    // (4) the last cum's gradient through the state: e^cum_last <dh', h>
    float hdot = 0.0f;
    for (int e = tid; e < P * N; e += kThreads) hdot = fmaf(dh[e], hc[e], hdot);
    hdot = elast * block_sum(hdot, red);   // its barriers order (1)-(3) too

    // (5) the intra-chunk terms, kRB query rows a pass
    for (int rb = 0; rb < Q / kRB; ++rb) {
      const int i = rb * kRB + ty, jend = (rb + 1) * kRB;
      const int cm = rb + 1;            // 16-column tiles on or below the rows
      float gv[QR], mv[QR];
#pragma unroll
      for (int c = 0; c < QR; ++c) gv[c] = mv[c] = 0.0f;
#pragma unroll 2
      for (int n = 0; n < N; ++n) {
        const float cv = f(cs[i * BS + n]);
#pragma unroll
        for (int c = 0; c < QR; ++c)
          if (c < cm) gv[c] = fmaf(cv, f(bs[(tx + 16 * c) * BS + n]), gv[c]);
      }
#pragma unroll 2
      for (int p = 0; p < P; ++p) {
        const float yv = f(dys[i * XS + p]);
#pragma unroll
        for (int c = 0; c < QR; ++c)
          if (c < cm) mv[c] = fmaf(yv, f(xs[(tx + 16 * c) * XS + p]), mv[c]);
      }
      float rsum = 0.0f;
#pragma unroll
      for (int c = 0; c < QR; ++c) {
        if (c >= cm) continue;
        const int j = tx + 16 * c;
        float m = 0.0f, dg = 0.0f, e = 0.0f;
        if (j <= i) {
          const float l = expf(cum[i] - cum[j]);
          m = gv[c] * l * dts[j];
          dg = mv[c] * l * dts[j];
          e = gv[c] * l * mv[c];
          rsum = fmaf(m, mv[c], rsum);
        }
        sM[ty * SS + j] = m;
        sdG[ty * SS + j] = dg;
        sE[ty * SS + j] = e;
      }
      rsum = row_sum(rsum);
      if (tx == 0) dcum[i] += rsum;
      __syncthreads();
      if (tid < jend) {
        float cs_ = 0.0f;
#pragma unroll
        for (int ii = 0; ii < kRB; ++ii) cs_ += sE[ii * SS + tid];
        ddts[tid] += cs_;
        dcum[tid] -= dts[tid] * cs_;
      }
      // dx_j += sum_i M_ij dy_i and dB_j += sum_i dG_ij C_i, rows j < jend
      for (int r = 0; r <= rb && r < QR; ++r) {
        const int j = ty + 16 * r;
        float ax[PC], ab[NC];
#pragma unroll
        for (int c = 0; c < PC; ++c) ax[c] = 0.0f;
#pragma unroll
        for (int c = 0; c < NC; ++c) ab[c] = 0.0f;
#pragma unroll 4
        for (int ii = 0; ii < kRB; ++ii) {
          const float m = sM[ii * SS + j], dg = sdG[ii * SS + j];
          const int ir = rb * kRB + ii;
#pragma unroll
          for (int c = 0; c < PC; ++c)
            ax[c] = fmaf(m, f(dys[ir * XS + tx + 16 * c]), ax[c]);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            ab[c] = fmaf(dg, f(cs[ir * BS + tx + 16 * c]), ab[c]);
        }
        const size_t row = ((size_t)b * S + t0 + j) * H + h;
#pragma unroll
        for (int c = 0; c < PC; ++c) a.dxf[row * P + tx + 16 * c] += ax[c];
#pragma unroll
        for (int c = 0; c < NC; ++c) a.dBf[row * N + tx + 16 * c] += ab[c];
      }
      // dC_i += sum_j dG_ij B_j for this pass's rows
      {
        float ac[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) ac[c] = 0.0f;
        for (int j = 0; j < jend; ++j) {
          const float dg = sdG[ty * SS + j];
#pragma unroll
          for (int c = 0; c < NC; ++c)
            ac[c] = fmaf(dg, f(bs[j * BS + tx + 16 * c]), ac[c]);
        }
        const size_t row = ((size_t)b * S + t0 + i) * H + h;
#pragma unroll
        for (int c = 0; c < NC; ++c) a.dCf[row * N + tx + 16 * c] += ac[c];
      }
      __syncthreads();
    }

    // (6) per token: the state terms of dt and cum, then back through the
    // prefix sum: da_j = sum_{i>=j} dcum_i, ddt_j += A da_j, dA += dt_j da_j
    if (tid < 32) {
      constexpr int kPer = Q / 32 > 0 ? Q / 32 : 1;
      float wsum = 0.0f;
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int j = tid * kPer + r;
        if (j < Q) {
          ddts[j] += expf(last - cum[j]) * dwj[j];
          dcum[j] -= wend[j] * dwj[j];
          wsum = fmaf(wend[j], dwj[j], wsum);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        wsum += __shfl_xor_sync(0xffffffffu, wsum, off);
      __syncwarp();
      if (tid == 0) dcum[Q - 1] += hdot + wsum;
      __syncwarp();
      // reverse inclusive scan, kPer tokens a lane from the end
      float v[kPer];
      float run = 0.0f;
#pragma unroll
      for (int r = kPer - 1; r >= 0; --r) {
        const int j = tid * kPer + r;
        run += j < Q ? dcum[j] : 0.0f;
        v[r] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float dn = __shfl_down_sync(0xffffffffu, incl, off);
        if (tid + off < 32) incl += dn;
      }
      const float after = incl - run;   // the lanes above this one
      float da_dt = 0.0f;
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int j = tid * kPer + r;
        if (j < Q) {
          const float da = after + v[r];
          const float d = ddts[j] + Ah * da;
          a.ddt[((size_t)b * S + t0 + j) * H + h] = d;
          da_dt = fmaf(dts[j], da, da_dt);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        da_dt += __shfl_xor_sync(0xffffffffu, da_dt, off);
      dA_acc += da_dt;
    }

    // (7) dh = e^cum_last dh' + sum_i e^cum_i dy_i C_i^T, for the chunk before
    {
      float acc[PC][NC];
#pragma unroll
      for (int r = 0; r < PC; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[r][c] = elast * dh[(ty + 16 * r) * N + tx + 16 * c];
#pragma unroll 2
      for (int i = 0; i < Q; ++i) {
        const float e = ecum[i];
        float yv[PC], cv[NC];
#pragma unroll
        for (int r = 0; r < PC; ++r) yv[r] = e * f(dys[i * XS + ty + 16 * r]);
#pragma unroll
        for (int c = 0; c < NC; ++c) cv[c] = f(cs[i * BS + tx + 16 * c]);
#pragma unroll
        for (int r = 0; r < PC; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(yv[r], cv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < PC; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int p = ty + 16 * r, n = tx + 16 * c;
          dh[p * N + n] = acc[r][c];
          dhT[n * P + p] = acc[r][c];
        }
    }
  }
  const float dd = block_sum(dD_acc, red);
  if (tid == 0) {
    a.dAp[bh] = dA_acc;
    a.dDp[bh] = dd;
  }
}

// dx in T; dB, dC summed over the heads of each group in order; dA, dD
// summed over batch rows in order.  One block a (batch row, step).
template <typename T>
__global__ void ssd_bwd_finish(const float* __restrict__ dxf,
                               const float* __restrict__ dBf,
                               const float* __restrict__ dCf,
                               const float* __restrict__ dAp,
                               const float* __restrict__ dDp, T* dx, T* dB,
                               T* dC, float* dA, float* dD, int Bn, int H,
                               int P, int G, int N) {
  const size_t row = blockIdx.x;
  for (int e = threadIdx.x; e < H * P; e += blockDim.x)
    dx[row * H * P + e] = repro::from_f32<T>(dxf[row * H * P + e]);
  const int hg = H / G;
  for (int e = threadIdx.x; e < G * N; e += blockDim.x) {
    const int g = e / N, n = e % N;
    float sb = 0.0f, sc = 0.0f;
    for (int k = 0; k < hg; ++k) {
      const size_t at = (row * H + g * hg + k) * N + n;
      sb += dBf[at];
      sc += dCf[at];
    }
    dB[row * G * N + e] = repro::from_f32<T>(sb);
    dC[row * G * N + e] = repro::from_f32<T>(sc);
  }
  if (row == 0) {
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float sa = 0.0f, sd = 0.0f;
      for (int b = 0; b < Bn; ++b) {
        sa += dAp[b * H + h];
        sd += dDp[b * H + h];
      }
      dA[h] = sa;
      dD[h] = sd;
    }
  }
}

template <typename T, int Q, int P, int N>
cudaError_t launch(const BwdArgs& a, void* dx, void* dB, void* dC, void* dA,
                   void* dD, int B, cudaStream_t st) {
  auto kern = ssd_bwd_kernel<T, Q, P, N>;
  constexpr size_t bytes = BwdLayout<T, Q, P, N>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  kern<<<B * a.H, kThreads, bytes, st>>>(a);
  ssd_bwd_finish<T><<<B * a.S, 256, 0, st>>>(
      a.dxf, a.dBf, a.dCf, a.dAp, a.dDp, static_cast<T*>(dx),
      static_cast<T*>(dB), static_cast<T*>(dC), static_cast<float*>(dA),
      static_cast<float*>(dD), B, a.H, P, a.G, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const BwdArgs& a, void* dx, void* dB, void* dC,
                     void* dA, void* dD, int B, int P, int N, int Q,
                     cudaStream_t st) {
  if (Q == 128 && P == 64 && N == 128)
    return launch<T, 128, 64, 128>(a, dx, dB, dC, dA, dD, B, st);
  if (Q == 128 && P == 64 && N == 64)
    return launch<T, 128, 64, 64>(a, dx, dB, dC, dA, dD, B, st);
  if (Q == 16 && P == 16 && N == 16)
    return launch<T, 16, 16, 16>(a, dx, dB, dC, dA, dD, B, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, dy, dx: [B,S,H,P]; Bm, Cm, dB, dC: [B,S,G,N] (dtype 0 = float32,
// 1 = bfloat16, shared by all of them); dt, ddt: [B,S,H], A, D, dA, dD: [H]
// and states (the forward's chunk start states, [B,H,S/Q,P,N]) fp32.
// Scratch, fp32: dxf [B,S,H,P], dBf and dCf [B,S,H,N], dAp and dDp [B,H],
// dh and dhT [B,H,P,N].
extern "C" int repro_ssd_bwd(const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* D,
                             const void* dy, const void* states, void* dx,
                             void* ddt, void* dA, void* dB, void* dC,
                             void* dD, void* dxf, void* dBf, void* dCf,
                             void* dAp, void* dDp, void* dh, void* dhT,
                             int B, int S, int H, int P, int G, int N, int Q,
                             int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Q <= 0 || S % Q || G <= 0 || H % G)
    return (int)cudaErrorInvalidValue;
  BwdArgs a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
            Bm, Cm, static_cast<const float*>(D), dy,
            static_cast<const float*>(states), static_cast<float*>(dxf),
            static_cast<float*>(dBf), static_cast<float*>(dCf),
            static_cast<float*>(ddt), static_cast<float*>(dAp),
            static_cast<float*>(dDp), static_cast<float*>(dh),
            static_cast<float*>(dhT), S, H, G};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? dispatch<float>(a, dx, dB, dC, dA, dD, B, P, N, Q, st)
      : dtype == 1 ? dispatch<__nv_bfloat16>(a, dx, dB, dC, dA, dD, B, P, N,
                                             Q, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
