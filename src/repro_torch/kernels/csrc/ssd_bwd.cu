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
// Bound on the H100: bytes.  About 8 Q*P*N-sized products a chunk (at
// zamba2-2.7b's training shape, B=4, S=2048, H=80, P=64, N=64, Q=128,
// ~40 GFLOP, ~40 us at 989 TFLOP/s in bf16); the bytes (x, dy, dx, B, C
// and their gradients, the saved chunk states) are ~0.35 GB, ~0.1 ms.
//
// bf16 at (Q, P, N) = (128, 64, 128) and (128, 64, 64) (mamba2-2.7b,
// zamba2-2.7b): the serial walk over chunks is split so that only a cheap
// part of it is serial, as Mamba-2's own backward is organised, in four
// launches on tensor cores (mma.sync m16n8k16, bf16 operands, fp32
// accumulate; ldmatrix from rows padded by 16 bytes; cp.async loads;
// decays as ex2.approx with cum log2 e kept per token, as the forward):
// - local, parallel over (batch row, chunk, slice of up to 8 heads of one
//   group): U_c = sum_i e^cum_i dy_i^T C_i [P,N] of each head, C loaded
//   once for the slice, and e^cum_last;
// - state, serial over chunks only, parallel over (batch row, head, P x N
//   elements): dh'_{nc-1} = 0, dh'_{c-1} = e^cum_last,c dh'_c + U_c, in
//   place of the U's ([B,H,nc,P,N] fp32, the size of the saved states);
// - chunk, parallel over (batch row, chunk, slice): every gradient of the
//   chunk from h_c and dh'_c (ssd_bwd_chunk below).  dx goes straight to
//   its bf16 output; dB and dC sum over the slice's heads in head order
//   into one fp32 partial a block, dA and dD into partials per (batch
//   row, chunk, head);
// - finish: the partials summed in a fixed order.
// Each output has one writer and every sum one order, so two calls give
// the same bits (no atomics).  Every fp32 operand of a product (the
// states h_c and dh'_c, the masked and decayed score blocks, e^cum dy) is
// one bf16 term: split into hi + lo terms, as the forward splits its own,
// each costs time and none is needed for the whole gradient's 3% limit
// (scripts/kernel_variants.py bwd_ssd_operands: 0.11 of the limit split,
// 0.23 as one term, and 11% faster; the forward's per-row limit on y is
// what needs its splits).  Sums stay fp32: the products' accumulators,
// the state pass's carry, the per-token scans.
//
// Other instances (fp32, and the reduced (16, 16, 16) test shape): the
// simple form, fp32 on CUDA cores.  One block owns one (batch row, head)
// and walks its chunks in reverse, carrying dh.  The chunk's x, dy, B and
// C sit in shared memory in their own type (a lossless copy); dh' lives
// in a global scratch of the block, in both [P][N] and [N][P] order so
// that every product reads it along contiguous addresses, and the saved
// chunk state is read from global memory.  The quadratic intra-chunk
// terms run in passes of 16 query rows against the key rows on and below
// them.  dx, dB and dC accumulate in fp32 scratch that the block owns (dB
// and dC per head); a second kernel casts dx, adds dB and dC over the
// heads of each group and dA and dD over batch rows, in a fixed order.
#include "common.cuh"
#include "mma.cuh"

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
  if constexpr (sizeof(T) == 4) {   // bf16 at these shapes: tensor cores
    if (Q == 128 && P == 64 && N == 128)
      return launch<T, 128, 64, 128>(a, dx, dB, dC, dA, dD, B, st);
    if (Q == 128 && P == 64 && N == 64)
      return launch<T, 128, 64, 64>(a, dx, dB, dC, dA, dD, B, st);
  }
  if (Q == 16 && P == 16 && N == 16)
    return launch<T, 16, 16, 16>(a, dx, dB, dC, dA, dD, B, st);
  return cudaErrorInvalidValue;
}

// ------------------------------------------ bf16 on tensor cores

constexpr int kTQ = 128;          // chunk
constexpr int kTWarps = 8;
constexpr int kTThreads = kTWarps * 32;
constexpr int kMaxSlice = 8;      // heads a local or chunk block walks
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// the heads of one block: the most, up to 8, that divide a group's heads,
// so a block's heads share B and C (mirrored by ssd/ops.py: ssd_bwd_plan)
inline int slice_heads(int H, int G) {
  const int hg = H / G;
  for (int hs = hg < kMaxSlice ? hg : kMaxSlice; hs > 1; --hs)
    if (hg % hs == 0) return hs;
  return 1;
}

// shared memory of the local and chunk passes (bf16 rows padded by 8
// elements; mirrored by ssd/ops.py: ssd_bwd_plan)
template <int P, int N>
struct TcBwdSmem {
  static constexpr int XS = P + 8, BS = N + 8;
  // local: C [Q][BS], dy [Q][XS]; dt and exp(cum) [Q] fp32
  static constexpr size_t kLocalBytes =
      ((size_t)kTQ * BS + (size_t)kTQ * XS) * 2 + 2 * (size_t)kTQ * 4;
  // chunk: B, C [Q][BS], x, dy [Q][XS], dh' and h [P][BS] in bf16; dt,
  // (cum log2 e, dt), exp(cum), w, exp(cum_last - cum), dcum, ddt, w dw
  // [Q] fp32 (nine rows); 16 reduction slots
  static constexpr size_t kChunkBytes =
      (2 * (size_t)kTQ * BS + 2 * (size_t)kTQ * XS + 2 * (size_t)P * BS) *
          2 + 9 * (size_t)kTQ * 4 + 16 * 4;
};

struct TcBwdArgs {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* Bm;
  const bf16* Cm;
  const float* D;
  const bf16* dy;
  const float* states;   // [B,H,nc,P,N] chunk start states h_c
  float* dhs;            // [B,H,nc,P,N]: U_c, then dh'_c
  float* elast;          // [B,H,nc]: exp(cum_last) of each chunk
  bf16* dx;              // [B,S,H,P]
  float* ddt;            // [B,S,H]
  float* dBp;            // [B,S,H/hs,N] partials of the heads of a block
  float* dCp;
  float* dAp;            // [B,nc,H]
  float* dDp;
  int S, H, G, hs;
};

// warp 0: the chunk's inclusive prefix sum of dt * a, four tokens a lane
// (the forward's order), times log2 e; returns the last token's
__device__ __forceinline__ float chunk_cum2(const float* dts, float a,
                                           int lane, float (&c2)[4]) {
  float v[4];
  float run = 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    run += dts[lane * 4 + r] * a;
    v[r] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  const float base = incl - run;
#pragma unroll
  for (int r = 0; r < 4; ++r) c2[r] = (base + v[r]) * kLog2e;
  return __shfl_sync(0xffffffffu, c2[3], 31);
}

// (1) the local pass: U_c = sum_i e^cum_i dy_i^T C_i [P,N] of one chunk
// for each head of the block (e^cum dy rounded to bf16), into dhs, and
// e^cum_last into elast
template <int P, int N>
__global__ void __launch_bounds__(kTThreads, 1) ssd_bwd_local(TcBwdArgs a) {
  using L = TcBwdSmem<P, N>;
  constexpr int Q = kTQ, XS = L::XS, BS = L::BS;
  constexpr int MT = P / 16;          // m-tiles of U
  constexpr int WN = kTWarps / MT;    // warps sharing one m-tile
  constexpr int NT = N / 8 / WN;      // n-tiles a warp owns
  static_assert(kTWarps % MT == 0 && (N / 8) % WN == 0 && NT % 2 == 0,
                "tile shapes");
  using repro::mma_bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);   // [Q][BS]
  bf16* dys = cs + Q * BS;                        // [Q][XS]
  float* dts = reinterpret_cast<float*>(dys + Q * XS);
  float* ecum = dts + Q;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, gc = (lane & 3) * 2;
  const int S = a.S, H = a.H, G = a.G, nc = S / Q, nsl = H / a.hs;
  int i = blockIdx.x;
  const int sl = i % nsl;
  i /= nsl;
  const int c = i % nc, b = i / nc;
  const int t0 = c * Q, h0 = sl * a.hs, g = h0 / (H / G);
  for (int e = tid; e < Q * N / 8; e += kTThreads) {
    const int r = e / (N / 8), v = e % (N / 8);
    repro::cp_async16(cs + r * BS + v * 8,
                      a.Cm + (((size_t)b * S + t0 + r) * G + g) * N + v * 8,
                      16);
  }
  const int pm = (warp % MT) * 16, nb = (warp / MT) * NT;
  for (int hh = 0; hh < a.hs; ++hh) {
    const int h = h0 + hh;
    for (int e = tid; e < Q * P / 8; e += kTThreads) {
      const int r = e / (P / 8), v = e % (P / 8);
      repro::cp_async16(dys + r * XS + v * 8,
                        a.dy + (((size_t)b * S + t0 + r) * H + h) * P + v * 8,
                        16);
    }
    repro::cp_async_commit();
    if (tid < Q) dts[tid] = a.dt[((size_t)b * S + t0 + tid) * H + h];
    repro::cp_async_wait<0>();
    __syncthreads();
    if (warp == 0) {
      float c2[4];
      const float last2 = chunk_cum2(dts, a.A[h], lane, c2);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        ecum[lane * 4 + r] = repro::exp2_approx(c2[r]);
      if (lane == 0)
        a.elast[((size_t)b * H + h) * nc + c] = repro::exp2_approx(last2);
    }
    __syncthreads();
    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
      acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
#pragma unroll 2
    for (int kk = 0; kk < Q / 16; ++kk) {
      // (e^cum dy)^T rows pm.., tokens kk*16.. as the A operand
      uint32_t yr[4], a[4];
      repro::ldmatrix_x4_trans(
          yr, dys + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * XS + pm +
                  ((lane >> 3) & 1) * 8);
      const int j0 = kk * 16 + gc;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + (q >> 1) * 8;
        const float2 yv = repro::unpack_bf16(yr[q]);
        a[q] = repro::pack_bf16(yv.x * ecum[j], yv.y * ecum[j + 1]);
      }
      const bf16* crow = cs + (kk * 16 + (lane & 7) +
                               ((lane >> 3) & 1) * 8) * BS + nb * 8 +
                         (lane >> 4) * 8;
#pragma unroll
      for (int t = 0; t < NT; t += 2) {
        uint32_t r[4];
        repro::ldmatrix_x4_trans(r, crow + t * 8);
        mma_bf16(acc[t], a, r[0], r[1]);
        mma_bf16(acc[t + 1], a, r[2], r[3]);
      }
    }
    float* out = a.dhs + (((size_t)b * H + h) * nc + c) * P * N;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int n = (nb + t) * 8 + gc;
      *reinterpret_cast<float2*>(out + (size_t)(pm + gr) * N + n) =
          make_float2(acc[t][0], acc[t][1]);
      *reinterpret_cast<float2*>(out + (size_t)(pm + gr + 8) * N + n) =
          make_float2(acc[t][2], acc[t][3]);
    }
    __syncthreads();   // dy, dt and exp(cum) read before the next head's
  }
}

// (2) the state pass, serial over chunks only: walking back from the last
// chunk, dh'_{nc-1} = 0 and dh'_{c-1} = e^cum_last,c dh'_c + U_c, in
// place of U_c.  One thread owns four elements of one (batch row, head)'s
// P x N; eight chunks' U are read ahead of their carries.
__global__ void ssd_bwd_state(float* __restrict__ dhs,
                              const float* __restrict__ elast, int nc,
                              int pn4, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long bh = idx / pn4;
  float4* col = reinterpret_cast<float4*>(dhs) + bh * nc * pn4 + idx % pn4;
  const float* el = elast + bh * nc;
  float4 carry = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c1 = nc; c1 > 0; c1 -= 8) {
    const int c0 = c1 > 8 ? c1 - 8 : 0;
    float4 u[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (c0 + r < c1) u[r] = col[(size_t)(c0 + r) * pn4];
#pragma unroll
    for (int r = 7; r >= 0; --r) {
      if (c0 + r >= c1) continue;
      col[(size_t)(c0 + r) * pn4] = carry;
      const float e = el[c0 + r];
      carry = make_float4(fmaf(e, carry.x, u[r].x), fmaf(e, carry.y, u[r].y),
                          fmaf(e, carry.z, u[r].z), fmaf(e, carry.w, u[r].w));
    }
  }
}

// acc[8][4] += rows r0 .. r0 + 15 of a [Q][XS] bf16 operand times columns
// n0 .. n0 + 63 of a [P][BS] bf16 state
template <int P, int XS, int BS>
__device__ __forceinline__ void rows_x_state(float (&acc)[8][4],
                                             const bf16* a, int r0,
                                             const bf16* st, int n0,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < P / 16; ++kk) {
    uint32_t af[4];
    repro::ldmatrix_x4(af, a + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   XS + kk * 16 + (lane >> 4) * 8);
    const int off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * BS +
                    n0 + (lane >> 4) * 8;
#pragma unroll
    for (int t = 0; t < 8; t += 2) {
      uint32_t r[4];
      repro::ldmatrix_x4_trans(r, st + off + t * 8);
      repro::mma_bf16(acc[t], af, r[0], r[1]);
      repro::mma_bf16(acc[t + 1], af, r[2], r[3]);
    }
  }
}

// a 16 x 16 block: acc = rows r0.. of a [Q][LD] operand times rows c0.. of
// another (K-major both), over K columns
template <int K, int LD>
__device__ __forceinline__ void block16(float (&acc)[2][4], const bf16* a,
                                        int r0, const bf16* bm, int c0,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4], r[4];
    repro::ldmatrix_x4(af, a + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   LD + kk * 16 + (lane >> 4) * 8);
    repro::ldmatrix_x4(r, bm + (c0 + (lane & 7) + (lane >> 4) * 8) * LD +
                              ((lane >> 3) & 1) * 8 + kk * 16);
    repro::mma_bf16(acc[0], af, r[0], r[1]);
    repro::mma_bf16(acc[1], af, r[2], r[3]);
  }
}

// a 16 x 16 fp32 block (accumulator layout) as the bf16 A operand
__device__ __forceinline__ void pack_a(const float (&x)[2][4],
                                       uint32_t (&a)[4]) {
  a[0] = repro::pack_bf16(x[0][0], x[0][1]);
  a[1] = repro::pack_bf16(x[0][2], x[0][3]);
  a[2] = repro::pack_bf16(x[1][0], x[1][1]);
  a[3] = repro::pack_bf16(x[1][2], x[1][3]);
}

// acc[T][4] += a 16-row A operand times rows k0 .. k0 + 15 of a [Q][LD]
// bf16 operand (N-major), its first 8 T columns
template <int T, int LD>
__device__ __forceinline__ void a_x_rows(float (&acc)[T][4],
                                         const uint32_t (&a)[4],
                                         const bf16* bm, int k0, int lane) {
  const bf16* row =
      bm + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int t = 0; t < T; t += 2) {
    uint32_t r[4];
    repro::ldmatrix_x4_trans(r, row + t * 8);
    repro::mma_bf16(acc[t], a, r[0], r[1]);
    repro::mma_bf16(acc[t + 1], a, r[2], r[3]);
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// (3) the chunk pass: every gradient of one chunk for each head of the
// block, from h_c (saved by the forward) and dh'_c (the state pass's).
// Warp w owns rows 16 w .. 16 w + 15 of the chunk for every output: dx
// (straight to bf16), and dB, dC summed over the block's heads in head
// order (one fp32 partial a block).  Per head, with w_j = dt_j
// e^(cum_last - cum_j), the products of ssd_bwd_kernel's (1)-(7) on
// tensor cores: dB += w (x dh'), dC += e^cum (dy h), dx = D dy + w (B
// dh'^T); then, as rows i, G = C B^T and dM = dy x^T of the blocks on and
// below the diagonal, dG = dM L dt_j and dC += dG B; as rows j, G^T and
// dM^T of the blocks on and right of it, dx += M^T dy and dB += dG^T C.
// The states and every fp32 score block enter the products rounded to
// bf16.  Per token the gradients of dt and cum, the chunk's reverse
// prefix sum, and the partials of dA and dD.
template <int P, int N>
__global__ void __launch_bounds__(kTThreads, 1) ssd_bwd_chunk(TcBwdArgs a) {
  using L = TcBwdSmem<P, N>;
  constexpr int Q = kTQ, XS = L::XS, BS = L::BS;
  constexpr int NT = N / 8, PT = P / 8, QT = Q / 16;
  static_assert(QT == kTWarps && N % 64 == 0 && P % 16 == 0, "tile shapes");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* bs = reinterpret_cast<bf16*>(smem_raw);   // [Q][BS]
  bf16* cs = bs + Q * BS;                         // [Q][BS]
  bf16* xs = cs + Q * BS;                         // [Q][XS]
  bf16* dys = xs + Q * XS;                        // [Q][XS]
  bf16* dhb = dys + Q * XS;                       // [P][BS] dh'_c
  bf16* hb = dhb + P * BS;                        // [P][BS] h_c
  float* dts = reinterpret_cast<float*>(hb + P * BS);
  float2* cdt = reinterpret_cast<float2*>(dts + Q);   // (cum log2 e, dt)
  float* ecum = reinterpret_cast<float*>(cdt + Q);    // e^cum
  float* wend = ecum + Q;                             // w
  float* e2 = wend + Q;                               // e^(cum_last - cum)
  float* dcum = e2 + Q;
  float* ddtp = dcum + Q;
  float* wdw = ddtp + Q;
  float* red = wdw + Q;                               // [16]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, gc = (lane & 3) * 2;
  const int S = a.S, H = a.H, G = a.G, nc = S / Q, nsl = H / a.hs;
  int bi = blockIdx.x;
  const int sl = bi % nsl;
  bi /= nsl;
  const int c = bi % nc, b = bi / nc;
  const int t0 = c * Q, h0 = sl * a.hs, g = h0 / (H / G);
  for (int e = tid; e < Q * N / 8; e += kTThreads) {
    const int r = e / (N / 8), v = e % (N / 8);
    const size_t off = (((size_t)b * S + t0 + r) * G + g) * N + v * 8;
    repro::cp_async16(bs + r * BS + v * 8, a.Bm + off, 16);
    repro::cp_async16(cs + r * BS + v * 8, a.Cm + off, 16);
  }
  const int r0 = warp * 16, ia = r0 + gr, ib = ia + 8;
  float dBa[NT][4], dCa[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dBa[t][e] = dCa[t][e] = 0.0f;
  float elast = 0.0f;   // warp 0's

  for (int hh_ = 0; hh_ < a.hs; ++hh_) {
    const int h = h0 + hh_;
    const size_t row0 = ((size_t)b * S + t0) * H + h;   // token i: + i H
    for (int e = tid; e < Q * P / 8; e += kTThreads) {
      const int r = e / (P / 8), v = e % (P / 8);
      const size_t off = (row0 + (size_t)r * H) * P + v * 8;
      repro::cp_async16(xs + r * XS + v * 8, a.x + off, 16);
      repro::cp_async16(dys + r * XS + v * 8, a.dy + off, 16);
    }
    repro::cp_async_commit();
    if (tid < Q) dts[tid] = a.dt[row0 + (size_t)tid * H];
    // h_c and dh'_c in bf16; <dh', h> in fp32
    {
      const size_t so = (((size_t)b * H + h) * nc + c) * P * N;
      const float4* h4 = reinterpret_cast<const float4*>(a.states + so);
      const float4* d4 = reinterpret_cast<const float4*>(a.dhs + so);
      float hdot = 0.0f;
      for (int e = tid; e < P * N / 4; e += kTThreads) {
        const float4 hv = h4[e], dv = d4[e];
        hdot = fmaf(hv.x, dv.x, fmaf(hv.y, dv.y, fmaf(hv.z, dv.z,
                    fmaf(hv.w, dv.w, hdot))));
        const int off = (e * 4 / N) * BS + e * 4 % N;
        *reinterpret_cast<uint2*>(hb + off) = make_uint2(
            repro::pack_bf16(hv.x, hv.y), repro::pack_bf16(hv.z, hv.w));
        *reinterpret_cast<uint2*>(dhb + off) = make_uint2(
            repro::pack_bf16(dv.x, dv.y), repro::pack_bf16(dv.z, dv.w));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        hdot += __shfl_xor_sync(0xffffffffu, hdot, off);
      if (lane == 0) red[warp] = hdot;
    }
    repro::cp_async_wait<0>();
    __syncthreads();
    if (warp == 0) {
      float c2[4];
      const float last2 = chunk_cum2(dts, a.A[h], lane, c2);
      elast = repro::exp2_approx(last2);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = lane * 4 + r;
        const float d = dts[i], f = repro::exp2_approx(last2 - c2[r]);
        cdt[i] = make_float2(c2[r], d);
        ecum[i] = repro::exp2_approx(c2[r]);
        e2[i] = f;
        wend[i] = d * f;
      }
    }
    __syncthreads();
    const float2 cda = cdt[ia], cdb = cdt[ib];   // (cum log2 e, dt)
    const float wa = wend[ia], wb = wend[ib];
    const float ea = ecum[ia], eb = ecum[ib];
    float dca = 0.0f, dcb = 0.0f;   // dcum of rows ia, ib

    // dB_j += w_j (x_j dh'); dC_i += e^cum_i (dy_i h), dcum_i = C_i . that;
    // 64 state columns at a time
#pragma unroll
    for (int nh = 0; nh < N / 64; ++nh) {
      float t2[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t) t2[t][0] = t2[t][1] = t2[t][2] = t2[t][3] = 0.0f;
      rows_x_state<P, XS, BS>(t2, xs, r0, dhb, nh * 64, lane);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        dBa[nh * 8 + t][0] = fmaf(wa, t2[t][0], dBa[nh * 8 + t][0]);
        dBa[nh * 8 + t][1] = fmaf(wa, t2[t][1], dBa[nh * 8 + t][1]);
        dBa[nh * 8 + t][2] = fmaf(wb, t2[t][2], dBa[nh * 8 + t][2]);
        dBa[nh * 8 + t][3] = fmaf(wb, t2[t][3], dBa[nh * 8 + t][3]);
        t2[t][0] = t2[t][1] = t2[t][2] = t2[t][3] = 0.0f;
      }
      rows_x_state<P, XS, BS>(t2, dys, r0, hb, nh * 64, lane);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int n = nh * 64 + t * 8 + gc;
        const float2 ca = repro::unpack_bf16(
            *reinterpret_cast<const uint32_t*>(cs + ia * BS + n));
        const float2 cb = repro::unpack_bf16(
            *reinterpret_cast<const uint32_t*>(cs + ib * BS + n));
        const float u0 = ea * t2[t][0], u1 = ea * t2[t][1];
        const float u2 = eb * t2[t][2], u3 = eb * t2[t][3];
        dca = fmaf(ca.x, u0, fmaf(ca.y, u1, dca));
        dcb = fmaf(cb.x, u2, fmaf(cb.y, u3, dcb));
        dCa[nh * 8 + t][0] += u0;
        dCa[nh * 8 + t][1] += u1;
        dCa[nh * 8 + t][2] += u2;
        dCa[nh * 8 + t][3] += u3;
      }
    }

    // dx_j = D dy_j + w_j (dh' B_j); dw_j = x_j . (dh' B_j); dD
    float dxa[PT][4];
#pragma unroll
    for (int t = 0; t < PT; ++t) dxa[t][0] = dxa[t][1] = dxa[t][2] = dxa[t][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t af[4];
      repro::ldmatrix_x4(af, bs + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                      BS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int pp = 0; pp < P / 16; ++pp) {
        const int off = (pp * 16 + (lane & 7) + (lane >> 4) * 8) * BS +
                        ((lane >> 3) & 1) * 8 + kk * 16;
        uint32_t r[4];
        repro::ldmatrix_x4(r, dhb + off);
        repro::mma_bf16(dxa[2 * pp], af, r[0], r[1]);
        repro::mma_bf16(dxa[2 * pp + 1], af, r[2], r[3]);
      }
    }
    const float Dh = a.D[h];
    float dwa = 0.0f, dwb = 0.0f, dD = 0.0f;
#pragma unroll
    for (int t = 0; t < PT; ++t) {
      const int col = t * 8 + gc;
      const float2 xa = repro::unpack_bf16(
          *reinterpret_cast<const uint32_t*>(xs + ia * XS + col));
      const float2 xb = repro::unpack_bf16(
          *reinterpret_cast<const uint32_t*>(xs + ib * XS + col));
      const float2 ya = repro::unpack_bf16(
          *reinterpret_cast<const uint32_t*>(dys + ia * XS + col));
      const float2 yb = repro::unpack_bf16(
          *reinterpret_cast<const uint32_t*>(dys + ib * XS + col));
      dwa = fmaf(xa.x, dxa[t][0], fmaf(xa.y, dxa[t][1], dwa));
      dwb = fmaf(xb.x, dxa[t][2], fmaf(xb.y, dxa[t][3], dwb));
      dD = fmaf(xa.x, ya.x, fmaf(xa.y, ya.y, fmaf(xb.x, yb.x,
               fmaf(xb.y, yb.y, dD))));
      dxa[t][0] = fmaf(wa, dxa[t][0], Dh * ya.x);
      dxa[t][1] = fmaf(wa, dxa[t][1], Dh * ya.y);
      dxa[t][2] = fmaf(wb, dxa[t][2], Dh * yb.x);
      dxa[t][3] = fmaf(wb, dxa[t][3], Dh * yb.y);
    }

    // rows i of this warp: the blocks j <= i of G = C B^T and dM = dy x^T;
    // M dM summed into dcum_i; dC_i += dG_i B with dG = dM L dt_j
    float rsa = 0.0f, rsb = 0.0f;
    for (int cb = 0; cb <= warp; ++cb) {
      float gs[2][4] = {}, dm[2][4] = {};
      block16<N, BS>(gs, cs, r0, bs, cb * 16, lane);
      block16<P, XS>(dm, dys, r0, xs, cb * 16, lane);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j0 = cb * 16 + t * 8 + gc;
        const float4 cd = *reinterpret_cast<const float4*>(cdt + j0);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + e;
          const float cj = e ? cd.z : cd.x, dj = e ? cd.w : cd.y;
          if (j <= ia) {
            const float l = repro::exp2_approx(cda.x - cj) * dj;
            rsa = fmaf(gs[t][e] * l, dm[t][e], rsa);
            gs[t][e] = dm[t][e] * l;
          } else {
            gs[t][e] = 0.0f;
          }
          if (j <= ib) {
            const float l = repro::exp2_approx(cdb.x - cj) * dj;
            rsb = fmaf(gs[t][2 + e] * l, dm[t][2 + e], rsb);
            gs[t][2 + e] = dm[t][2 + e] * l;
          } else {
            gs[t][2 + e] = 0.0f;
          }
        }
      }
      uint32_t ga[4];
      pack_a(gs, ga);
      a_x_rows<NT, BS>(dCa, ga, bs, cb * 16, lane);
    }

    // rows j of this warp: the blocks i >= j of G^T = B C^T and dM^T =
    // x dy^T; E = G L dM summed into ddt_j; dx_j += M^T_j dy and dB_j +=
    // dG^T_j C
    float era = 0.0f, erb = 0.0f;
    for (int ib_ = warp; ib_ < QT; ++ib_) {
      float gt[2][4] = {}, dmt[2][4] = {};
      block16<N, BS>(gt, bs, r0, cs, ib_ * 16, lane);
      block16<P, XS>(dmt, xs, r0, dys, ib_ * 16, lane);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int i0 = ib_ * 16 + t * 8 + gc;
        const float4 cd = *reinterpret_cast<const float4*>(cdt + i0);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = i0 + e;
          const float ci = e ? cd.z : cd.x;
          if (i >= ia) {
            const float l = repro::exp2_approx(ci - cda.x);
            const float gl = gt[t][e] * l;
            era = fmaf(gl, dmt[t][e], era);
            gt[t][e] = gl * cda.y;
            dmt[t][e] *= l * cda.y;
          } else {
            gt[t][e] = dmt[t][e] = 0.0f;
          }
          if (i >= ib) {
            const float l = repro::exp2_approx(ci - cdb.x);
            const float gl = gt[t][2 + e] * l;
            erb = fmaf(gl, dmt[t][2 + e], erb);
            gt[t][2 + e] = gl * cdb.y;
            dmt[t][2 + e] *= l * cdb.y;
          } else {
            gt[t][2 + e] = dmt[t][2 + e] = 0.0f;
          }
        }
      }
      uint32_t ma[4], ga[4];
      pack_a(gt, ma);
      pack_a(dmt, ga);
      a_x_rows<PT, XS>(dxa, ma, dys, ib_ * 16, lane);
      a_x_rows<NT, BS>(dBa, ga, cs, ib_ * 16, lane);
    }

    // dx of this head's rows, in bf16
#pragma unroll
    for (int t = 0; t < PT; ++t) {
      const int col = t * 8 + gc;
      *reinterpret_cast<uint32_t*>(a.dx + (row0 + (size_t)ia * H) * P + col) =
          repro::pack_bf16(dxa[t][0], dxa[t][1]);
      *reinterpret_cast<uint32_t*>(a.dx + (row0 + (size_t)ib * H) * P + col) =
          repro::pack_bf16(dxa[t][2], dxa[t][3]);
    }
    // per token: the terms of dt and cum, then warp 0's reverse prefix sum
    dwa = quad_sum(dwa);
    dwb = quad_sum(dwb);
    era = quad_sum(era);
    erb = quad_sum(erb);
    dca = quad_sum(dca + rsa) - cda.y * era - wa * dwa;
    dcb = quad_sum(dcb + rsb) - cdb.y * erb - wb * dwb;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dD += __shfl_xor_sync(0xffffffffu, dD, off);
    if ((lane & 3) == 0) {
      dcum[ia] = dca;
      dcum[ib] = dcb;
      ddtp[ia] = fmaf(e2[ia], dwa, era);
      ddtp[ib] = fmaf(e2[ib], dwb, erb);
      wdw[ia] = wa * dwa;
      wdw[ib] = wb * dwb;
    }
    if (lane == 0) red[8 + warp] = dD;
    __syncthreads();
    if (warp == 0) {
      float hdot = 0.0f, dsum = 0.0f;
#pragma unroll
      for (int w = 0; w < kTWarps; ++w) {
        hdot += red[w];
        dsum += red[8 + w];
      }
      float wsum = 0.0f;
#pragma unroll
      for (int r = 0; r < 4; ++r) wsum += wdw[lane * 4 + r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        wsum += __shfl_xor_sync(0xffffffffu, wsum, off);
      // reverse inclusive scan, four tokens a lane from the end
      float v[4];
      float run = 0.0f;
#pragma unroll
      for (int r = 3; r >= 0; --r) {
        const int j = lane * 4 + r;
        run += dcum[j] + (j == Q - 1 ? elast * hdot + wsum : 0.0f);
        v[r] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float dn = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += dn;
      }
      const float after = incl - run;   // the lanes above this one
      const float Ah = a.A[h];
      float da_dt = 0.0f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = lane * 4 + r;
        const float da = after + v[r];
        a.ddt[row0 + (size_t)j * H] = fmaf(Ah, da, ddtp[j]);
        da_dt = fmaf(dts[j], da, da_dt);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        da_dt += __shfl_xor_sync(0xffffffffu, da_dt, off);
      if (lane == 0) {
        a.dAp[((size_t)b * nc + c) * H + h] = da_dt;
        a.dDp[((size_t)b * nc + c) * H + h] = dsum;
      }
    }
    __syncthreads();   // every read of this head's shared memory is done
  }

  // this block's partials of dB and dC over its heads
  const size_t prow = ((size_t)b * S + t0) * nsl + sl;   // token i: + i nsl
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int n = t * 8 + gc;
    const size_t pa = (prow + (size_t)ia * nsl) * N + n;
    const size_t pb = (prow + (size_t)ib * nsl) * N + n;
    *reinterpret_cast<float2*>(a.dBp + pa) = make_float2(dBa[t][0], dBa[t][1]);
    *reinterpret_cast<float2*>(a.dBp + pb) = make_float2(dBa[t][2], dBa[t][3]);
    *reinterpret_cast<float2*>(a.dCp + pa) = make_float2(dCa[t][0], dCa[t][1]);
    *reinterpret_cast<float2*>(a.dCp + pb) = make_float2(dCa[t][2], dCa[t][3]);
  }
}

// dB, dC: the partials of the slices of each group summed in order; dA,
// dD: the partials of every (batch row, chunk) summed in order (block 0)
__global__ void ssd_bwd_finish_tc(const float* __restrict__ dBp,
                                  const float* __restrict__ dCp,
                                  const float* __restrict__ dAp,
                                  const float* __restrict__ dDp, bf16* dB,
                                  bf16* dC, float* dA, float* dD,
                                  long long total, int H, int G, int N,
                                  int nsl, int rows_bc) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < total) {
    const int n = (int)(idx % N);
    const long long r = idx / N;
    const int g = (int)(r % G);
    const long long bt = r / G;
    const int spg = nsl / G;
    float sb = 0.0f, sc = 0.0f;
    for (int s = 0; s < spg; ++s) {
      const size_t at = ((size_t)bt * nsl + g * spg + s) * N + n;
      sb += dBp[at];
      sc += dCp[at];
    }
    dB[idx] = __float2bfloat16_rn(sb);
    dC[idx] = __float2bfloat16_rn(sc);
  }
  if (blockIdx.x == 0) {
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float sa = 0.0f, sd = 0.0f;
      for (int r = 0; r < rows_bc; ++r) {
        sa += dAp[(size_t)r * H + h];
        sd += dDp[(size_t)r * H + h];
      }
      dA[h] = sa;
      dD[h] = sd;
    }
  }
}

template <int P, int N>
cudaError_t launch_tc(const TcBwdArgs& a, void* dB, void* dC, void* dA,
                      void* dD, int B, cudaStream_t st) {
  using L = TcBwdSmem<P, N>;
  static const cudaError_t a1 = cudaFuncSetAttribute(
      ssd_bwd_local<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kLocalBytes);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      ssd_bwd_chunk<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kChunkBytes);
  if (a1 != cudaSuccess) return a1;
  if (a2 != cudaSuccess) return a2;
  const int nc = a.S / kTQ, nsl = a.H / a.hs;
  const unsigned blocks = (unsigned)((long long)B * nc * nsl);
  ssd_bwd_local<P, N><<<blocks, kTThreads, L::kLocalBytes, st>>>(a);
  const long long lanes = (long long)B * a.H * P * N / 4;
  ssd_bwd_state<<<(unsigned)((lanes + 255) / 256), 256, 0, st>>>(
      a.dhs, a.elast, nc, P * N / 4, lanes);
  ssd_bwd_chunk<P, N><<<blocks, kTThreads, L::kChunkBytes, st>>>(a);
  const long long total = (long long)B * a.S * a.G * N;
  ssd_bwd_finish_tc<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      a.dBp, a.dCp, a.dAp, a.dDp, static_cast<bf16*>(dB),
      static_cast<bf16*>(dC), static_cast<float*>(dA),
      static_cast<float*>(dD), total, a.H, a.G, N, nsl, B * nc);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx: [B,S,H,P]; Bm, Cm, dB, dC: [B,S,G,N] (dtype 0 = float32,
// 1 = bfloat16, shared by all of them); dt, ddt: [B,S,H], A, D, dA, dD: [H]
// and states (the forward's chunk start states, [B,H,S/Q,P,N]) fp32.
// fp32 scratch as ssd/ops.py's ssd_bwd_plan sizes it, by route.  CUDA
// cores: dxf [B,S,H,P], dBf and dCf [B,S,H,N], dAp and dDp [B,H], dh and
// dhT [B,H,P,N].  Tensor cores (bf16 at Q = 128, P = 64, N = 128 or 64;
// x, dy, B and C 16-byte aligned), with hs = slice_heads(H, G): dxf
// unused, dBf and dCf [B,S,H/hs,N], dAp and dDp [B,S/Q,H], dh
// [B,H,S/Q,P,N], dhT [B,H,S/Q].
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && Q == kTQ && P == 64 && (N == 128 || N == 64)) {
    TcBwdArgs t{static_cast<const bf16*>(x), static_cast<const float*>(dt),
                static_cast<const float*>(A), static_cast<const bf16*>(Bm),
                static_cast<const bf16*>(Cm), static_cast<const float*>(D),
                static_cast<const bf16*>(dy),
                static_cast<const float*>(states), static_cast<float*>(dh),
                static_cast<float*>(dhT), static_cast<bf16*>(dx),
                static_cast<float*>(ddt), static_cast<float*>(dBf),
                static_cast<float*>(dCf), static_cast<float*>(dAp),
                static_cast<float*>(dDp), S, H, G, slice_heads(H, G)};
    return N == 128 ? (int)launch_tc<64, 128>(t, dB, dC, dA, dD, B, st)
                    : (int)launch_tc<64, 64>(t, dB, dC, dA, dD, B, st);
  }
  BwdArgs a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
            Bm, Cm, static_cast<const float*>(D), dy,
            static_cast<const float*>(states), static_cast<float*>(dxf),
            static_cast<float*>(dBf), static_cast<float*>(dCf),
            static_cast<float*>(ddt), static_cast<float*>(dAp),
            static_cast<float*>(dDp), static_cast<float*>(dh),
            static_cast<float*>(dhT), S, H, G};
  cudaError_t err =
      dtype == 0 ? dispatch<float>(a, dx, dB, dC, dA, dD, B, P, N, Q, st)
      : dtype == 1 ? dispatch<__nv_bfloat16>(a, dx, dB, dC, dA, dD, B, P, N,
                                             Q, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
