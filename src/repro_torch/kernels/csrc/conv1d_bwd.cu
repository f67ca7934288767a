// Backward of the causal depthwise conv1d with bias and SiLU, for
// training (no initial state: a training sequence starts from zeros).
//
// Replaces no TPU kernel: the reference has no backward kernel for
// causal_conv1d_pallas (src/repro/kernels/conv1d/kernel.py:37) and trains
// through its plain version.  The port launches a kernel for every CUDA
// tensor, so its gradient is a kernel too.
//
// With z = b + sum_i w_i x[t - K + 1 + i] and y = silu(z):
//   dz = dy * silu'(z) = dy * sig(z) * (1 + z * (1 - sig(z)))
//   dx[s] = sum_i dz[s + K - 1 - i] * w_i      (anti-causal correlation)
//   dw_i = sum_{b,t} dz[t] * x[t - K + 1 + i],  db = sum_{b,t} dz[t]
//
// Bound on the H100: bytes.  x and dy in, dx out (at zamba2-2.7b's
// training shape, B=4, S=2048, C=5248 in bf16, about 258 MB, ~77 us at
// 3.35 TB/s); the arithmetic is ~6K + 7 operations an element.
//
// Design: each thread owns a vector of V channels (16 bytes: 8 bf16 or 4
// fp32; narrower where C or an address does not allow it: conv1d/ops.py's
// conv1d_bwd_plan) over kRows rows of one batch row, as the
// forward does.  A block is one warp across 32 neighbouring vectors (a
// row's loads and stores are 32 x 16 coalesced bytes) times kRowGroups
// warps down the rows, kRowGroups * kRows rows in all.  A thread walks
// its rows in order with the last K-1 inputs and dz in registers,
// loading x and dy one batch of kBatch rows ahead of the arithmetic (the
// first batch and the halo before the taps are staged) so that several
// vectors are in flight, and computes dz for K-1 rows past its
// own (their x and dy are the halo) so each dx is emitted as soon as the
// K dz it needs are known; dx is stored as vectors.  z is recomputed with
// the forward's rounded sum (taps in order from zero, then the bias, with
// __fmul_rn and __fadd_rn), so it is bit for bit the forward's z.  The
// taps and bias are staged tap-major in shared memory as the forward
// does.  dw and db: each thread sums its rows; the block's warps add
// their sums in shared memory in warp order, so each block writes one
// partial (B * ceil(S / (kRowGroups * kRows)) partials of C * (K + 1)
// floats: 6.7 MB at zamba2-2.7b's shape, against the 258 MB stream); a
// second kernel adds the partials, its eight warps each over every eighth
// partial in order and then the eight sums in warp order.  Two calls give
// the same bits (no atomics).
#include "conv1d.cuh"

namespace {

constexpr int kChanThreads = 32;   // threads across channels: one warp
constexpr int kRowGroups = 8;      // warps down the rows
constexpr int kThreads = kChanThreads * kRowGroups;
constexpr int kRows = 16;          // rows a thread owns
constexpr int kBatch = 4;          // rows whose loads are issued together
constexpr int kMinBlocks = 2;      // blocks an SM holds: 128 registers a thread

template <typename T, int K, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
conv1d_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, const T* __restrict__ dy,
                  T* __restrict__ dx, float* __restrict__ part, int S,
                  int C) {
  constexpr int kBlockCh = kChanThreads * V;
  constexpr int kSteps = kRows + K - 1;   // own rows, then the dz halo
  // the warps' (dw, db) sums, [warp][channel][K + 1]; first the raw taps
  __shared__ __align__(16) float red[kRowGroups][kBlockCh * (K + 1)];
  __shared__ float ws[K + 1][padded(kBlockCh)];   // taps, then the bias
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cb = blockIdx.x * kBlockCh;            // the block's channels
  const int nch = min(kBlockCh, C - cb);
  const int c = cb + lane * V, b = blockIdx.z;
  const int t0 = (blockIdx.y * kRowGroups + warp) * kRows;
  const bool live = lane * V < nch;
  const bool walks = live && t0 < S;
  const T* xb = x + (size_t)b * S * C + c;
  const T* dyb = dy + (size_t)b * S * C + c;
  T* dxb = dx + (size_t)b * S * C + c;
  // the x and dy rows of steps [s0, s0 + kBatch) (rows t0 + step), as
  // vectors in registers; rows at or past S are not read
  auto load_batch = [&](int s0, Vec<T, V> (&xv)[kBatch],
                        Vec<T, V> (&gv)[kBatch]) {
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int t = t0 + s0 + q;
      if (walks && s0 + q < kSteps && t < S) {
        xv[q].load(xb + (size_t)t * C);
        gv[q].load(dyb + (size_t)t * C);
      }
    }
  };
  // the K-1 rows before t0 and the first batch are in flight while the
  // taps are staged
  Vec<T, V> halo[K - 1];
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int r = t0 - (K - 1) + j;
    if (walks && r >= 0) halo[j].load(xb + (size_t)r * C);
  }
  Vec<T, V> xa[kBatch], ga[kBatch];
  load_batch(0, xa, ga);

  float* raw = &red[0][0];
  stage<kThreads>(raw, w + (size_t)cb * K, nch * K, tid);
  stage<kThreads>(raw + K * kBlockCh, bias + cb, nch, tid);
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();
  for (int j = tid; j < nch * K; j += kThreads)
    ws[j % K][padded(j / K)] = raw[j];
  for (int j = tid; j < nch; j += kThreads)
    ws[K][padded(j)] = raw[K * kBlockCh + j];
  __syncthreads();

  float dw[K][V], db[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    db[e] = 0.0f;
#pragma unroll
    for (int i = 0; i < K; ++i) dw[i][e] = 0.0f;
  }
  if (walks) {
    float wk[V][K], bc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
#pragma unroll
      for (int i = 0; i < K; ++i) wk[e][i] = ws[i][padded(lane * V + e)];
      bc[e] = ws[K][padded(lane * V + e)];
    }
    // xw[j] = x[t - K + 1 + j] and dzw[j] = dz[t - K + 1 + j] at step t,
    // j < K - 1 (the rows before t0 are zeros: no initial state, and dz
    // before t0 feeds no dx of this thread)
    float xw[K - 1][V], dzw[K - 1][V];
#pragma unroll
    for (int j = 0; j < K - 1; ++j) {
      const bool in = t0 - (K - 1) + j >= 0;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        xw[j][e] = in ? halo[j].get(e) : 0.0f;
        dzw[j][e] = 0.0f;
      }
    }
#pragma unroll
    for (int s0 = 0; s0 < kSteps; s0 += kBatch) {
      // the next batch's loads, then this batch's arithmetic
      Vec<T, V> xn[kBatch], gn[kBatch];
      if (s0 + kBatch < kSteps) load_batch(s0 + kBatch, xn, gn);
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int st = s0 + q, t = t0 + st;
        if (st < kSteps) {
          float dz[V], out[V];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float xt = t < S ? xa[q].get(e) : 0.0f;
            // the forward's sum: taps in order from zero, then the bias
            float z = 0.0f;
#pragma unroll
            for (int i = 0; i < K - 1; ++i)
              z = __fadd_rn(z, __fmul_rn(xw[i][e], wk[e][i]));
            z = __fadd_rn(z, __fmul_rn(xt, wk[e][K - 1]));
            z = __fadd_rn(z, bc[e]);
            const float sg = __fdividef(1.0f, 1.0f + __expf(-z));
            dz[e] = t < S ? ga[q].get(e) * sg * (1.0f + z * (1.0f - sg))
                          : 0.0f;
            if (st < kRows) {
              db[e] += dz[e];
#pragma unroll
              for (int i = 0; i < K - 1; ++i)
                dw[i][e] = fmaf(dz[e], xw[i][e], dw[i][e]);
              dw[K - 1][e] = fmaf(dz[e], xt, dw[K - 1][e]);
            }
            // dx[t - K + 1] = sum_i dz[t - i] w_i
            float acc = dz[e] * wk[e][0];
#pragma unroll
            for (int i = 1; i < K; ++i)
              acc = fmaf(dzw[K - 1 - i][e], wk[e][i], acc);
            out[e] = acc;
#pragma unroll
            for (int i = 0; i < K - 2; ++i) {
              xw[i][e] = xw[i + 1][e];
              dzw[i][e] = dzw[i + 1][e];
            }
            xw[K - 2][e] = xt;
            dzw[K - 2][e] = dz[e];
          }
          const int s = t - (K - 1);
          if (st >= K - 1 && s < S) {
            Vec<T, V> o;
            o.pack(out);
            o.store(dxb + (size_t)s * C);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        xa[q] = xn[q];
        ga[q] = gn[q];
      }
    }
  }

  // the block's one partial: the warps' sums added in warp order (the raw
  // taps that red held were read before the second barrier above)
  if (live) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float* r = &red[warp][(lane * V + e) * (K + 1)];
#pragma unroll
      for (int i = 0; i < K; ++i) r[i] = dw[i][e];
      r[K] = db[e];
    }
  }
  __syncthreads();
  float* pp = part + (size_t)(b * gridDim.y + blockIdx.y) * C * (K + 1) +
              (size_t)cb * (K + 1);
  for (int j = tid; j < nch * (K + 1); j += kThreads) {
    float sum = 0.0f;
#pragma unroll
    for (int g = 0; g < kRowGroups; ++g) sum += red[g][j];
    pp[j] = sum;
  }
}

// dw [C][K] and db [C]: element e of the C * (K + 1) sums its n partials,
// warp g of the block over partials g, g + 8, ... in order, then warp 0
// adds the eight sums in warp order
constexpr int kReduceWarps = 8;
__global__ void __launch_bounds__(32 * kReduceWarps)
conv1d_bwd_reduce(const float* __restrict__ part, float* __restrict__ dw,
                  float* __restrict__ db, int n, int C, int K) {
  __shared__ float sums[kReduceWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ck = C * (K + 1);
  const int e = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (e < ck) {
#pragma unroll 4
    for (int j = warp; j < n; j += kReduceWarps)
      s += __ldg(part + (size_t)j * ck + e);
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && e < ck) {
    float t = 0.0f;
#pragma unroll
    for (int g = 0; g < kReduceWarps; ++g) t += sums[g][lane];
    const int ch = e / (K + 1), i = e % (K + 1);
    if (i < K) dw[ch * K + i] = t;
    else db[ch] = t;
  }
}

template <typename T, int K, int V>
cudaError_t launch(const void* x, const void* w, const void* b,
                   const void* dy, void* dx, void* dw, void* db, void* part,
                   int B, int S, int C, cudaStream_t st) {
  const int tiles = (S + kRowGroups * kRows - 1) / (kRowGroups * kRows);
  const dim3 grid((C / V + kChanThreads - 1) / kChanThreads, tiles, B);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  conv1d_bwd_kernel<T, K, V><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(part), S, C);
  const int ck = C * (K + 1);
  conv1d_bwd_reduce<<<(ck + 31) / 32, 32 * kReduceWarps, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw),
      static_cast<float*>(db), B * tiles, C, K);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t with_vec(int V, const void* x, const void* w, const void* b,
                     const void* dy, void* dx, void* dw, void* db, void* part,
                     int B, int S, int C, cudaStream_t st) {
  switch (V) {
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch<T, K, 8>(x, w, b, dy, dx, dw, db, part, B, S, C, st);
      return cudaErrorInvalidValue;
    case 4: return launch<T, K, 4>(x, w, b, dy, dx, dw, db, part, B, S, C, st);
    case 2: return launch<T, K, 2>(x, w, b, dy, dx, dw, db, part, B, S, C, st);
    case 1: return launch<T, K, 1>(x, w, b, dy, dx, dw, db, part, B, S, C, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int V, const void* x, const void* w, const void* b,
                     const void* dy, void* dx, void* dw, void* db, void* part,
                     int B, int S, int C, int K, cudaStream_t st) {
  const uintptr_t addrs = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(dy) |
                          reinterpret_cast<uintptr_t>(dx);
  if (V < 1 || C % V || addrs % (V * sizeof(T))) return cudaErrorInvalidValue;
  switch (K) {
    case 2: return with_vec<T, 2>(V, x, w, b, dy, dx, dw, db, part, B, S, C,
                                  st);
    case 3: return with_vec<T, 3>(V, x, w, b, dy, dx, dw, db, part, B, S, C,
                                  st);
    case 4: return with_vec<T, 4>(V, x, w, b, dy, dx, dw, db, part, B, S, C,
                                  st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, dy, dx: [B,S,C] (dtype 0 = float32, 1 = bfloat16); w: [C,K] fp32,
// b: [C] fp32; dw: [C,K] and db: [C] fp32; part: fp32 scratch of
// B * ceil(S / (rows * 8)) * C * (K + 1) floats.  vec: channels a thread
// (dividing C, every address aligned to vec elements), rows: rows a
// thread (must be the kernel's 16), as conv1d/ops.py's conv1d_bwd_plan
// says.  No initial state, SiLU.
extern "C" int repro_conv1d_bwd(const void* x, const void* w, const void* b,
                                const void* dy, void* dx, void* dw, void* db,
                                void* part, int B, int S, int C, int K,
                                int vec, int rows, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || rows != kRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? dispatch<float>(vec, x, w, b, dy, dx, dw, db, part, B, S,
                                   C, K, st)
      : dtype == 1 ? dispatch<__nv_bfloat16>(vec, x, w, b, dy, dx, dw, db,
                                             part, B, S, C, K, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
