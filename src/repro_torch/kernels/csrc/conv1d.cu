// Causal depthwise conv1d with bias and SiLU, for Mamba prefill; also
// writes the new conv state (the K-1 inputs that end each row's valid
// prefix) into the caller's destination.
//
// Replaces the TPU kernel causal_conv1d_pallas
// (src/repro/kernels/conv1d/kernel.py:37, body _conv_kernel :16), and the
// conv-state slice the reference takes outside it (masked_conv_state,
// src/repro/models/mamba2.py:39).
//
// Bound on the H100: bytes.  Each output does K multiply-adds and reads
// one input, so the work is a stream of x in and y out (about 22 MB at
// mamba2-2.7b's B=4, S=256, C=5376 in bf16, ~6.6 us at 3.35 TB/s).
//
// Design: the TPU kernel walks the sequence in order and carries the K-1
// halo rows in scratch from one block to the next.  Threads here run in
// no order, so nothing is carried: each thread owns one vector of V
// channels (16 bytes: 8 bf16 or 4 fp32, narrower where C or an address
// does not allow it) over a tile of R rows of one batch row (16, or 8
// and narrower vectors where the grid would otherwise leave the SMs short
// of threads: at mamba-130m's C=1536), and loads its own K-1 halo rows,
// from x or, for the first tile, from initial_state.
// It issues all R + K - 1 loads of its window before any arithmetic, so
// each thread has R + K - 1 vectors in flight; neighbouring threads hold
// neighbouring vectors of one row, so each row's loads and stores are
// coalesced.  A thread's V x K taps are V*K consecutive floats of w, so
// reading them straight from memory would touch one cache line per thread
// and load; the block stages its channels' taps and bias in shared memory
// instead (cp.async, while the window loads are in flight) and turns them
// tap-major there.  The threads of the first tile also copy the rows
// len .. len + K - 2 of [initial_state; x] (len = the row's valid length,
// S when no lengths are given) into the new state, bit for bit.  Taps
// accumulate in fp32 in the reference's order (i = 0 .. K-1 from zero,
// then the bias) with rounded multiplies and adds, so no fused
// multiply-add changes the sum.  On the H100 the arithmetic, not the
// bytes, bounds the kernel (scripts/kernel_variants.py conv1d_design
// times its loads and stores alone and its arithmetic alone).
#include "conv1d.cuh"

namespace {

constexpr int kThreads = 128;

// a block's weights in shared memory (conv1d.cuh's padded layout)
constexpr int kMaxV = 8;
constexpr int kBlockCh = kThreads * kMaxV;

template <typename T, int K, int V, int R>
__global__ void __launch_bounds__(kThreads)
conv1d_kernel(const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, const T* __restrict__ init,
              const int* __restrict__ lengths, T* __restrict__ y,
              T* __restrict__ state, int S, int C) {
  __shared__ __align__(16) float raw[(K + 1) * kBlockCh];  // [c][K], bias
  __shared__ float ws[K + 1][padded(kBlockCh)];   // taps, then the bias
  const int tid = threadIdx.x;
  const int cb = blockIdx.x * kThreads * V;        // the block's channels
  const int nch = min(kThreads * V, C - cb);
  const int c = cb + tid * V, t0 = blockIdx.y * R, b = blockIdx.z;
  const bool live = tid * V < nch;
  const T* xb = x + (size_t)b * S * C + c;
  const T* ib = init + (size_t)b * (K - 1) * C + c;

  // the window: input rows t0 - (K-1) .. t0 + R - 1, all loads first
  Vec<T, V> win[R + K - 1];
  if (live) {
#pragma unroll
    for (int i = 0; i < R + K - 1; ++i) {
      const int r = t0 - (K - 1) + i;
      if (r < 0) win[i].load(ib + (size_t)(r + K - 1) * C);
      else if (r < S) win[i].load(xb + (size_t)r * C);
    }
  }
  // the block's weights and bias, requested while the window loads are in
  // flight, then turned tap-major inside shared memory
  stage<kThreads>(raw, w + (size_t)cb * K, nch * K, tid);
  stage<kThreads>(raw + K * kBlockCh, bias + cb, nch, tid);
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();
#pragma unroll 8
  for (int j = tid; j < nch * K; j += kThreads)
    ws[j % K][padded(j / K)] = raw[j];
  for (int j = tid; j < nch; j += kThreads)
    ws[K][padded(j)] = raw[K * kBlockCh + j];
  __syncthreads();
  if (!live) return;

  // the new state: rows len .. len + K - 2 of [init; x], copied as they are
  if (blockIdx.y == 0) {
    const int len = lengths ? min(max(lengths[b], 0), S) : S;
    T* sb = state + (size_t)b * (K - 1) * C + c;
#pragma unroll
    for (int k = 0; k < K - 1; ++k) {
      const int j = len + k;
      Vec<T, V> v;
      v.load(j < K - 1 ? ib + (size_t)j * C : xb + (size_t)(j - (K - 1)) * C);
      v.store(sb + (size_t)k * C);
    }
  }
  float wk[V][K], bc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
#pragma unroll
    for (int i = 0; i < K; ++i) wk[e][i] = ws[i][padded(tid * V + e)];
    bc[e] = ws[K][padded(tid * V + e)];
  }

  T* yb = y + (size_t)b * S * C + c;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (t0 + r < S) {
      float res[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < K; ++i)
          acc = __fadd_rn(acc, __fmul_rn(win[r + i].get(e), wk[e][i]));
        acc = __fadd_rn(acc, bc[e]);
        res[e] = silu(acc);
      }
      Vec<T, V> out;
      out.pack(res);
      out.store(yb + (size_t)(t0 + r) * C);
    }
  }
}

// a launch's threads fill the card when they give each SM this many
constexpr int kFill = 132 * 256;

template <typename T, int K, int V, int R>
cudaError_t run(const void* x, const void* w, const void* b,
                const void* init, const int* lengths, void* y, void* state,
                int B, int S, int C, cudaStream_t stream) {
  const dim3 grid((C / V + kThreads - 1) / kThreads, (S + R - 1) / R, B);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  conv1d_kernel<T, K, V, R><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const T*>(init), lengths,
      static_cast<T*>(y), static_cast<T*>(state), S, C);
  return cudaGetLastError();
}

// the widest vector of at most 16 bytes that divides C and every address
template <typename T>
int vec_width(int C, uintptr_t addrs) {
  for (int v = 16 / (int)sizeof(T); v > 1; v /= 2)
    if (C % v == 0 && addrs % (v * sizeof(T)) == 0) return v;
  return 1;
}

template <typename T, int K, int R>
cudaError_t with_rows(int v, const void* x, const void* w, const void* b,
                      const void* init, const int* lengths, void* y,
                      void* state, int B, int S, int C, cudaStream_t st) {
  switch (v) {
    case 8:
      if constexpr (sizeof(T) == 2)
        return run<T, K, 8, R>(x, w, b, init, lengths, y, state, B, S, C,
                               st);
      return cudaErrorInvalidValue;
    case 4:
      return run<T, K, 4, R>(x, w, b, init, lengths, y, state, B, S, C, st);
    case 2:
      return run<T, K, 2, R>(x, w, b, init, lengths, y, state, B, S, C, st);
    default:
      return run<T, K, 1, R>(x, w, b, init, lengths, y, state, B, S, C, st);
  }
}

// 16 rows a thread where that still fills the card, else 8; then the
// widest vector that does (each halving doubles the threads)
template <typename T, int K>
cudaError_t with_k(const void* x, const void* w, const void* b,
                   const void* init, const int* lengths, void* y,
                   void* state, int B, int S, int C, cudaStream_t st) {
  const uintptr_t addrs = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(init) |
                          reinterpret_cast<uintptr_t>(y) |
                          reinterpret_cast<uintptr_t>(state);
  auto threads = [&](int v, int r) {
    return (long long)B * ((S + r - 1) / r) * (C / v);
  };
  int v = vec_width<T>(C, addrs);
  const int rows = threads(v, 16) >= kFill ? 16 : 8;
  while (v > 1 && threads(v, rows) < kFill) v /= 2;
  return rows == 16
      ? with_rows<T, K, 16>(v, x, w, b, init, lengths, y, state, B, S, C, st)
      : with_rows<T, K, 8>(v, x, w, b, init, lengths, y, state, B, S, C, st);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b,
                   const void* init, const void* lengths, void* y,
                   void* state, int B, int S, int C, int K,
                   cudaStream_t st) {
  const int* len = static_cast<const int*>(lengths);
  switch (K) {
    case 2: return with_k<T, 2>(x, w, b, init, len, y, state, B, S, C, st);
    case 3: return with_k<T, 3>(x, w, b, init, len, y, state, B, S, C, st);
    case 4: return with_k<T, 4>(x, w, b, init, len, y, state, B, S, C, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: [B,S,C] (dtype 0 = float32, 1 = bfloat16); w: [C,K] fp32;
// b: [C] fp32; init, state: [B,K-1,C] in x's dtype; lengths: [B] int32,
// each row's valid prefix, or null (every row full).  state must not
// overlap x or init.
extern "C" int repro_conv1d_fwd(const void* x, const void* w, const void* b,
                                const void* init, const void* lengths,
                                void* y, void* state, int B, int S, int C,
                                int K, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0
          ? launch<float>(x, w, b, init, lengths, y, state, B, S, C, K, st)
      : dtype == 1 ? launch<__nv_bfloat16>(x, w, b, init, lengths, y, state,
                                           B, S, C, K, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
