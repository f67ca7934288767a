// Backward of causal flash attention over a full sequence (no query
// offset, Sq = Skv), GQA, for training.
//
// Replaces no TPU kernel: the reference has no backward kernel for
// flash_attention_pallas (src/repro/kernels/flash/kernel.py:124) and
// trains through its plain version.  The port launches a kernel for every
// CUDA tensor, so its gradient is a kernel too.
//
// With P = exp(scale * Q K^T - lse) under the causal mask (lse, each
// query row's log-sum-exp, written by the forward kernel):
//   Dr = rowsum(dO (.) O)
//   dV = P^T dO,  dP = dO V^T,  dS = P (.) (dP - Dr)
//   dQ = scale * dS K,  dK = scale * dS^T Q
// dK and dV of one KV head sum over the G query heads of its group.
//
// Bound on the H100: operations.  Five products over the causal half
// (S = Q K^T twice, dP twice, dV, dK, dQ: 7 * 2 * B * H * S^2 * d / 2
// FLOPs): at zamba2-2.7b's training shape (B=4, H=32, S=2048, d=80) about
// 300 GFLOP, ~0.3 ms at 989 TFLOP/s in bf16; the bytes (q, k, v, o, dO
// in, dq, dk, dv out) are ~0.3 GB, ~0.1 ms.
//
// Design (FA2's backward in three kernels, the simple form: fp32 on CUDA
// cores, both storage types): the first takes Dr for every row; the second
// owns one 64-key tile of one KV head and walks the G query heads of its
// group in order and, for each, the query tiles on and below the diagonal,
// accumulating dK and dV in registers; the third owns one 64-query tile
// and walks the key tiles up to the diagonal, accumulating dQ.  Each
// output is written by one block and every sum runs in one order, so two
// calls give the same bits (no atomics).  Tiles are staged in shared
// memory as fp32 rows padded by one element; a 16 x 16 thread grid owns
// 4 x 4 score tiles and 4 x d/16 output tiles.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kT = 64;            // rows of a query or key tile
constexpr int kThreads = 256;     // 16 x 16

template <int D>
struct BwdSmem {
  static constexpr int LD = D + 1;     // padded operand row
  static constexpr int LS = kT + 1;    // padded score row
  // Q, dO, K, V tiles, then P and dS, then lse and Dr of the query tile
  static constexpr size_t kBytes =
      (4 * (size_t)kT * LD + 2 * (size_t)kT * LS + 2 * kT) * sizeof(float);
};

// rows [r0, r0 + kT) of a [S][D] matrix into a padded fp32 tile, zeros past S
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int S) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < kT * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[r * LD + d] = r0 + r < S ? repro::to_f32(src[(size_t)(r0 + r) * D + d])
                                 : 0.0f;
  }
}

// Dr = rowsum(dO (.) O): one warp a row
template <typename T>
__global__ void flash_bwd_rowdot(const T* __restrict__ o,
                                 const T* __restrict__ dout,
                                 float* __restrict__ dr, long long rows,
                                 int D) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.0f;
  for (int d = lane; d < D; d += 32)
    s += repro::to_f32(o[row * D + d]) * repro::to_f32(dout[row * D + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) dr[row] = s;
}

// S and dP of a (query tile, key tile) pair: s[r][c] = Q_i . K_j and
// dp[r][c] = dO_i . V_j for i = ty + 16 r, j = tx + 16 c; then P and dS
// into shared memory (zero where the causal mask or S cuts them)
template <int D>
__device__ __forceinline__ void scores(const float* qs, const float* dos,
                                       const float* ks, const float* vs,
                                       const float* lse, const float* dr,
                                       float* ps, float* dss, int q0, int k0,
                                       int S, float scale) {
  constexpr int LD = D + 1, LS = kT + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      qv[r] = qs[(ty + 16 * r) * LD + d];
      ov[r] = dos[(ty + 16 * r) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kv[c] = ks[(tx + 16 * c) * LD + d];
      vv[c] = vs[(tx + 16 * c) * LD + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
        dp[r][c] = fmaf(ov[r], vv[c], dp[r][c]);
      }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r, qi = q0 + i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c, kj = k0 + j;
      float p = 0.0f, ds = 0.0f;
      if (qi < S && kj <= qi) {
        p = expf(s[r][c] * scale - lse[i]);
        ds = p * (dp[r][c] - dr[i]);
      }
      ps[i * LS + j] = p;
      dss[i * LS + j] = ds;
    }
  }
}

// dK and dV of one 64-key tile of one KV head
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dr,
               T* __restrict__ dk, T* __restrict__ dv, int H, int KVH, int S,
               float scale) {
  using L = BwdSmem<D>;
  constexpr int LD = L::LD, LS = L::LS, DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kT * LD;
  float* ks = dos + kT * LD;
  float* vs = ks + kT * LD;
  float* ps = vs + kT * LD;
  float* dss = ps + kT * LS;
  float* lq = dss + kT * LS;
  float* drs = lq + kT;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH, k0 = kt * kT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t kvoff = ((size_t)b * KVH + kvh) * S * D;
  load_tile<T, D>(ks, k + kvoff, k0, S);
  load_tile<T, D>(vs, v + kvoff, k0, S);

  float akk[4][DC], avv[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) akk[r][c] = avv[r][c] = 0.0f;

  const int n_qt = (S + kT - 1) / kT;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t qoff = ((size_t)b * H + h) * S;
    for (int qt = kt; qt < n_qt; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();   // the previous tile's readers are done
      load_tile<T, D>(qs, q + qoff * D, q0, S);
      load_tile<T, D>(dos, dout + qoff * D, q0, S);
      if (threadIdx.x < kT) {
        const int i = q0 + threadIdx.x;
        lq[threadIdx.x] = i < S ? lse[qoff + i] : 0.0f;
        drs[threadIdx.x] = i < S ? dr[qoff + i] : 0.0f;
      }
      __syncthreads();
      scores<D>(qs, dos, ks, vs, lq, drs, ps, dss, q0, k0, S, scale);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: rows j = ty + 16 r, columns tx + 16 c
#pragma unroll 4
      for (int i = 0; i < kT; ++i) {
        float pv[4], sv[4], ov[DC], qv[DC];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pv[r] = ps[i * LS + ty + 16 * r];
          sv[r] = dss[i * LS + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          ov[c] = dos[i * LD + tx + 16 * c];
          qv[c] = qs[i * LD + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            avv[r][c] = fmaf(pv[r], ov[c], avv[r][c]);
            akk[r][c] = fmaf(sv[r], qv[c], akk[r][c]);
          }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + ty + 16 * r;
    if (j >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const size_t at = kvoff + (size_t)j * D + tx + 16 * c;
      dk[at] = repro::from_f32<T>(akk[r][c] * scale);
      dv[at] = repro::from_f32<T>(avv[r][c]);
    }
  }
}

// dQ of one 64-query tile of one head
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dr,
             T* __restrict__ dqo, int H, int KVH, int S, float scale) {
  using L = BwdSmem<D>;
  constexpr int LD = L::LD, LS = L::LS, DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kT * LD;
  float* ks = dos + kT * LD;
  float* vs = ks + kT * LD;
  float* ps = vs + kT * LD;
  float* dss = ps + kT * LS;
  float* lq = dss + kT * LS;
  float* drs = lq + kT;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH), q0 = qt * kT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t qoff = ((size_t)b * H + h) * S;
  const size_t kvoff = ((size_t)b * KVH + kvh) * S * D;
  load_tile<T, D>(qs, q + qoff * D, q0, S);
  load_tile<T, D>(dos, dout + qoff * D, q0, S);
  if (threadIdx.x < kT) {
    const int i = q0 + threadIdx.x;
    lq[threadIdx.x] = i < S ? lse[qoff + i] : 0.0f;
    drs[threadIdx.x] = i < S ? dr[qoff + i] : 0.0f;
  }
  float acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.0f;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();   // the previous key tile's readers are done
    load_tile<T, D>(ks, k + kvoff, k0, S);
    load_tile<T, D>(vs, v + kvoff, k0, S);
    __syncthreads();
    scores<D>(qs, dos, ks, vs, lq, drs, ps, dss, q0, k0, S, scale);
    __syncthreads();
    // dQ += dS K: rows i = ty + 16 r, columns tx + 16 c
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      float sv[4], kv[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) sv[r] = dss[(ty + 16 * r) * LS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = ks[j * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(sv[r], kv[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dqo[(qoff + i) * D + tx + 16 * c] = repro::from_f32<T>(acc[r][c] * scale);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* dr, void* dq, void* dk, void* dv, int B, int H,
                   int KVH, int S, cudaStream_t st) {
  const float scale = (float)(1.0 / sqrt((double)D));   // the forward's
  const long long rows = (long long)B * H * S;
  flash_bwd_rowdot<T><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(dr), rows, D);
  constexpr size_t bytes = BwdSmem<D>::kBytes;
  static const cudaError_t a1 = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      flash_bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (a1 != cudaSuccess) return a1;
  if (a2 != cudaSuccess) return a2;
  const int tiles = (S + kT - 1) / kT;
  flash_bwd_dkdv<T, D><<<dim3(tiles, KVH, B), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), H, KVH, S, scale);
  flash_bwd_dq<T, D><<<dim3(tiles, H, B), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dr),
      static_cast<T*>(dq), H, KVH, S, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lse,
                     void* dr, void* dq, void* dk, void* dv, int B, int H,
                     int KVH, int S, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, dout, lse, dr, dq, dk, dv, B, H, KVH, S, st);
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, dr, dq, dk, dv, B, H, KVH, S, st);
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, dr, dq, dk, dv, B, H, KVH, S, st);
    case 80: return launch<T, 80>(q, k, v, o, dout, lse, dr, dq, dk, dv, B, H, KVH, S, st);
    case 96: return launch<T, 96>(q, k, v, o, dout, lse, dr, dq, dk, dv, B, H, KVH, S, st);
    case 128: return launch<T, 128>(q, k, v, o, dout, lse, dr, dq, dk, dv, B, H, KVH, S, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq: [B,H,S,D]; k, v, dk, dv: [B,KVH,S,D], all contiguous
// (dtype 0 = float32, 1 = bfloat16, shared by all of them); lse: [B,H,S]
// fp32 (the forward's, natural log of each row's sum of exp(scale q.k));
// dr: [B,H,S] fp32 scratch.  Causal, query i at position i.
extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* dr, void* dq, void* dk,
                               void* dv, int B, int H, int KVH, int S, int D,
                               int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH || S <= 0 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? dispatch<float>(q, k, v, o, dout, lse, dr, dq, dk, dv, B,
                                   H, KVH, S, D, st)
      : dtype == 1 ? dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, dr, dq,
                                             dk, dv, B, H, KVH, S, D, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
