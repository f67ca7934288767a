// Backward of flash attention over a full sequence (no query offset,
// Sq = Skv), GQA, for training: causal, causal in a sliding window, or
// non-causal (an encoder's).
//
// Replaces no TPU kernel: the reference has no backward kernel for
// flash_attention_pallas (src/repro/kernels/flash/kernel.py:124) and
// trains through its plain version.  The port launches a kernel for every
// CUDA tensor, so its gradient is a kernel too.
//
// With P = exp(scale * Q K^T - lse) under the masks (lse, each query
// row's log-sum-exp, written by the forward kernel):
//   Dr = rowsum(dO (.) O)
//   dV = P^T dO,  dP = dO V^T,  dS = P (.) (dP - Dr)
//   dQ = scale * dS K,  dK = scale * dS^T Q
// dK and dV of one KV head sum over the G query heads of its group.  Key
// j is seen by query i when j < S and, in the causal modes, j <= i and,
// in a window, i - j < window (struct Mask).
//
// Bound on the H100: operations.  Five products over the (query, key)
// pairs the masks leave (S, dP, dV, dK, dQ: 10 d FLOPs a pair and head):
// at zamba2-2.7b's training shape (B=4, H=32, S=2048, d=80, causal) about
// 215 GFLOP, ~0.22 ms at 989 TFLOP/s in bf16; the bytes (q, k, v, o, dO
// in, dq, dk, dv out) are ~0.3 GB, ~0.1 ms.
//
// bf16 at d = 64, 80, 96, 128 and 256 (the trained models' head dims):
// wgmma and TMA, as the forward kernel (flash.cu), in three launches.
// - Stats: one warp a query row writes (lse log2 e, Dr) into an fp32
//   scratch whose rows are padded to a multiple of 128 with (+inf, 0), so
//   that a padded query row's P is exp2(-inf) = 0 without a mask.
// - dK/dV: a block owns 128 keys of one KV head (64 a consumer warpgroup)
//   and walks the G query heads of its group and, for each, the 64-row
//   query tiles the masks leave its keys (causal: from the diagonal on;
//   in a window: up to the tile of the last key plus the window;
//   non-causal: all).  K and V come once by TMA; a producer warp streams
//   Q, dO (TMA, 128-byte swizzle, 64-column panels) and the tile's stats
//   (a bulk copy) through a 4-stage mbarrier ring.  Each tile: S^T = K
//   Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands in shared
//   memory), P^T = exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T (.)
//   (dP^T - Dr) in registers, the masks only on a tile they cut (the
//   diagonal, the window's edge, keys past S: TMA fills those rows of K
//   and V with zeros, whose P would not be 0), then dV += P^T dO and dK
//   += dS^T Q (wgmma with P^T and dS^T from registers in bf16, as the
//   forward's P.V).  dK and dV stay in fp32 registers for the whole walk
//   and are written once, so the group's sum has one owner.  A
//   warpgroup none of whose keys the tile's queries see skips its
//   products.
// - dQ: a block owns 128 query rows of one head and walks the 64-key
//   tiles the masks leave them: Q and dO come once, K and V stream
//   through the ring; S = Q K^T and dP = dO V^T again, then dQ += dS K.
//   Seven products in all, 1.4x the bound's five, and no cross-block sum:
//   each output element has one writer, every sum runs in one order, and
//   two calls give the same bits (no atomics).
// Both walk the blocks with the most work first (the first key tiles,
// the last query tiles).  d = 80 and 96 run padded to 128 columns (TMA
// fills the columns past d with zeros), as the forward found faster; the
// score products skip the k-steps past d (all zeros), the products whose
// N is d run all 128 (wgmma's N-major operand comes in 64-column swizzle
// panels).
// setmaxnreg gives each consumer warpgroup 240 registers and the producer
// 24: at 128 padded columns dK and dV are 128 fp32 a thread.  At d = 256
// (gemma3-1b's) they would be 256, past the limit, so there a block owns
// 64 keys (64 query rows), both warpgroups compute its S and dP, and each
// accumulates and writes half of the columns of dK and dV (of dQ), with
// a 2-stage ring (WBwdSmem).
//
// fp32 and the reduced test dims 16 and 32 in bf16: the simple form, FA2's
// backward on CUDA cores in three kernels: the first takes Dr for every
// row; the second owns one key tile of one KV head and walks the G query
// heads of its group in order and, for each, the query tiles the masks
// leave it, accumulating dK and dV in registers; the third owns one query
// tile and walks the key tiles the masks leave it, accumulating dQ.  Tiles
// (64 rows; 32 at d = 256) are staged in shared memory as fp32 rows padded
// by one element; a 16 x 16 thread grid owns 4 x 4 (2 x 2) score tiles and
// 4 x d/16 (2 x d/16) output tiles.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;     // 16 x 16

// rows of a query or key tile: 64, or 32 at d = 256 (its tiles staged in
// fp32 would not fit a block's shared memory at 64)
template <int D>
constexpr int kTileRows = D > 128 ? 32 : 64;

// the masks of a full sequence (query i at position i): key j < S seen by
// query i when causal and j <= i, and with a window i - j < window
struct Mask {
  int S, causal, window;   // window <= 0: none
  __device__ __forceinline__ bool sees(int i, int j) const {
    return i < S && j < S && (!causal || j <= i) &&
           (window <= 0 || i - j < window);
  }
  // the query tiles [lo, hi) of tile rows tr that see some key of
  // [k0, k0 + kn), and the key tiles that some query of [q0, q0 + qn) sees
  __device__ __forceinline__ void q_tiles(int k0, int kn, int tr, int& lo,
                                          int& hi) const {
    const int n = (S + tr - 1) / tr;
    lo = causal ? k0 / tr : 0;
    hi = n;
    if (causal && window > 0) hi = min(n, (k0 + kn - 1 + window - 1) / tr + 1);
  }
  __device__ __forceinline__ void k_tiles(int q0, int qn, int tr, int& lo,
                                          int& hi) const {
    const int n = (S + tr - 1) / tr;
    lo = window > 0 ? max(0, q0 - window + 1) / tr : 0;
    hi = causal ? min(n, (q0 + qn - 1) / tr + 1) : n;
  }
};

template <int D>
struct BwdSmem {
  static constexpr int TR = kTileRows<D>;
  static constexpr int LD = D + 1;     // padded operand row
  static constexpr int LS = TR + 1;    // padded score row
  // Q, dO, K, V tiles, then P and dS, then lse and Dr of the query tile
  static constexpr size_t kBytes =
      (4 * (size_t)TR * LD + 2 * (size_t)TR * LS + 2 * TR) * sizeof(float);
};

// rows [r0, r0 + TR) of a [S][D] matrix into a padded fp32 tile, zeros
// past S
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int S) {
  constexpr int LD = D + 1, TR = kTileRows<D>;
  for (int e = threadIdx.x; e < TR * D; e += kThreads) {
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
// into shared memory (zero where the masks cut them)
template <int D>
__device__ __forceinline__ void scores(const float* qs, const float* dos,
                                       const float* ks, const float* vs,
                                       const float* lse, const float* dr,
                                       float* ps, float* dss, int q0, int k0,
                                       const Mask& m, float scale) {
  constexpr int TR = kTileRows<D>, RT = TR / 16;
  constexpr int LD = D + 1, LS = TR + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[RT][RT], dp[RT][RT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < RT; ++c) s[r][c] = dp[r][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[RT], ov[RT], kv[RT], vv[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      qv[r] = qs[(ty + 16 * r) * LD + d];
      ov[r] = dos[(ty + 16 * r) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < RT; ++c) {
      kv[c] = ks[(tx + 16 * c) * LD + d];
      vv[c] = vs[(tx + 16 * c) * LD + d];
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < RT; ++c) {
        s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
        dp[r][c] = fmaf(ov[r], vv[c], dp[r][c]);
      }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int i = ty + 16 * r, qi = q0 + i;
#pragma unroll
    for (int c = 0; c < RT; ++c) {
      const int j = tx + 16 * c, kj = k0 + j;
      float p = 0.0f, ds = 0.0f;
      if (m.sees(qi, kj)) {
        p = expf(s[r][c] * scale - lse[i]);
        ds = p * (dp[r][c] - dr[i]);
      }
      ps[i * LS + j] = p;
      dss[i * LS + j] = ds;
    }
  }
}

// dK and dV of one key tile of one KV head
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dr,
               T* __restrict__ dk, T* __restrict__ dv, int H, int KVH,
               Mask m, float scale) {
  using L = BwdSmem<D>;
  constexpr int TR = L::TR, RT = TR / 16;
  constexpr int LD = L::LD, LS = L::LS, DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + TR * LD;
  float* ks = dos + TR * LD;
  float* vs = ks + TR * LD;
  float* ps = vs + TR * LD;
  float* dss = ps + TR * LS;
  float* lq = dss + TR * LS;
  float* drs = lq + TR;

  const int S = m.S;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH, k0 = kt * TR;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t kvoff = ((size_t)b * KVH + kvh) * S * D;
  load_tile<T, D>(ks, k + kvoff, k0, S);
  load_tile<T, D>(vs, v + kvoff, k0, S);

  float akk[RT][DC], avv[RT][DC];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) akk[r][c] = avv[r][c] = 0.0f;

  int qt_lo, qt_hi;
  m.q_tiles(k0, TR, TR, qt_lo, qt_hi);
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t qoff = ((size_t)b * H + h) * S;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * TR;
      __syncthreads();   // the previous tile's readers are done
      load_tile<T, D>(qs, q + qoff * D, q0, S);
      load_tile<T, D>(dos, dout + qoff * D, q0, S);
      if (threadIdx.x < TR) {
        const int i = q0 + threadIdx.x;
        lq[threadIdx.x] = i < S ? lse[qoff + i] : 0.0f;
        drs[threadIdx.x] = i < S ? dr[qoff + i] : 0.0f;
      }
      __syncthreads();
      scores<D>(qs, dos, ks, vs, lq, drs, ps, dss, q0, k0, m, scale);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: rows j = ty + 16 r, columns tx + 16 c
#pragma unroll 4
      for (int i = 0; i < TR; ++i) {
        float pv[RT], sv[RT], ov[DC], qv[DC];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          pv[r] = ps[i * LS + ty + 16 * r];
          sv[r] = dss[i * LS + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          ov[c] = dos[i * LD + tx + 16 * c];
          qv[c] = qs[i * LD + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            avv[r][c] = fmaf(pv[r], ov[c], avv[r][c]);
            akk[r][c] = fmaf(sv[r], qv[c], akk[r][c]);
          }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
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

// dQ of one query tile of one head
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dr,
             T* __restrict__ dqo, int H, int KVH, Mask m, float scale) {
  using L = BwdSmem<D>;
  constexpr int TR = L::TR, RT = TR / 16;
  constexpr int LD = L::LD, LS = L::LS, DC = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + TR * LD;
  float* ks = dos + TR * LD;
  float* vs = ks + TR * LD;
  float* ps = vs + TR * LD;
  float* dss = ps + TR * LS;
  float* lq = dss + TR * LS;
  float* drs = lq + TR;

  const int S = m.S;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH), q0 = qt * TR;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t qoff = ((size_t)b * H + h) * S;
  const size_t kvoff = ((size_t)b * KVH + kvh) * S * D;
  load_tile<T, D>(qs, q + qoff * D, q0, S);
  load_tile<T, D>(dos, dout + qoff * D, q0, S);
  if (threadIdx.x < TR) {
    const int i = q0 + threadIdx.x;
    lq[threadIdx.x] = i < S ? lse[qoff + i] : 0.0f;
    drs[threadIdx.x] = i < S ? dr[qoff + i] : 0.0f;
  }
  float acc[RT][DC];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.0f;
  int kt_lo, kt_hi;
  m.k_tiles(q0, TR, TR, kt_lo, kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * TR;
    __syncthreads();   // the previous key tile's readers are done
    load_tile<T, D>(ks, k + kvoff, k0, S);
    load_tile<T, D>(vs, v + kvoff, k0, S);
    __syncthreads();
    scores<D>(qs, dos, ks, vs, lq, drs, ps, dss, q0, k0, m, scale);
    __syncthreads();
    // dQ += dS K: rows i = ty + 16 r, columns tx + 16 c
#pragma unroll 4
    for (int j = 0; j < TR; ++j) {
      float sv[RT], kv[DC];
#pragma unroll
      for (int r = 0; r < RT; ++r) sv[r] = dss[(ty + 16 * r) * LS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = ks[j * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(sv[r], kv[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
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
                   int KVH, const Mask& m, cudaStream_t st) {
  const float scale = (float)(1.0 / sqrt((double)D));   // the forward's
  const long long rows = (long long)B * H * m.S;
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
  constexpr int TR = kTileRows<D>;
  const int tiles = (m.S + TR - 1) / TR;
  flash_bwd_dkdv<T, D><<<dim3(tiles, KVH, B), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), H, KVH, m, scale);
  flash_bwd_dq<T, D><<<dim3(tiles, H, B), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dr),
      static_cast<T*>(dq), H, KVH, m, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lse,
                     void* dr, void* dq, void* dk, void* dv, int B, int H,
                     int KVH, const Mask& m, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, dout, lse, dr, dq, dk, dv, B, H, KVH, m, st);
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, dr, dq, dk, dv, B, H, KVH, m, st);
    case 256: return launch<T, 256>(q, k, v, o, dout, lse, dr, dq, dk, dv, B, H, KVH, m, st);
  }
  if constexpr (sizeof(T) == 4) {   // bf16 at these dims: wgmma
    switch (D) {
      case 64: return launch<T, 64>(q, k, v, o, dout, lse, dr, dq, dk, dv, B, H, KVH, m, st);
      case 80: return launch<T, 80>(q, k, v, o, dout, lse, dr, dq, dk, dv, B, H, KVH, m, st);
      case 96: return launch<T, 96>(q, k, v, o, dout, lse, dr, dq, dk, dv, B, H, KVH, m, st);
      case 128: return launch<T, 128>(q, k, v, o, dout, lse, dr, dq, dk, dv, B, H, KVH, m, st);
    }
  }
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------ bf16: wgmma

constexpr int kWQ = 64;          // query rows of a streamed tile (dK/dV)
constexpr int kWK = 64;          // keys of a streamed tile (dQ)
constexpr int kWThreads = 384;   // consumer warpgroups 0, 1; producer 2
constexpr int kStatRows = 128;   // the stats scratch's rows pad to this
constexpr float kLog2e = 1.4426950408889634f;

// d runs padded to 64, 128 or 256 columns; the tiles of both kernels
// (mirrored by flash/ops.py: flash_bwd_plan), 1024 bytes of slack to
// align them.  Up to d = 128 the two consumer warpgroups own 64 keys (or
// query rows) each of a 128-key (128-row) block and every output column.
// At d = 256 (kSplit) a block owns 64 keys (rows), both warpgroups
// compute its scores, and each accumulates half of the output columns
// (kNC = 128): all of them would take 256 fp32 registers a thread.
template <int D>
struct WBwdSmem {
  static constexpr int kDP = (D + 63) / 64 * 64;
  static constexpr int kPanels = kDP / 64;
  static constexpr bool kSplit = D > 128;
  static constexpr int kNC = kSplit ? kDP / 2 : kDP;   // a warpgroup's columns
  static constexpr int kKeys = kSplit ? 64 : 128;     // keys of a dK/dV block
  static constexpr int kQRows = kSplit ? 64 : 128;    // rows of a dQ block
  static constexpr int kStages = kSplit ? 2 : 4;      // the streamed ring
  // dK/dV: K and V of the block's keys once, then stages of Q and dO (64
  // rows each)
  static constexpr int kKeyBytes = kKeys * kDP * 2;       // one of K, V
  static constexpr int kQTileBytes = kWQ * kDP * 2;       // one of Q, dO
  static constexpr int kDkdvBytes =
      2 * kKeyBytes + kStages * 2 * kQTileBytes + 1024;
  // dQ: Q and dO of the block's rows once, then stages of K and V
  static constexpr int kRowBytes = kQRows * kDP * 2;      // one of Q, dO
  static constexpr int kKTileBytes = kWK * kDP * 2;       // one of K, V
  static constexpr int kDqBytes =
      2 * kRowBytes + kStages * 2 * kKTileBytes + 1024;
};

// what both kernels read of the launch: the maps' coordinate orders
// (hopper.cuh's make_map), shapes, the padded stats rows, the two scales
struct WBwdArgs {
  const float2* stats;   // [B,H,Spad]: (lse log2 e, Dr), (+inf, 0) past S
  __nv_bfloat16* out0;   // dK/dV: dk; dQ: dq
  __nv_bfloat16* out1;   // dK/dV: dv
  int B, H, KVH, Spad;
  Mask m;                // S and the masks
  int q_perm, k_perm, v_perm, do_perm;
  float scale, scale2;   // scale, scale log2 e
};

// (lse log2 e, Dr = rowsum(dO (.) O)) of each query row, (+inf, 0) for the
// rows past S up to Spad: one warp a row, bf16 pairs
__global__ void flash_bwd_stats(const __nv_bfloat16* __restrict__ o,
                                const __nv_bfloat16* __restrict__ dout,
                                const float* __restrict__ lse,
                                float2* __restrict__ stats, int S, int Spad,
                                int D, long long rows_pad) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows_pad) return;
  const long long bh = row / Spad;
  const int i = (int)(row % Spad);
  float s = 0.0f;
  if (i < S) {
    const size_t at = ((size_t)bh * S + i) * D;
    const __nv_bfloat162* o2 =
        reinterpret_cast<const __nv_bfloat162*>(o + at);
    const __nv_bfloat162* d2 =
        reinterpret_cast<const __nv_bfloat162*>(dout + at);
    for (int c = lane; c < D / 2; c += 32) {
      const float2 a = __bfloat1622float2(o2[c]);
      const float2 b = __bfloat1622float2(d2[c]);
      s = fmaf(a.x, b.x, fmaf(a.y, b.y, s));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0)
    stats[row] = i < S ? make_float2(lse[bh * S + i] * kLog2e, s)
                       : make_float2(INFINITY, 0.0f);
}

// a 64 x 64 score tile: acc = A B^T over the first 16 KS columns (d: the
// padded columns are zeros, so they are skipped), A rows at a_addr (a
// 64-row slice of a tile of a_rows rows), B rows at b_addr (a tile of 64
// rows), both K-major in 64-column panels
template <int KS>
__device__ __forceinline__ void scores64(float (&acc)[32], uint32_t a_addr,
                                         int a_rows, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t da = repro::wgmma_desc(
        a_addr + (kk >> 2) * a_rows * 128 + (kk & 3) * 32, 16, 1024);
    const uint64_t db = repro::wgmma_desc(
        b_addr + (kk >> 2) * 64 * 128 + (kk & 3) * 32, 16, 1024);
    repro::wgmma_ss_n64(acc, da, db, 1);
  }
}

// a 64 x 64 fp32 tile in the accumulator's layout as the bf16 A operand
// of four k-steps of 16 (the accumulator's layout is the A operand's)
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = repro::pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = repro::pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = repro::pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = repro::pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

__device__ __forceinline__ void wait_scores(float (&s)[32], float (&dp)[32]) {
  repro::wgmma_commit();
  repro::reg_fence(s);
  repro::reg_fence(dp);
  repro::wgmma_wait0();
  repro::reg_fence(s);
  repro::reg_fence(dp);
}

// dK and dV of 128 keys (64 at d = 256) of one KV head
template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, WBwdArgs w) {
  using L = WBwdSmem<D>;
  constexpr int NP = L::kPanels, NS = L::kStages, DP = L::kDP;
  constexpr int KEYS = L::kKeys, NC = L::kNC;
  __shared__ __align__(8) uint64_t full_bar[NS], empty_bar[NS], kv_bar;
  __shared__ __align__(16) float2 stat_s[NS][kWQ];
  extern __shared__ __align__(1024) unsigned char wgmma_smem[];
  unsigned char* base =
      wgmma_smem + ((1024 - (repro::smem_u32(wgmma_smem) & 1023)) & 1023);
  // K [NP][128][64], V alike, then stages of Q [NP][64][64] and dO alike
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* vs = ks + KEYS * DP;
  __nv_bfloat16* qstages = vs + KEYS * DP;

  // key tiles from the first (the most query tiles) to the last
  int i = blockIdx.x;
  const int kvh = i % w.KVH;
  i /= w.KVH;
  const int b = i % w.B;
  const int kt = i / w.B;
  const int G = w.H / w.KVH, k0 = kt * KEYS, S = w.m.S;
  int qt0, qt1;   // the query tiles the masks leave the block's keys
  w.m.q_tiles(k0, KEYS, kWQ, qt0, qt1);
  const int nq = qt1 - qt0;
  const int n_tiles = G * nq;   // query head g's tiles qt0 .. in order

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      repro::mbar_init(&full_bar[s], 1);
      repro::mbar_init(&empty_bar[s], 8);   // the consumers' eight warps
    }
    repro::mbar_init(&kv_bar, 1);
    repro::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer: one thread keeps the TMA loads of the ring in flight
    repro::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      repro::mbar_expect_tx(&kv_bar, 2 * L::kKeyBytes);
#pragma unroll
      for (int pn = 0; pn < NP; ++pn) {
        repro::tma_tile(ks + pn * KEYS * 64, &tk, &kv_bar, w.k_perm,
                        pn * 64, kvh, k0, b);
        repro::tma_tile(vs + pn * KEYS * 64, &tv, &kv_bar, w.v_perm,
                        pn * 64, kvh, k0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % NS;
        const int h = kvh * G + j / nq, q0 = (qt0 + j % nq) * kWQ;
        repro::mbar_wait(&empty_bar[st], ((j / NS) & 1) ^ 1);
        repro::mbar_expect_tx(&full_bar[st],
                              2 * L::kQTileBytes + kWQ * sizeof(float2));
        __nv_bfloat16* qs = qstages + (size_t)st * 2 * kWQ * DP;
        __nv_bfloat16* dos = qs + kWQ * DP;
#pragma unroll
        for (int pn = 0; pn < NP; ++pn) {
          repro::tma_tile(qs + pn * kWQ * 64, &tq, &full_bar[st], w.q_perm,
                          pn * 64, h, q0, b);
          repro::tma_tile(dos + pn * kWQ * 64, &tdo, &full_bar[st],
                          w.do_perm, pn * 64, h, q0, b);
        }
        repro::bulk_load(stat_s[st],
                         w.stats + ((size_t)b * w.H + h) * w.Spad + q0,
                         kWQ * sizeof(float2), &full_bar[st]);
      }
    }
  } else {
    // consumers: warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64) and
    // every column; at d = 256 keys [k0, k0 + 64) and columns [128 wg,
    // 128 wg + 128)
    repro::setmaxnreg_inc<240>();
    const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int kw0 = L::kSplit ? k0 : k0 + wg * 64;
    const int c0 = L::kSplit ? wg * NC : 0;
    const int key0 = kw0 + warp * 16 + (lane >> 2), key1 = key0 + 8;
    const int gc = (lane & 3) * 2;
    float dva[NC / 2], dka[NC / 2];
#pragma unroll
    for (int k = 0; k < NC / 2; ++k) dva[k] = dka[k] = 0.0f;
    const uint32_t k_addr =
        repro::smem_u32(ks) + (L::kSplit ? 0 : wg * 64 * 128);
    const uint32_t v_addr =
        repro::smem_u32(vs) + (L::kSplit ? 0 : wg * 64 * 128);
    repro::mbar_wait(&kv_bar, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % NS;
      const int q0 = (qt0 + j % nq) * kWQ;
      repro::mbar_wait(&full_bar[st], (j / NS) & 1);
      // some query of the tile sees one of the warpgroup's keys
      if (kw0 < S && (!w.m.causal || q0 + kWQ > kw0) &&
          (w.m.window <= 0 || q0 - (kw0 + 63) < w.m.window)) {
        const uint32_t q_addr =
            repro::smem_u32(qstages + (size_t)st * 2 * kWQ * DP);
        const uint32_t do_addr = q_addr + kWQ * DP * 2;
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each;
        // s[4n + e] is (key0, query q0 + 8n + gc + e), s[4n + 2 + e] key1's
        float s[32], dp[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) s[k] = dp[k] = 0.0f;
        repro::wgmma_fence();
        repro::reg_fence(s);
        repro::reg_fence(dp);
        scores64<D / 16>(s, k_addr, KEYS, q_addr);
        scores64<D / 16>(dp, v_addr, KEYS, do_addr);
        wait_scores(s, dp);
        // a tile the masks cut: the diagonal, the window's edge, keys
        // past S
        const bool edge = (w.m.causal && q0 < kw0 + 64) ||
                          (w.m.window > 0 && q0 + 63 - kw0 >= w.m.window) ||
                          kw0 + 64 > S;
        const float2* stq = stat_s[st];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * n + gc + e;
            const float2 ld = stq[c];
            float p0 = repro::exp2_approx(s[4 * n + e] * w.scale2 - ld.x);
            float p1 = repro::exp2_approx(s[4 * n + 2 + e] * w.scale2 - ld.x);
            if (edge) {
              if (!w.m.sees(q0 + c, key0)) p0 = 0.0f;
              if (!w.m.sees(q0 + c, key1)) p1 = 0.0f;
            }
            s[4 * n + e] = p0;
            s[4 * n + 2 + e] = p1;
            dp[4 * n + e] = p0 * (dp[4 * n + e] - ld.y);
            dp[4 * n + 2 + e] = p1 * (dp[4 * n + 2 + e] - ld.y);
          }
        }
        uint32_t pa[4][4], da[4][4];
        pack_a(s, pa);
        pack_a(dp, da);
        // dV += P^T dO, dK += dS^T Q: dO and Q N-major in shared memory,
        // from the warpgroup's first column's panel
        const uint32_t cpan = c0 / 64 * kWQ * 128;
        repro::wgmma_fence();
        repro::reg_fence(dva);
        repro::reg_fence(dka);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          repro::wgmma_rs<NC>(dva, pa[kk], repro::wgmma_desc(
              do_addr + cpan + kk * 2048, kWQ * 128, 1024));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          repro::wgmma_rs<NC>(dka, da[kk], repro::wgmma_desc(
              q_addr + cpan + kk * 2048, kWQ * 128, 1024));
        repro::wgmma_commit();
        repro::reg_fence(dva);
        repro::reg_fence(dka);
        repro::wgmma_wait0();
        repro::reg_fence(dva);
        repro::reg_fence(dka);
      }
      __syncwarp();
      if (lane == 0) repro::mbar_arrive(&empty_bar[st]);
    }

    const size_t kv0 = ((size_t)b * w.KVH + kvh) * S;
#pragma unroll
    for (int n = 0; n < (L::kSplit ? NC : D) / 8; ++n) {
      const int col = c0 + n * 8 + gc;
      if (key0 < S) {
        const size_t at = (kv0 + key0) * D + col;
        *reinterpret_cast<uint32_t*>(w.out0 + at) = repro::pack_bf16(
            dka[4 * n] * w.scale, dka[4 * n + 1] * w.scale);
        *reinterpret_cast<uint32_t*>(w.out1 + at) =
            repro::pack_bf16(dva[4 * n], dva[4 * n + 1]);
      }
      if (key1 < S) {
        const size_t at = (kv0 + key1) * D + col;
        *reinterpret_cast<uint32_t*>(w.out0 + at) = repro::pack_bf16(
            dka[4 * n + 2] * w.scale, dka[4 * n + 3] * w.scale);
        *reinterpret_cast<uint32_t*>(w.out1 + at) =
            repro::pack_bf16(dva[4 * n + 2], dva[4 * n + 3]);
      }
    }
  }
}

// dQ of 128 query rows (64 at d = 256) of one head
template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo, WBwdArgs w) {
  using L = WBwdSmem<D>;
  constexpr int NP = L::kPanels, NS = L::kStages, DP = L::kDP;
  constexpr int QR = L::kQRows, NC = L::kNC;
  __shared__ __align__(8) uint64_t full_bar[NS], empty_bar[NS], q_bar;
  extern __shared__ __align__(1024) unsigned char wgmma_smem[];
  unsigned char* base =
      wgmma_smem + ((1024 - (repro::smem_u32(wgmma_smem) & 1023)) & 1023);
  // Q [NP][128][64], dO alike, then stages of K [NP][64][64] and V alike
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* dos = qs + QR * DP;
  __nv_bfloat16* kstages = dos + QR * DP;

  // query tiles from the last (the most keys) to the first
  int i = blockIdx.x;
  const int h = i % w.H;
  i /= w.H;
  const int b = i % w.B;
  const int S = w.m.S;
  const int qt = (S + QR - 1) / QR - 1 - i / w.B;
  const int kvh = h / (w.H / w.KVH), q0 = qt * QR;
  int kt0, kt1;   // the key tiles the masks leave the block's rows
  w.m.k_tiles(q0, QR, kWK, kt0, kt1);
  const int n_kt = kt1 - kt0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      repro::mbar_init(&full_bar[s], 1);
      repro::mbar_init(&empty_bar[s], 8);
    }
    repro::mbar_init(&q_bar, 1);
    repro::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    repro::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      repro::mbar_expect_tx(&q_bar, 2 * L::kRowBytes);
#pragma unroll
      for (int pn = 0; pn < NP; ++pn) {
        repro::tma_tile(qs + pn * QR * 64, &tq, &q_bar, w.q_perm,
                        pn * 64, h, q0, b);
        repro::tma_tile(dos + pn * QR * 64, &tdo, &q_bar, w.do_perm,
                        pn * 64, h, q0, b);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % NS;
        repro::mbar_wait(&empty_bar[st], ((j / NS) & 1) ^ 1);
        repro::mbar_expect_tx(&full_bar[st], 2 * L::kKTileBytes);
        __nv_bfloat16* kt = kstages + (size_t)st * 2 * kWK * DP;
        __nv_bfloat16* vt = kt + kWK * DP;
#pragma unroll
        for (int pn = 0; pn < NP; ++pn) {
          repro::tma_tile(kt + pn * kWK * 64, &tk, &full_bar[st], w.k_perm,
                          pn * 64, kvh, (kt0 + j) * kWK, b);
          repro::tma_tile(vt + pn * kWK * 64, &tv, &full_bar[st], w.v_perm,
                          pn * 64, kvh, (kt0 + j) * kWK, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64)
    // and every column; at d = 256 rows [q0, q0 + 64) and columns [128 wg,
    // 128 wg + 128)
    repro::setmaxnreg_inc<240>();
    const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int qw0 = L::kSplit ? q0 : q0 + wg * 64;
    const int c0 = L::kSplit ? wg * NC : 0;
    const int row0 = qw0 + warp * 16 + (lane >> 2), row1 = row0 + 8;
    const int gc = (lane & 3) * 2;
    const float2* stb = w.stats + ((size_t)b * w.H + h) * w.Spad;
    const float2 ld0 = stb[row0], ld1 = stb[row1];   // rows < Spad
    float dqa[NC / 2];
#pragma unroll
    for (int k = 0; k < NC / 2; ++k) dqa[k] = 0.0f;
    const uint32_t q_addr =
        repro::smem_u32(qs) + (L::kSplit ? 0 : wg * 64 * 128);
    const uint32_t do_addr =
        repro::smem_u32(dos) + (L::kSplit ? 0 : wg * 64 * 128);
    repro::mbar_wait(&q_bar, 0);

    for (int j = 0; j < n_kt; ++j) {
      const int st = j % NS, k0 = (kt0 + j) * kWK;
      repro::mbar_wait(&full_bar[st], (j / NS) & 1);
      // some key of the tile is seen by one of the warpgroup's rows
      if (qw0 < S && (!w.m.causal || k0 < qw0 + 64) &&
          (w.m.window <= 0 || qw0 - (k0 + 63) < w.m.window)) {
        const uint32_t k_addr =
            repro::smem_u32(kstages + (size_t)st * 2 * kWK * DP);
        const uint32_t v_addr = k_addr + kWK * DP * 2;
        // S = Q K^T and dP = dO V^T: 64 rows x 64 keys each
        float s[32], dp[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) s[k] = dp[k] = 0.0f;
        repro::wgmma_fence();
        repro::reg_fence(s);
        repro::reg_fence(dp);
        scores64<D / 16>(s, q_addr, QR, k_addr);
        scores64<D / 16>(dp, do_addr, QR, v_addr);
        wait_scores(s, dp);
        // a tile the masks cut: the diagonal, the window's edge, keys
        // past S
        const bool edge = (w.m.causal && k0 + kWK > qw0) ||
                          (w.m.window > 0 && qw0 + 63 - k0 >= w.m.window) ||
                          k0 + kWK > S;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * n + gc + e;
            float p0 = repro::exp2_approx(s[4 * n + e] * w.scale2 - ld0.x);
            float p1 = repro::exp2_approx(s[4 * n + 2 + e] * w.scale2 - ld1.x);
            if (edge) {
              if (!w.m.sees(row0, key)) p0 = 0.0f;
              if (!w.m.sees(row1, key)) p1 = 0.0f;
            }
            dp[4 * n + e] = p0 * (dp[4 * n + e] - ld0.y);
            dp[4 * n + 2 + e] = p1 * (dp[4 * n + 2 + e] - ld1.y);
          }
        }
        uint32_t da[4][4];
        pack_a(dp, da);
        // dQ += dS K: K N-major in shared memory
        repro::wgmma_fence();
        repro::reg_fence(dqa);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          repro::wgmma_rs<NC>(dqa, da[kk], repro::wgmma_desc(
              k_addr + c0 / 64 * kWK * 128 + kk * 2048, kWK * 128, 1024));
        repro::wgmma_commit();
        repro::reg_fence(dqa);
        repro::wgmma_wait0();
        repro::reg_fence(dqa);
      }
      __syncwarp();
      if (lane == 0) repro::mbar_arrive(&empty_bar[st]);
    }

    const size_t r0 = ((size_t)b * w.H + h) * S;
#pragma unroll
    for (int n = 0; n < (L::kSplit ? NC : D) / 8; ++n) {
      const int col = c0 + n * 8 + gc;
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(w.out0 + (r0 + row0) * D + col) =
            repro::pack_bf16(dqa[4 * n] * w.scale, dqa[4 * n + 1] * w.scale);
      if (row1 < S)
        *reinterpret_cast<uint32_t*>(w.out0 + (r0 + row1) * D + col) =
            repro::pack_bf16(dqa[4 * n + 2] * w.scale,
                             dqa[4 * n + 3] * w.scale);
    }
  }
}

// the three launches of the wgmma route; stats: [B,H,Spad] float2 scratch
template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const void* lse,
                         void* stats, void* dq, void* dk, void* dv, int B,
                         int H, int KVH, const Mask& m, cudaStream_t st) {
  const int S = m.S;
  using L = WBwdSmem<D>;
  const int Spad = (S + kStatRows - 1) / kStatRows * kStatRows;
  const long long rows_pad = (long long)B * H * Spad;
  flash_bwd_stats<<<(unsigned)((rows_pad + 7) / 8), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<float2*>(stats), S, Spad,
      D, rows_pad);
  const float scale = (float)(1.0 / sqrt((double)D));   // the forward's
  WBwdArgs w{static_cast<const float2*>(stats), nullptr, nullptr, B, H, KVH,
             Spad, m, 0, 0, 0, 0, scale, scale * kLog2e};
  // contiguous [B, heads, S, D]: (head, row, batch) strides
  const long long sq = (long long)S * D, sk = sq;
  CUtensorMap tq, tk, tv, tdo;
  auto maps = [&](int q_rows, int k_rows) {
    return repro::make_map(&tq, q, D, H, sq, S, D, B, H * sq, 1, q_rows,
                           &w.q_perm) &&
           repro::make_map(&tdo, dout, D, H, sq, S, D, B, H * sq, 1, q_rows,
                           &w.do_perm) &&
           repro::make_map(&tk, k, D, KVH, sk, S, D, B, KVH * sk, 1, k_rows,
                           &w.k_perm) &&
           repro::make_map(&tv, v, D, KVH, sk, S, D, B, KVH * sk, 1, k_rows,
                           &w.v_perm);
  };
  static const cudaError_t a1 = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kDkdvBytes);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kDqBytes);
  if (a1 != cudaSuccess) return a1;
  if (a2 != cudaSuccess) return a2;
  const long long key_tiles = (S + L::kKeys - 1) / L::kKeys;
  const long long row_tiles = (S + L::kQRows - 1) / L::kQRows;
  if (!maps(kWQ, L::kKeys)) return cudaErrorInvalidValue;
  w.out0 = static_cast<__nv_bfloat16*>(dk);
  w.out1 = static_cast<__nv_bfloat16*>(dv);
  flash_bwd_dkdv_wgmma<D>
      <<<(unsigned)(key_tiles * KVH * B), kWThreads, L::kDkdvBytes, st>>>(
          tq, tk, tv, tdo, w);
  if (!maps(L::kQRows, kWK)) return cudaErrorInvalidValue;
  w.out0 = static_cast<__nv_bfloat16*>(dq);
  w.out1 = nullptr;
  flash_bwd_dq_wgmma<D>
      <<<(unsigned)(row_tiles * H * B), kWThreads, L::kDqBytes, st>>>(
          tq, tk, tv, tdo, w);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: [B,H,S,D]; k, v, dk, dv: [B,KVH,S,D], all contiguous
// (dtype 0 = float32, 1 = bfloat16, shared by all of them); lse: [B,H,S]
// fp32 (the forward's, natural log of each row's sum of exp(scale q.k)).
// Query i at position i; key j seen by query i when j < S and, when
// causal, j <= i and, with a window (window > 0, causal only), i - j <
// window.  The route follows flash/ops.py's flash_bwd_plan: bf16 at D =
// 64, 80, 96, 128 or 256 runs wgmma, with dr the stats scratch, fp32
// [B,H,Spad,2], Spad = S rounded up to a multiple of 128; otherwise CUDA
// cores (D = 16, 32, 64, 80, 96, 128, 256), with dr fp32 [B,H,S].
extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* dr, void* dq, void* dk,
                               void* dv, int B, int H, int KVH, int S, int D,
                               int causal, int window, int dtype,
                               void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH || S <= 0 || B > 65535 ||
      H > 65535 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Mask m{S, causal ? 1 : 0, window > 0 ? window : 0};
  if (dtype == 1 && D >= 64) {
    switch (D) {
      case 64: return (int)launch_wgmma<64>(q, k, v, o, dout, lse, dr, dq, dk, dv, B, H, KVH, m, st);
      case 80: return (int)launch_wgmma<80>(q, k, v, o, dout, lse, dr, dq, dk, dv, B, H, KVH, m, st);
      case 96: return (int)launch_wgmma<96>(q, k, v, o, dout, lse, dr, dq, dk, dv, B, H, KVH, m, st);
      case 128: return (int)launch_wgmma<128>(q, k, v, o, dout, lse, dr, dq, dk, dv, B, H, KVH, m, st);
      case 256: return (int)launch_wgmma<256>(q, k, v, o, dout, lse, dr, dq, dk, dv, B, H, KVH, m, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  cudaError_t err =
      dtype == 0 ? dispatch<float>(q, k, v, o, dout, lse, dr, dq, dk, dv, B,
                                   H, KVH, m, D, st)
      : dtype == 1 ? dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, dr, dq,
                                             dk, dv, B, H, KVH, m, D, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
