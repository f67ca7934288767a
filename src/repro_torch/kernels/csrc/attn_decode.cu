// Flash decode: one query token per head against a KV cache, with early
// exit past each row's valid length and a split-K partial-softmax merge.
//
// Replaces the TPU kernel decode_attention_pallas
// (src/repro/kernels/attn_decode/kernel.py:82, body _decode_kernel :38,
// split merge :146-150).
//
// Bound on the H100: bytes.  Each live key and value row is read once
// (zamba2-2.7b, B=4, 32 KV heads of d=80 in bf16: 10 KB per position of a
// row), a few operations per byte; at valid lengths 301/701/1001/2048 the
// call moves about 41 MB, ~12 us at 3.35 TB/s.
//
// Design: the TPU walks a split's KV blocks along a sequential grid axis.
// Here one block owns one (batch row, KV head, split) and keeps the G query
// rows of the group in shared memory.  Its W warps walk the split's
// 32-key tiles in turn (warp w takes tiles w, w+W, ...): each warp stages
// its tile of K and V in its own shared memory with 16-byte loads, all
// issued before the first store so they are in flight together, lane j
// scores key j for every query of the group, and each lane accumulates its
// own columns of the output, with (m, l, acc) in registers.  Tiles that
// start at or past valid_len[b] are never read.  At the end the block merges
// its W warps' partials.  W is four, or two for fp32 at d=256, where four
// warps' staged tiles (4 x 64 KB) would pass the 227 KB a block may hold.  With one split the block writes the output;
// with several it writes its unnormalised (acc, m, l), and a second small
// kernel merges the splits exactly as at :146-150 (empty splits carry
// m = -1e30 and l = 0 and vanish).  The split count is the caller's
// (ops.py states the rule); the result does not depend on it beyond
// rounding.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 32;     // keys per warp tile, one per lane
constexpr int kMaxG = 8;      // query heads per KV head
constexpr int kLoadBatch = 10;  // 16-byte loads per lane in flight, K and V

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  const int* valid;          // [B]
  void* o;                   // [B, H, D] when nsplit == 1
  float* part_acc;           // [B, KVH, nsplit, G, D] when nsplit > 1
  float* part_ml;            // [B, KVH, nsplit, G, 2]
  int H, KVH, S, G, nsplit, split_len;
  long long q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float scale;
};

// shared-memory row of a staged key tile: an odd number of 32-bit words,
// so lane j reading row j hits bank j
template <typename T> struct KeyRow;
template <> struct KeyRow<float> { static constexpr int pad = 1; };
template <> struct KeyRow<__nv_bfloat16> { static constexpr int pad = 2; };

__device__ __forceinline__ float2 pair_f32(const float* p) {
  return make_float2(p[0], p[1]);
}
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T, int D>
struct Smem {
  static constexpr int kWarps = (sizeof(T) == 4 && D > 128) ? 2 : 4;
  static constexpr int KST = D + KeyRow<T>::pad;
  static constexpr size_t kWarpBytes =
      ((size_t)kTile * KST + (size_t)kTile * D) * sizeof(T);
  static constexpr size_t kQBytes = (size_t)kMaxG * D * sizeof(float);
  static constexpr size_t kBytes = kQBytes + kWarps * kWarpBytes;
};

template <typename T, int D>
__global__ void __launch_bounds__(Smem<T, D>::kWarps * 32)
decode_kernel(DecodeParams p) {
  using L = Smem<T, D>;
  constexpr int kWarps = L::kWarps;
  constexpr int KST = L::KST;
  constexpr int VEC = 16 / sizeof(T);        // elements per 16-byte load
  constexpr int NV = D / VEC;                // 16-byte loads per row
  constexpr int NC = (D + 31) / 32;          // output columns per lane
  static_assert(D % VEC == 0, "head_dim must fill 16-byte loads");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);               // [G][D]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* ks = reinterpret_cast<T*>(smem_raw + L::kQBytes + warp * L::kWarpBytes);
  T* vs = ks + kTile * KST;

  const int sp = blockIdx.x % p.nsplit;
  const int bk = blockIdx.x / p.nsplit;          // b * KVH + kvh
  const int b = bk / p.KVH, kvh = bk % p.KVH;
  const int G = p.G;
  const int valid = min(p.valid[b], p.S);
  const int lo = sp * p.split_len;
  const int hi = min(lo + p.split_len, valid);

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb;
  for (int e = tid; e < G * D; e += kWarps * 32) {
    const int g = e / D, d = e % D;
    qs[e] = repro::to_f32(qg[(long long)(kvh * G + g) * p.q_sh + d]);
  }
  __syncthreads();

  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float m[kMaxG], l[kMaxG], acc[kMaxG][NC];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[g][c] = 0.0f;
  }

  for (int k0 = lo + warp * kTile; k0 < hi; k0 += kWarps * kTile) {
    // the loads of a batch are all issued before its first store, so a
    // lane keeps 2 * kLoadBatch loads in flight at once
#pragma unroll
    for (int i0 = 0; i0 < NV; i0 += kLoadBatch) {
      uint4 kv[kLoadBatch], vv[kLoadBatch];
#pragma unroll
      for (int i = 0; i < kLoadBatch; ++i) {
        const int e = lane + 32 * (i0 + i), r = e / NV, c = e % NV;
        kv[i] = vv[i] = make_uint4(0, 0, 0, 0);
        if (i0 + i < NV && k0 + r < hi) {
          kv[i] = *reinterpret_cast<const uint4*>(
              kg + (long long)(k0 + r) * p.k_ss + c * VEC);
          vv[i] = *reinterpret_cast<const uint4*>(
              vg + (long long)(k0 + r) * p.v_ss + c * VEC);
        }
      }
#pragma unroll
      for (int i = 0; i < kLoadBatch; ++i) {
        if (i0 + i >= NV) break;
        const int e = lane + 32 * (i0 + i), r = e / NV, c = e % NV;
        // key rows are an odd number of words long: store word by word
        uint32_t* kw = reinterpret_cast<uint32_t*>(ks + r * KST + c * VEC);
        kw[0] = kv[i].x;
        kw[1] = kv[i].y;
        kw[2] = kv[i].z;
        kw[3] = kv[i].w;
        *reinterpret_cast<uint4*>(vs + r * D + c * VEC) = vv[i];
      }
    }
    __syncwarp();
    const bool live = k0 + lane < hi;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float s = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; d += 2) {
        const float2 kk = pair_f32(ks + lane * KST + d);
        s = fmaf(qs[g * D + d], kk.x, s);
        s = fmaf(qs[g * D + d + 1], kk.y, s);
      }
      s = live ? s * p.scale : kNegInf;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[g], mx);
      const float pr = expf(s - mn);
      const float corr = expf(m[g] - mn);
      float sum = pr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[g] = l[g] * corr + sum;
      m[g] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[g][c] *= corr;
      for (int j = 0; j < kTile; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[g][c] = fmaf(pj, repro::to_f32(vs[j * D + d]),
                                      acc[g][c]);
        }
      }
    }
    __syncwarp();   // the tile is consumed before the warp refills it
  }

  // merge the four warps: partials through shared memory (reusing the
  // tiles), then threads over (g, d)
  __syncthreads();
  float* wml = reinterpret_cast<float*>(smem_raw + L::kQBytes);  // [W][G][2]
  float* wacc = wml + kWarps * kMaxG * 2;                        // [W][G][D]
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      wml[(warp * kMaxG + g) * 2] = m[g];
      wml[(warp * kMaxG + g) * 2 + 1] = l[g];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) wacc[(warp * kMaxG + g) * D + d] = acc[g][c];
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kWarps * 32) {
    const int g = e / D, d = e % D;
    float mall = kNegInf;
    for (int w = 0; w < kWarps; ++w)
      mall = fmaxf(mall, wml[(w * kMaxG + g) * 2]);
    float lsum = 0.0f, a = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float alpha = expf(wml[(w * kMaxG + g) * 2] - mall);
      lsum += wml[(w * kMaxG + g) * 2 + 1] * alpha;
      a += wacc[(w * kMaxG + g) * D + d] * alpha;
    }
    if (p.nsplit == 1) {
      T* og = static_cast<T*>(p.o) + ((long long)b * p.H + kvh * G + g) * D;
      og[d] = repro::from_f32<T>(a / fmaxf(lsum, 1e-37f));
    } else {
      const long long row = ((long long)bk * p.nsplit + sp) * G + g;
      p.part_acc[row * D + d] = a;
      if (d == 0) {
        p.part_ml[row * 2] = mall;
        p.part_ml[row * 2 + 1] = lsum;
      }
    }
  }
}

// exact online-softmax merge of the split partials: one block per
// (batch row, KV head), threads over (g, d)
template <typename T>
__global__ void __launch_bounds__(128)
merge_kernel(const float* __restrict__ part_acc,
             const float* __restrict__ part_ml, T* __restrict__ o, int H,
             int KVH, int G, int D, int nsplit) {
  const int bk = blockIdx.x;
  const int b = bk / KVH, kvh = bk % KVH;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D, d = e % D;
    float mall = kNegInf;
    for (int s = 0; s < nsplit; ++s)
      mall = fmaxf(mall, part_ml[(((long long)bk * nsplit + s) * G + g) * 2]);
    float lsum = 0.0f, a = 0.0f;
    for (int s = 0; s < nsplit; ++s) {
      const long long row = ((long long)bk * nsplit + s) * G + g;
      const float alpha = expf(part_ml[row * 2] - mall);
      lsum += part_ml[row * 2 + 1] * alpha;
      a += part_acc[row * D + d] * alpha;
    }
    o[((long long)b * H + kvh * G + g) * D + d] =
        repro::from_f32<T>(a / fmaxf(lsum, 1e-37f));
  }
}

template <typename T, int D>
cudaError_t launch(const DecodeParams& p, int B, cudaStream_t st) {
  auto kern = decode_kernel<T, D>;
  const size_t bytes = Smem<T, D>::kBytes;
  // once per instantiation, so a launch inside CUDA-graph capture makes no
  // configuration call
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  kern<<<B * p.KVH * p.nsplit, Smem<T, D>::kWarps * 32, bytes, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return err;
  merge_kernel<T><<<B * p.KVH, 128, 0, st>>>(
      p.part_acc, p.part_ml, static_cast<T*>(p.o), p.H, p.KVH, p.G, D,
      p.nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const DecodeParams& p, int B, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(p, B, st);
    case 32: return launch<T, 32>(p, B, st);
    case 64: return launch<T, 64>(p, B, st);
    case 80: return launch<T, 80>(p, B, st);
    case 128: return launch<T, 128>(p, B, st);
    case 256: return launch<T, 256>(p, B, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [B,H,D] through (batch, head) strides; k, v: [B,KVH,S,D] through
// (batch, head, row) strides, unit stride along D; valid: [B] int32;
// o: [B,H,D] contiguous; part_acc [B,KVH,nsplit,G,D] and part_ml
// [B,KVH,nsplit,G,2] fp32 scratch, used when nsplit > 1; split_len keys
// per split, a multiple of 32.  dtype 0 = float32, 1 = bfloat16.
extern "C" int repro_decode_attn_fwd(
    const void* q, const void* k, const void* v, const void* valid, void* o,
    void* part_acc, void* part_ml, int B, int H, int KVH, int S, int D,
    int nsplit, int split_len, long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH || H / KVH > kMaxG || S <= 0 ||
      nsplit <= 0 || split_len <= 0 || split_len % kTile ||
      (long long)nsplit * split_len < S)
    return (int)cudaErrorInvalidValue;
  DecodeParams p{q, k, v, static_cast<const int*>(valid), o,
                 static_cast<float*>(part_acc), static_cast<float*>(part_ml),
                 H, KVH, S, H / KVH, nsplit, split_len,
                 q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                 (float)(1.0 / sqrt((double)D))};   // the reference's scale
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(p, B, D, st);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(p, B, D, st);
  return (int)cudaErrorInvalidValue;
}
