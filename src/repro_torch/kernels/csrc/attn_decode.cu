// Flash decode: one query token per head against a KV cache, with early
// exit past each row's valid length and a split-K partial-softmax merge
// done inside the kernel.
//
// Replaces the TPU kernel decode_attention_pallas
// (src/repro/kernels/attn_decode/kernel.py:82, body _decode_kernel :38,
// split merge :146-150).
//
// Bound on the H100: bytes.  Each live key and value row is read once
// (gemma3-1b, B=4, one KV head of d=256 in bf16: 1 KB per position of a
// row), a few operations per byte; at valid lengths 301/701/1001/2048 the
// call moves about 4.2 MB, ~1.2 us at 3.35 TB/s.
//
// Design: the TPU walks a split's KV blocks along a sequential grid axis.
// Here one block owns one (batch row, KV head, split) and the whole query
// group (G <= 16 heads).  The split rule (ops.py) gives about two waves of
// blocks over the 132 SMs, down to one 64-key tile per split; at gemma3-1b's
// single KV head even its ring decode (512 slots) reads one tile a block,
// so a block keeps the group rather than owning one head: more blocks would
// re-read K/V for a call whose time is the latency of one tile.  Splits
// that start at or past valid_len[b] return at once.
//
// bf16: tensor cores with no padding waste at G <= 8.  The keys sit on the
// M side of mma.sync m16n8k16 and the group's queries on N = 8:
// S^T = K Q^T, then O^T = V^T P^T with head_dim on M.  A group of 9 to 16
// (glm4-9b: 32 query heads on 2 KV heads) takes a second N = 8 tile of
// queries in the same block (NT = 2): each K and V fragment loaded from
// shared memory feeds both tiles' products, so K and V are still read
// once per KV head, and each tile keeps its own softmax state.  G <= 8
// runs the NT = 1 instance, the same code as before the second tile.  Each of the four
// warps takes 16 keys of every 64-key tile and keeps its own (m, l, O^T)
// in registers; P is rounded to bf16 for the second product (as the flash
// kernel does) and moved from the accumulator layout to the B operand's
// by movmatrix.  K/V tiles stream through a 3-stage cp.async ring, so two
// tiles load while one is scored; rows at or past the split's end are
// zero-filled, so stale cache rows (NaN included) never reach P.V.
// fp32: CUDA cores, as before (TF32 would break fp32's 2e-4 limit): lane j
// scores key j of a warp's 32-key tile; GM (8 or 16) sizes the per-query
// registers and shared arrays.
//
// The merge: the block first merges its warps through shared memory.  With
// one live split it writes the output.  Otherwise it writes its unnormalised
// (acc, m, l) to fp32 scratch, fences, and takes a ticket from a per-(row,
// KV head) counter; the block that draws the last ticket merges the live
// splits exactly as at :146-150 (a split with no live key carries
// m = -1e30, l = 0 and vanishes) and writes the counter back to zero, so
// the next call, or the next replay of a CUDA graph, starts from zero.
// One launch per call.
//
// Partials mode (out_acc set; a rank's share of a cache whose rows are
// split over ranks): the same merge of the block's own splits, but written
// without the final normalisation, as the unnormalised fp32 acc [B, H, D]
// and (m, l) [B, H, 2] over this call's keys.  The caller merges the
// ranks' partials as finish_split merges splits.  A row with no live key
// (valid 0: a rank whose rows all lie past valid_len) runs one empty
// split and writes m = -1e30, l = 0 and acc = 0, which the merge weighs
// by exp(-1e30 - max m) = 0.  At most 16 splits: the merging block loads every
// split's partial at once, and its time grows with their number (a first
// version with 32 one-tile splits at gemma3-1b's global layers, merged one
// load at a time, lost to SDPA).
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;
using repro::movmatrix_trans;
using repro::pack_bf16;

constexpr float kNegInf = -1e30f;
constexpr int kGTile = 8;      // queries per N tile of mma.sync m16n8k16
constexpr int kMaxG = 16;      // query heads per KV head: two N tiles
constexpr int kSplitTile = 64; // split_len is a multiple of this
constexpr int kMaxSplit = 16;  // splits per (row, KV head)

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  const int* valid;          // [B]
  void* o;                   // [B, H, D]; unused in partials mode
  float* out_acc;            // partials mode: [B, H, D] fp32, else null
  float* out_ml;             // partials mode: [B, H, 2] fp32 (m, l)
  float* part_acc;           // [B, KVH, nsplit, G, D] when nsplit > 1
  float* part_ml;            // [B, KVH, nsplit, G, 2]
  int* tickets;              // [B * KVH], zero between calls
  int H, KVH, S, G, nsplit, split_len;
  long long q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float scale;
};

// ------------------------------------------------------------ the merge

// Called by every thread of a live split's block once the block's own
// (m, l, acc) for each (g, d) sit in shared memory: ml [G][2], acc [G][D].
// Writes the output (one live split) or the partial, and merges the splits
// in the block that finishes last: first each query's weights
// exp(m_s - max m) / sum_s l_s exp(m_s - max m), then the outputs four
// columns a thread, every split's partial loaded before the first is
// summed, so the merge costs one round trip to L2 rather than one per
// split.  In partials mode the weights leave out the division and the
// block writes (max m, sum_s l_s exp(m_s - max m)) beside the sums.
template <typename T, int D, int GM>
__device__ void finish_split(const DecodeParams& p, const float* ml,
                             const float* acc, int b, int kvh, int sp,
                             int nlive) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int G = p.G;
  const int bk = b * p.KVH + kvh;
  const long long row = (long long)b * p.H + kvh * G;   // first query head
  T* og = p.o != nullptr ? static_cast<T*>(p.o) + row * D : nullptr;
  float* oacc = p.out_acc != nullptr ? p.out_acc + row * D : nullptr;
  float* oml = p.out_ml != nullptr ? p.out_ml + row * 2 : nullptr;
  if (nlive == 1) {
    if (p.out_acc != nullptr) {
      for (int e = tid; e < G * D; e += nthr) oacc[e] = acc[e];
      if (tid < 2 * G) oml[tid] = ml[tid];
      return;
    }
    for (int e = tid; e < G * D; e += nthr)
      og[e] = repro::from_f32<T>(acc[e] /
                                 fmaxf(ml[(e / D) * 2 + 1], 1e-37f));
    return;
  }
  // partials [nsplit][G][D] and [nsplit][G][2] of this (row, KV head)
  float* pacc = p.part_acc + (long long)bk * p.nsplit * G * D;
  float* pml = p.part_ml + (long long)bk * p.nsplit * G * 2;
  for (int e = tid; e < G * D; e += nthr)
    pacc[(long long)sp * G * D + e] = acc[e];
  if (tid < 2 * G) pml[sp * G * 2 + tid] = ml[tid];
  __threadfence();
  __syncthreads();
  __shared__ int last;
  __shared__ float w[kMaxSplit][GM];
  if (tid == 0) last = atomicAdd(&p.tickets[bk], 1) == nlive - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid < G) {
    float m[kMaxSplit], l[kMaxSplit];
    float mall = kNegInf;
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s) {
      m[s] = s < nlive ? __ldcg(pml + (s * G + tid) * 2) : kNegInf;
      l[s] = s < nlive ? __ldcg(pml + (s * G + tid) * 2 + 1) : 0.0f;
      mall = fmaxf(mall, m[s]);
    }
    float lsum = 0.0f;
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s) {
      m[s] = expf(m[s] - mall);
      lsum += l[s] * m[s];
    }
    float inv = 1.0f / fmaxf(lsum, 1e-37f);
    if (p.out_acc != nullptr) {
      oml[tid * 2] = mall;
      oml[tid * 2 + 1] = lsum;
      inv = 1.0f;
    }
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s) w[s][tid] = m[s] * inv;
  }
  __syncthreads();
  for (int c = tid; c < G * D / 4; c += nthr) {
    const int g = c / (D / 4);
    float4 a[kMaxSplit];
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s)
      if (s < nlive)
        a[s] = __ldcg(reinterpret_cast<const float4*>(
            pacc + (long long)s * G * D) + c);
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s) {
      if (s < nlive) {
        o.x = fmaf(w[s][g], a[s].x, o.x);
        o.y = fmaf(w[s][g], a[s].y, o.y);
        o.z = fmaf(w[s][g], a[s].z, o.z);
        o.w = fmaf(w[s][g], a[s].w, o.w);
      }
    }
    if (p.out_acc != nullptr) {
      reinterpret_cast<float4*>(oacc)[c] = o;
    } else {
      og[4 * c] = repro::from_f32<T>(o.x);
      og[4 * c + 1] = repro::from_f32<T>(o.y);
      og[4 * c + 2] = repro::from_f32<T>(o.z);
      og[4 * c + 3] = repro::from_f32<T>(o.w);
    }
  }
  if (tid == 0) p.tickets[bk] = 0;
}

// key slot `key` of a split that ends at `hi` (its end or valid_len)
__device__ __forceinline__ bool key_live(int key, int hi) {
  return key < hi;
}

// the live splits of batch row b: those that start before valid_len
__device__ __forceinline__ int live_splits(const DecodeParams& p, int valid) {
  return max(1, min(p.nsplit, (valid + p.split_len - 1) / p.split_len));
}

// merge W warps' (m, l, acc) held in shared memory as wml [W][GM][2]
// and wacc [W][GM][D] into ml [G][2] and acc [G][D]
template <int D, int W, int GM>
__device__ void merge_warps(const float* wml, const float* wacc, float* ml,
                            float* acc, int G) {
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D, d = e % D;
    float mall = kNegInf;
#pragma unroll
    for (int w = 0; w < W; ++w) mall = fmaxf(mall, wml[(w * GM + g) * 2]);
    float lsum = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float alpha = expf(wml[(w * GM + g) * 2] - mall);
      lsum += wml[(w * GM + g) * 2 + 1] * alpha;
      a += wacc[(w * GM + g) * D + d] * alpha;
    }
    acc[e] = a;
    if (d == 0) {
      ml[g * 2] = mall;
      ml[g * 2 + 1] = lsum;
    }
  }
}

// ------------------------------------------------------ bf16, tensor cores

constexpr int kTile = 64;      // keys per pipeline stage, 16 per warp
constexpr int kWarps = 4;
constexpr int kStages = 3;

template <int D, int NT>
struct Bf16Smem {
  static constexpr int DP = D + 8;   // padded row: ldmatrix hits 8 banks
  static constexpr int GM = NT * kGTile;
  static constexpr size_t kStageBytes = (size_t)2 * kTile * DP * 2;
  static constexpr size_t kMergeBytes =
      (size_t)(kWarps + 1) * GM * (D + 2) * sizeof(float);
  static constexpr size_t kBytes =
      kStages * kStageBytes > kMergeBytes ? kStages * kStageBytes
                                          : kMergeBytes;
};

// rows [r0, r0 + kTile) of K and V into one stage; rows at or past hi are
// zeros
template <int D>
__device__ __forceinline__ void load_stage(__nv_bfloat16* ks,
                                           __nv_bfloat16* vs,
                                           const __nv_bfloat16* kg,
                                           const __nv_bfloat16* vg,
                                           const DecodeParams& p, int r0,
                                           int hi, int tid) {
  constexpr int DP = Bf16Smem<D, 1>::DP, V = D / 8;
  for (int e = tid; e < kTile * V; e += kWarps * 32) {
    const int r = e / V, c = e % V;
    const bool ok = r0 + r < hi;
    cp_async16(ks + r * DP + c * 8,
               ok ? kg + (long long)(r0 + r) * p.k_ss + c * 8 : kg,
               ok ? 16 : 0);
    cp_async16(vs + r * DP + c * 8,
               ok ? vg + (long long)(r0 + r) * p.v_ss + c * 8 : vg,
               ok ? 16 : 0);
  }
}

template <int D, int NT>
__global__ void __launch_bounds__(kWarps * 32)
decode_bf16_kernel(DecodeParams p) {
  using L = Bf16Smem<D, NT>;
  constexpr int DP = L::DP;
  constexpr int GM = L::GM;
  constexpr int KD = D / 16;     // k-steps of S^T = K Q^T; m-tiles of O^T
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");

  const int sp = blockIdx.x % p.nsplit;
  const int bk = blockIdx.x / p.nsplit;          // b * KVH + kvh
  const int b = bk / p.KVH, kvh = bk % p.KVH;
  const int valid = min(p.valid[b], p.S);
  const int nlive = live_splits(p, valid);
  if (sp >= nlive) return;
  const int lo = sp * p.split_len;
  const int hi = min(lo + p.split_len, valid);
  const int nt = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stage0 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                            b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                            b * p.v_sb + kvh * p.v_sh;
  auto kstage = [&](int s) { return stage0 + (size_t)s * 2 * kTile * DP; };
  auto vstage = [&](int s) { return kstage(s) + kTile * DP; };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) load_stage<D>(kstage(s), vstage(s), kg, vg, p,
                              lo + s * kTile, hi, tid);
    cp_async_commit();
  }

  const int gr = lane >> 2, gc = (lane & 3) * 2;
  const int G = p.G;
  // Q^T as the B operand of S^T = K Q^T, one N tile of 8 queries each:
  // query 8j + gr of tile j, dims 16kk + gc (+1, +8, +9); queries past the
  // group are zeros
  uint32_t qb[NT][KD][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int g = j * kGTile + gr;
    const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                              b * p.q_sb + (long long)(kvh * G + g) * p.q_sh;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      qb[j][kk][0] = g < G ? *reinterpret_cast<const uint32_t*>(
                                 qg + kk * 16 + gc) : 0u;
      qb[j][kk][1] = g < G ? *reinterpret_cast<const uint32_t*>(
                                 qg + kk * 16 + gc + 8) : 0u;
    }
  }

  // O^T [d][g] of tile j: m-tile kk holds dims 16kk + gr (+8), queries
  // 8j + gc, 8j + gc + 1
  float acc[NT][KD][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      acc[j][kk][0] = acc[j][kk][1] = acc[j][kk][2] = acc[j][kk][3] = 0.0f;
  // queries 8j + gc and 8j + gc + 1
  float m0[NT], m1[NT], l0[NT], l1[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    m0[j] = m1[j] = kNegInf;
    l0[j] = l1[j] = 0.0f;
  }

  // ldmatrix row addresses: K (A of S^T, row-major keys x dims) and V
  // (A of O^T = V^T, read transposed)
  const int krow = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int kcol = (lane >> 4) * 8;
  const int vrow = warp * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
  const int vcol = ((lane >> 3) & 1) * 8;

  for (int i = 0; i < nt; ++i) {
    const int pre = i + kStages - 1;
    if (pre < nt) load_stage<D>(kstage(pre % kStages), vstage(pre % kStages),
                                kg, vg, p, lo + pre * kTile, hi, tid);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const __nv_bfloat16* kt = kstage(i % kStages);
    const __nv_bfloat16* vt = vstage(i % kStages);

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4];
      ldmatrix_x4(ka, kt + krow * DP + kk * 16 + kcol);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(s[j], ka, qb[j][kk][0], qb[j][kk][1]);
    }
    // keys k0 + gr and k0 + gr + 8 of this warp's 16
    const int k0 = lo + i * kTile + warp * 16;
    const bool live0 = key_live(k0 + gr, hi);
    const bool live1 = key_live(k0 + gr + 8, hi);
    float c0[NT], c1[NT];
    uint32_t pb0[NT], pb1[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = live0 ? s[j][0] * p.scale : kNegInf;
      s[j][1] = live0 ? s[j][1] * p.scale : kNegInf;
      s[j][2] = live1 ? s[j][2] * p.scale : kNegInf;
      s[j][3] = live1 ? s[j][3] * p.scale : kNegInf;
      float mx0 = fmaxf(s[j][0], s[j][2]), mx1 = fmaxf(s[j][1], s[j][3]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0[j], mx0), mn1 = fmaxf(m1[j], mx1);
      c0[j] = expf(m0[j] - mn0);
      c1[j] = expf(m1[j] - mn1);
      m0[j] = mn0;
      m1[j] = mn1;
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn1);
      s[j][2] = expf(s[j][2] - mn0);
      s[j][3] = expf(s[j][3] - mn1);
      // this thread's keys; summed over the warp at the end
      l0[j] = l0[j] * c0[j] + s[j][0] + s[j][2];
      l1[j] = l1[j] * c1[j] + s[j][1] + s[j][3];
      // P^T as the B operand of O^T = V^T P^T: keys 2(t%4) (+1, +8, +9)
      // of query t/4, the transposes of the accumulator's two 8x8 blocks
      pb0[j] = movmatrix_trans(pack_bf16(s[j][0], s[j][1]));
      pb1[j] = movmatrix_trans(pack_bf16(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t va[4];
      ldmatrix_x4_trans(va, vt + vrow * DP + kk * 16 + vcol);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][kk][0] *= c0[j];
        acc[j][kk][1] *= c1[j];
        acc[j][kk][2] *= c0[j];
        acc[j][kk][3] *= c1[j];
        mma_bf16(acc[j][kk], va, pb0[j], pb1[j]);
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();

  // the four warps' partials through shared memory (reusing the stages)
  float* wml = reinterpret_cast<float*>(smem_raw);   // [W][GM][2]
  float* wacc = wml + kWarps * GM * 2;               // [W][GM][D]
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      l0[j] += __shfl_xor_sync(0xffffffffu, l0[j], off);
      l1[j] += __shfl_xor_sync(0xffffffffu, l1[j], off);
    }
    const int g0 = j * kGTile + gc, g1 = g0 + 1;
    if (gr == 0) {
      if (g0 < G) {
        wml[(warp * GM + g0) * 2] = m0[j];
        wml[(warp * GM + g0) * 2 + 1] = l0[j];
      }
      if (g1 < G) {
        wml[(warp * GM + g1) * 2] = m1[j];
        wml[(warp * GM + g1) * 2 + 1] = l1[j];
      }
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int d = kk * 16 + gr;
      if (g0 < G) {
        wacc[(warp * GM + g0) * D + d] = acc[j][kk][0];
        wacc[(warp * GM + g0) * D + d + 8] = acc[j][kk][2];
      }
      if (g1 < G) {
        wacc[(warp * GM + g1) * D + d] = acc[j][kk][1];
        wacc[(warp * GM + g1) * D + d + 8] = acc[j][kk][3];
      }
    }
  }
  __syncthreads();
  float* ml = wacc + kWarps * GM * D;                // [G][2]
  float* bacc = ml + GM * 2;                         // [G][D]
  merge_warps<D, kWarps, GM>(wml, wacc, ml, bacc, G);
  __syncthreads();
  finish_split<__nv_bfloat16, D, GM>(p, ml, bacc, b, kvh, sp, nlive);
}

// ------------------------------------------------------- fp32, CUDA cores

constexpr int kFTile = 32;      // keys per warp tile, one per lane
constexpr int kLoadBatch = 10;  // 16-byte loads per lane in flight, K and V

template <int D, int GM>
struct F32Smem {
  // two warps at d=256, where four warps' staged tiles (4 x 64 KB) would
  // pass the 227 KB a block may hold
  static constexpr int kWarps = D > 128 ? 2 : 4;
  static constexpr int KST = D + 1;   // odd key rows: lane j hits bank j
  static constexpr size_t kWarpBytes =
      ((size_t)kFTile * KST + (size_t)kFTile * D) * sizeof(float);
  static constexpr size_t kQBytes = (size_t)GM * D * sizeof(float);
  static constexpr size_t kMergeBytes =
      ((size_t)kWarps * GM * (D + 2) + GM * (D + 2)) * sizeof(float);
  static constexpr size_t kTileBytes = kQBytes + kWarps * kWarpBytes;
  static constexpr size_t kBytes =
      kTileBytes > kMergeBytes ? kTileBytes : kMergeBytes;
};

template <int D, int GM>
__global__ void __launch_bounds__(F32Smem<D, GM>::kWarps * 32)
decode_f32_kernel(DecodeParams p) {
  using L = F32Smem<D, GM>;
  constexpr int kW = L::kWarps;
  constexpr int KST = L::KST;
  constexpr int NV = D / 4;                  // 16-byte loads per row
  constexpr int NC = (D + 31) / 32;          // output columns per lane

  const int sp = blockIdx.x % p.nsplit;
  const int bk = blockIdx.x / p.nsplit;
  const int b = bk / p.KVH, kvh = bk % p.KVH;
  const int G = p.G;
  const int valid = min(p.valid[b], p.S);
  const int nlive = live_splits(p, valid);
  if (sp >= nlive) return;
  const int lo = sp * p.split_len;
  const int hi = min(lo + p.split_len, valid);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);               // [G][D]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* ks = reinterpret_cast<float*>(smem_raw + L::kQBytes +
                                       warp * L::kWarpBytes);
  float* vs = ks + kFTile * KST;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb;
  for (int e = tid; e < G * D; e += kW * 32) {
    const int g = e / D, d = e % D;
    qs[e] = qg[(long long)(kvh * G + g) * p.q_sh + d];
  }
  __syncthreads();

  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb +
                    kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb +
                    kvh * p.v_sh;
  float m[GM], l[GM], acc[GM][NC];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[g][c] = 0.0f;
  }

  for (int k0 = lo + warp * kFTile; k0 < hi; k0 += kW * kFTile) {
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
              kg + (long long)(k0 + r) * p.k_ss + c * 4);
          vv[i] = *reinterpret_cast<const uint4*>(
              vg + (long long)(k0 + r) * p.v_ss + c * 4);
        }
      }
#pragma unroll
      for (int i = 0; i < kLoadBatch; ++i) {
        if (i0 + i >= NV) break;
        const int e = lane + 32 * (i0 + i), r = e / NV, c = e % NV;
        // key rows are an odd number of words long: store word by word
        float* kw = ks + r * KST + c * 4;
        kw[0] = __uint_as_float(kv[i].x);
        kw[1] = __uint_as_float(kv[i].y);
        kw[2] = __uint_as_float(kv[i].z);
        kw[3] = __uint_as_float(kv[i].w);
        *reinterpret_cast<uint4*>(vs + r * D + c * 4) = vv[i];
      }
    }
    __syncwarp();
    const bool live = key_live(k0 + lane, hi);
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      float s = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d)
        s = fmaf(qs[g * D + d], ks[lane * KST + d], s);
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
      for (int j = 0; j < kFTile; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[g][c] = fmaf(pj, vs[j * D + d], acc[g][c]);
        }
      }
    }
    __syncwarp();   // the tile is consumed before the warp refills it
  }

  __syncthreads();
  float* wml = reinterpret_cast<float*>(smem_raw);   // [W][GM][2]
  float* wacc = wml + kW * GM * 2;                   // [W][GM][D]
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      wml[(warp * GM + g) * 2] = m[g];
      wml[(warp * GM + g) * 2 + 1] = l[g];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) wacc[(warp * GM + g) * D + d] = acc[g][c];
    }
  }
  __syncthreads();
  float* ml = wacc + kW * GM * D;                    // [G][2]
  float* bacc = ml + GM * 2;                         // [G][D]
  merge_warps<D, kW, GM>(wml, wacc, ml, bacc, G);
  __syncthreads();
  finish_split<float, D, GM>(p, ml, bacc, b, kvh, sp, nlive);
}

// NT N tiles of 8 queries: 1 for G <= 8, 2 for G <= 16
template <typename T, int D, int NT>
cudaError_t launch(const DecodeParams& p, int B, cudaStream_t st) {
  void (*kern)(DecodeParams);
  size_t bytes;
  int threads;
  if constexpr (sizeof(T) == 2) {
    kern = decode_bf16_kernel<D, NT>;
    bytes = Bf16Smem<D, NT>::kBytes;
    threads = kWarps * 32;
  } else {
    kern = decode_f32_kernel<D, NT * kGTile>;
    bytes = F32Smem<D, NT * kGTile>::kBytes;
    threads = F32Smem<D, NT * kGTile>::kWarps * 32;
  }
  // once per instantiation, so a launch inside CUDA-graph capture makes no
  // configuration call
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  kern<<<B * p.KVH * p.nsplit, threads, bytes, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int NT>
cudaError_t dispatch_d(const DecodeParams& p, int B, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16, NT>(p, B, st);
    case 32: return launch<T, 32, NT>(p, B, st);
    case 64: return launch<T, 64, NT>(p, B, st);
    case 80: return launch<T, 80, NT>(p, B, st);
    case 96: return launch<T, 96, NT>(p, B, st);
    case 128: return launch<T, 128, NT>(p, B, st);
    case 256: return launch<T, 256, NT>(p, B, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const DecodeParams& p, int B, int D, cudaStream_t st) {
  return p.G > kGTile ? dispatch_d<T, 2>(p, B, D, st)
                      : dispatch_d<T, 1>(p, B, D, st);
}

}  // namespace

// q: [B,H,D] through (batch, head) strides; k, v: [B,KVH,S,D] through
// (batch, head, row) strides, unit stride along D; valid: [B] int32;
// o: [B,H,D] contiguous, or, when out_acc is given (partials mode), null
// and out_acc [B,H,D] and out_ml [B,H,2] fp32, contiguous and 16-byte
// aligned, receive the unnormalised partials; part_acc [B,KVH,nsplit,G,D] and part_ml
// [B,KVH,nsplit,G,2] fp32 scratch, used when nsplit > 1; tickets: [B*KVH]
// int32, zero before the call and zero after it; split_len keys per split,
// a multiple of 64.  dtype 0 = float32, 1 = bfloat16.
extern "C" int repro_decode_attn_fwd(
    const void* q, const void* k, const void* v, const void* valid, void* o,
    void* out_acc, void* out_ml, void* part_acc, void* part_ml, void* tickets,
    int B, int H, int KVH,
    int S, int D, int nsplit, int split_len, long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH || H / KVH > kMaxG || S <= 0 ||
      nsplit <= 0 || nsplit > kMaxSplit || split_len <= 0 ||
      split_len % kSplitTile ||
      (long long)nsplit * split_len < S ||
      (nsplit > 1 && (part_acc == nullptr || part_ml == nullptr ||
                      tickets == nullptr)) ||
      (out_acc == nullptr ? o == nullptr : out_ml == nullptr))
    return (int)cudaErrorInvalidValue;
  DecodeParams p{q, k, v, static_cast<const int*>(valid), o,
                 static_cast<float*>(out_acc), static_cast<float*>(out_ml),
                 static_cast<float*>(part_acc), static_cast<float*>(part_ml),
                 static_cast<int*>(tickets),
                 H, KVH, S, H / KVH, nsplit, split_len,
                 q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                 (float)(1.0 / sqrt((double)D))};   // the reference's scale
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(p, B, D, st);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(p, B, D, st);
  return (int)cudaErrorInvalidValue;
}
