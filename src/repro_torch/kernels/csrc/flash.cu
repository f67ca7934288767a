// Flash attention for prefill: online softmax over KV tiles, GQA, causal
// and window masks, per-row query offsets (chunked prefill), and the ring
// layout of rolling sliding-window caches.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash/kernel.py:124, body _flash_kernel :44), in both
// of its modes.  The mode is chosen per launch: ring_len <= 0 is the plain
// layout (key slot j sits at position j); ring_len > 0 is the ring layout
// of kernel.py:69-106.
//
// Ring layout: the first ring_len key slots are a ring with modulus
// window and a per-row cursor kv_wrap[b] (tokens written before the
// chunk); slot j < ring_len holds position
// wrap - 1 - mod(wrap - 1 - j, window) with a non-negative mod (C's %
// keeps the sign of wrap - 1 - j, which is negative for every slot at or
// past the cursor), and a negative position marks a slot never written,
// which is masked.  Slots j >= ring_len are the in-flight chunk at
// positions wrap + (j - ring_len).  The causal and window masks apply to
// these positions, never to the slot index.  Tiles follow the skip rule of
// kernel.py:69-83: ring tiles run unless they lie wholly past an unwrapped
// cursor (slot order is not position order, so no other ring skip is
// sound); tail tiles keep the causal skip on their positions; a tile that
// straddles ring_len runs if either part is live.  ring_len need not be a
// multiple of the 64-key tile.
//
// Bound on the H100: at zamba2-2.7b's prefill chunk (B=4, H=KVH=32, d=80,
// 256 queries at offsets 0..1792 against a 2048-row bucket) the live KV
// prefix is about 45 MB and the unmasked products about 10 GFLOP, so the
// bytes bound it (~13 us at 3.35 TB/s) just ahead of the bf16 tensor cores
// (~10 us at 989 TFLOP/s).  At gemma3-1b's ring chunk (B=4, H=4, KVH=1,
// d=256, 512 ring slots + 256 chunk keys) it moves about 7 MB, ~2 us.
//
// Design: the TPU walks KV blocks along a sequential grid axis with
// (m, l, acc) in VMEM scratch.  Here one block owns one (batch row, head,
// tile of 64 query rows) and loops over 64-row KV tiles itself; (m, l, acc)
// stay in registers.  In the plain layout the loop starts at the first
// tile inside the window and stops after the last key the tile's last
// query may see, q_offset[b] + tile_end (the per-row causal skip of
// _flash_kernel :63-68), so a short-prefix row never reads a long row's
// KV; keys at or past Skv are masked.  In the ring layout the block walks
// the live ring tiles, then the live tail tiles (kv_tiles below).  q, k,
// v and o are read and written through strides, so the caller hands in a
// bucket view of a [B, S, KV, d] cache without a copy.
//
// bf16: four warps each own 16 query rows and run mma.sync m16n8k16 with
// fp32 accumulate for S = Q K^T and for O += P V.  K and V tiles are
// double-buffered in shared memory with cp.async; rows are padded by 16
// bytes so the fragment loads hit distinct banks.  P is rounded to bf16
// for the P.V product (the Pallas kernel keeps it in fp32); the row sums l
// are taken from the fp32 P.  The error this adds stays inside the bf16
// tolerance, 2e-2 of each query row's own max |o|.  Up to d=128 each warp
// keeps its Q fragments in registers; at d=256 the output accumulator
// alone takes 128 registers a thread, so the Q fragments are read from
// shared memory at every tile instead.
// fp32: CUDA cores.  Each warp owns 4 query rows; lane j scores key j of a
// 32-key tile, and each lane accumulates its own columns of the output.
// Its tiles live in static shared memory up to d=128 and in dynamic
// shared memory at d=256 (82 KB, past the 48 KB static limit).
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* qoff;   // [B] query offsets, or null for all zero
  const int* kv_wrap;   // [B] ring cursors (ring layout only)
  int H, KVH, Sq, Skv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal, window;   // window <= 0: none
  int ring_len;         // > 0: ring layout, <= 0: plain
  float scale;
};

// a mod m in [0, m)
__device__ __forceinline__ int pmod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// The layout is a template argument (kRing), chosen per launch from
// ring_len, so the plain instances compile to the code they had before
// the ring mode existed.

// absolute position of key slot `key` (negative: a ring slot never written)
template <bool kRing>
__device__ __forceinline__ int key_pos(const FlashParams& p, int wrap,
                                       int key) {
  if (!kRing) return key;
  if (key < p.ring_len) return wrap - 1 - pmod(wrap - 1 - key, p.window);
  return wrap + (key - p.ring_len);
}

template <bool kRing>
__device__ __forceinline__ bool key_ok(const FlashParams& p, int qpos,
                                       int key, int kpos) {
  bool ok = key < p.Skv;
  if (kRing) ok = ok && kpos >= 0;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && (qpos - kpos) < p.window;
  return ok;
}

// The KV tiles of `tile` keys that a block of queries at positions
// [qa, qb] visits, in order: tiles 0 .. n_head - 1, then t_tail,
// t_tail + 1, ... (n tiles in all; n_head is 0 in the plain layout).
struct Tiles {
  int n_head, t_tail, n;
};

template <bool kRing>
__device__ __forceinline__ int tile_at(const Tiles& t, int i) {
  if (!kRing) return t.t_tail + i;
  return i < t.n_head ? i : t.t_tail + (i - t.n_head);
}

template <bool kRing>
__device__ __forceinline__ Tiles kv_tiles(const FlashParams& p, int wrap,
                                          int qa, int qb, int tile) {
  Tiles t;
  if (!kRing) {
    // from the first key inside the window to the last the causal mask
    // lets the block's last query see
    int hi = p.Skv;
    if (p.causal) hi = min(hi, qb + 1);
    int lo = 0;
    if (p.window > 0) lo = max(0, qa - p.window + 1);
    const int end = hi > 0 ? (hi + tile - 1) / tile : 0;
    t.n_head = 0;
    t.t_tail = lo / tile;
    t.n = max(0, end - t.t_tail);
    return t;
  }
  // ring slots [0, ring_keys) were written; an unwrapped ring has written
  // exactly the slots below its cursor
  const int ring = min(p.ring_len, p.Skv);
  const int ring_keys = wrap >= p.window ? ring : max(0, min(ring, wrap));
  t.n_head = (ring_keys + tile - 1) / tile;
  // tail slot j is live for the block while wrap + (j - ring_len) <= qb
  const int tail_hi = min(p.Skv, ring + qb - wrap + 1);
  const int end = tail_hi > ring ? (tail_hi + tile - 1) / tile : 0;
  t.t_tail = max(ring / tile, t.n_head);
  t.n = t.n_head + max(0, end - t.t_tail);
  return t;
}

// ---------------------------------------------------------------- bf16, mma

constexpr int kBQ = 64;    // query rows per block (16 per warp)
constexpr int kBK = 64;    // keys per tile
constexpr int kWarps = 4;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of m16n8k16 for rows r, r + 8 and columns c, c + 8 of a
// padded row-major bf16 tile; `a` points at (r, c)
__device__ __forceinline__ void load_q_frag(uint32_t (&f)[4],
                                            const __nv_bfloat16* a, int dp) {
  f[0] = *reinterpret_cast<const uint32_t*>(a);
  f[1] = *reinterpret_cast<const uint32_t*>(a + 8 * dp);
  f[2] = *reinterpret_cast<const uint32_t*>(a + 8);
  f[3] = *reinterpret_cast<const uint32_t*>(a + 8 * dp + 8);
}

// rows [r0, r0 + kBK) of a [rows, D] strided matrix into a padded tile;
// rows at or past n_rows are zero
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                long long stride, int r0,
                                                int n_rows, int tid) {
  constexpr int DP = D + 8, V = D / 8;
  for (int e = tid; e < kBK * V; e += kWarps * 32) {
    const int r = e / V, c = e % V;
    const bool ok = r0 + r < n_rows;
    const __nv_bfloat16* g = ok ? src + (long long)(r0 + r) * stride + c * 8
                                : src;
    cp_async16(dst + r * DP + c * 8, g, ok ? 16 : 0);
  }
}

template <int D, bool kRing>
__global__ void __launch_bounds__(kWarps * 32)
flash_bf16_kernel(FlashParams p) {
  constexpr int DP = D + 8;          // padded row, in elements
  constexpr int KD = D / 16;         // k-steps of Q K^T
  constexpr int ND = D / 8;          // n-tiles of the output
  constexpr int NK = kBK / 8;        // n-tiles of S
  constexpr bool kQRegs = D <= 128;  // Q fragments held in registers
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBQ * DP;         // [2][kBK][DP]
  __nv_bfloat16* vs = ks + 2 * kBK * DP;     // [2][kBK][DP]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = qt * kBQ;
  const int qoff = p.qoff ? p.qoff[b] : 0;
  const int wrap = kRing ? p.kv_wrap[b] : 0;
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  const Tiles tl = kv_tiles<kRing>(p, wrap, qoff + q0, qoff + q_last, kBK);

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) +
                            b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) +
                            b * p.v_sb + kvh * p.v_sh;

  // Q tile, then the first K/V tile, in flight together
  for (int e = tid; e < kBQ * (D / 8); e += kWarps * 32) {
    const int r = e / (D / 8), c = e % (D / 8);
    const bool ok = q0 + r < p.Sq;
    cp_async16(qs + r * DP + c * 8,
               ok ? qg + (long long)(q0 + r) * p.q_ss + c * 8 : qg,
               ok ? 16 : 0);
  }
  if (tl.n > 0) {
    const int t0 = tile_at<kRing>(tl, 0);
    load_tile_async<D>(ks, kg, p.k_ss, t0 * kBK, p.Skv, tid);
    load_tile_async<D>(vs, vg, p.v_ss, t0 * kBK, p.Skv, tid);
  }
  cp_async_commit();

  const int gr = lane >> 2;          // fragment row within 8
  const int gc = (lane & 3) * 2;     // fragment column pair
  const int row0 = warp * 16 + gr;   // this thread's rows: row0, row0 + 8
  const int qpos0 = qoff + q0 + row0, qpos1 = qpos0 + 8;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  uint32_t qa[kQRegs ? KD : 1][4];

  for (int i = 0; i < tl.n; ++i) {
    const int t = tile_at<kRing>(tl, i);
    const int stage = i & 1;
    if (i + 1 < tl.n) {
      const int tn = tile_at<kRing>(tl, i + 1);
      load_tile_async<D>(ks + (stage ^ 1) * kBK * DP, kg, p.k_ss, tn * kBK,
                         p.Skv, tid);
      load_tile_async<D>(vs + (stage ^ 1) * kBK * DP, vg, p.v_ss, tn * kBK,
                         p.Skv, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (kQRegs && i == 0) {
#pragma unroll
      for (int kk = 0; kk < (kQRegs ? KD : 0); ++kk)
        load_q_frag(qa[kk], qs + row0 * DP + kk * 16 + gc, DP);
    }
    const __nv_bfloat16* kt = ks + stage * kBK * DP;
    const __nv_bfloat16* vt = vs + stage * kBK * DP;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qf[4];
      if (kQRegs) {
        qf[0] = qa[kQRegs ? kk : 0][0];
        qf[1] = qa[kQRegs ? kk : 0][1];
        qf[2] = qa[kQRegs ? kk : 0][2];
        qf[3] = qa[kQRegs ? kk : 0][3];
      } else {
        load_q_frag(qf, qs + row0 * DP + kk * 16 + gc, DP);
      }
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const __nv_bfloat16* bp = kt + (n * 8 + gr) * DP + kk * 16 + gc;
        mma_bf16(s[n], qf, *reinterpret_cast<const uint32_t*>(bp),
                 *reinterpret_cast<const uint32_t*>(bp + 8));
      }
    }

    // mask, scale, online softmax
    const int k0 = t * kBK;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + n * 8 + gc + j;
        const int kpos = key_pos<kRing>(p, wrap, key);
        s[n][j] = key_ok<kRing>(p, qpos0, key, kpos) ? s[n][j] * p.scale
                                                     : kNegInf;
        s[n][2 + j] = key_ok<kRing>(p, qpos1, key, kpos)
                          ? s[n][2 + j] * p.scale
                          : kNegInf;
        mx0 = fmaxf(mx0, s[n][j]);
        mx1 = fmaxf(mx1, s[n][2 + j]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[n][j] = expf(s[n][j] - mn0);
        s[n][2 + j] = expf(s[n][2 + j] - mn1);
        rs0 += s[n][j];
        rs1 += s[n][2 + j];
      }
    }
    l0 = l0 * c0 + rs0;   // this thread's columns; the quad sums at the end
    l1 = l1 * c1 + rs1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }

    // O += P V: P's accumulator layout is the A operand's layout
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + vrow * DP + n * 8 + (lane >> 4) * 8);
        mma_bf16(acc[n], pa, vb[0], vb[1]);
        mma_bf16(acc[n + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.0f / fmaxf(l0, 1e-37f), inv1 = 1.0f / fmaxf(l1, 1e-37f);
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                      h * p.o_sh;
  const int r0 = q0 + row0, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + gc;
    if (r0 < p.Sq)
      *reinterpret_cast<uint32_t*>(og + (long long)r0 * p.o_ss + col) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < p.Sq)
      *reinterpret_cast<uint32_t*>(og + (long long)r1 * p.o_ss + col) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// ------------------------------------------------------- fp32, CUDA cores

constexpr int kFQ = 16;            // query rows per block (4 per warp)
constexpr int kFK = 32;            // keys per tile (one per lane)
constexpr int kFRows = kFQ / kWarps;

// the fp32 kernel's tiles: Q [kFQ][D], K [kFK][D + 1] (padded key rows),
// V [kFK][D]; static shared memory up to 48 KB (d <= 128), dynamic past it
template <int D>
struct F32Tiles {
  float q[kFQ][D];
  float k[kFK][D + 1];
  float v[kFK][D];
};

template <int D>
struct F32Smem {
  static constexpr size_t kDynamicBytes =
      sizeof(F32Tiles<D>) <= 48 * 1024 ? 0 : sizeof(F32Tiles<D>);
};

template <int D, bool kRing>
__global__ void __launch_bounds__(kWarps * 32)
flash_f32_kernel(FlashParams p) {
  constexpr int NC = (D + 31) / 32;           // output columns per lane
  F32Tiles<D>* tiles;
  if constexpr (F32Smem<D>::kDynamicBytes == 0) {
    __shared__ F32Tiles<D> static_tiles;
    tiles = &static_tiles;
  } else {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    tiles = reinterpret_cast<F32Tiles<D>*>(smem_raw);
  }
  auto& qs = tiles->q;
  auto& ks = tiles->k;
  auto& vs = tiles->v;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int q0 = qt * kFQ;
  const int qoff = p.qoff ? p.qoff[b] : 0;
  const int wrap = kRing ? p.kv_wrap[b] : 0;
  const int q_last = min(q0 + kFQ, p.Sq) - 1;
  const Tiles tl = kv_tiles<kRing>(p, wrap, qoff + q0, qoff + q_last, kFK);

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb +
                    kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb +
                    kvh * p.v_sh;
  for (int e = tid; e < kFQ * D; e += kWarps * 32) {
    const int r = e / D, d = e % D;
    qs[r][d] = q0 + r < p.Sq ? qg[(long long)(q0 + r) * p.q_ss + d] : 0.0f;
  }

  float m[kFRows], l[kFRows], acc[kFRows][NC];
#pragma unroll
  for (int i = 0; i < kFRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }
  for (int it = 0; it < tl.n; ++it) {
    const int k0 = tile_at<kRing>(tl, it) * kFK;
    __syncthreads();   // previous tile consumed (and qs written)
    for (int e = tid; e < kFK * D; e += kWarps * 32) {
      const int r = e / D, d = e % D;
      const bool ok = k0 + r < p.Skv;
      ks[r][d] = ok ? kg[(long long)(k0 + r) * p.k_ss + d] : 0.0f;
      vs[r][d] = ok ? vg[(long long)(k0 + r) * p.v_ss + d] : 0.0f;
    }
    __syncthreads();
    float s[kFRows];
#pragma unroll
    for (int i = 0; i < kFRows; ++i) s[i] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float kv = ks[lane][d];
#pragma unroll
      for (int i = 0; i < kFRows; ++i)
        s[i] = fmaf(qs[warp * kFRows + i][d], kv, s[i]);
    }
    const int key = k0 + lane;
    const int kpos = key_pos<kRing>(p, wrap, key);
#pragma unroll
    for (int i = 0; i < kFRows; ++i) {
      const int qpos = qoff + q0 + warp * kFRows + i;
      float si = key_ok<kRing>(p, qpos, key, kpos) ? s[i] * p.scale : kNegInf;
      float mx = si;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float pr = expf(si - mn);
      const float corr = expf(m[i] - mn);
      float sum = pr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
      for (int j = 0; j < kFK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[i][c] = fmaf(pj, vs[j][d], acc[i][c]);
        }
      }
    }
  }
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < kFRows; ++i) {
    const int r = q0 + warp * kFRows + i;
    if (r >= p.Sq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) og[(long long)r * p.o_ss + d] = acc[i][c] * inv;
    }
  }
}

template <int D, bool kRing>
cudaError_t launch(const FlashParams& p, int B, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    constexpr size_t bytes = (size_t)(kBQ + 4 * kBK) * (D + 8) * 2;
    auto kern = flash_bf16_kernel<D, kRing>;
    // once per instantiation, so a launch inside CUDA-graph capture makes
    // no configuration call
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (attr != cudaSuccess) return attr;
    dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, B);
    kern<<<grid, kWarps * 32, bytes, st>>>(p);
  } else {
    constexpr size_t bytes = F32Smem<D>::kDynamicBytes;
    auto kern = flash_f32_kernel<D, kRing>;
    if constexpr (bytes > 0) {
      static const cudaError_t attr = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (attr != cudaSuccess) return attr;
    }
    dim3 grid((p.Sq + kFQ - 1) / kFQ, p.H, B);
    kern<<<grid, kWarps * 32, bytes, st>>>(p);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_layout(const FlashParams& p, int B, int dtype,
                          cudaStream_t st) {
  return p.ring_len > 0 ? launch<D, true>(p, B, dtype, st)
                        : launch<D, false>(p, B, dtype, st);
}

}  // namespace

// q: [B,H,Sq,D], k, v: [B,KVH,Skv,D], o: [B,H,Sq,D], each through its
// (batch, head, row) strides in elements with unit stride along D; qoff:
// [B] int32 or null; window <= 0 for none; ring_len > 0 selects the ring
// layout, which needs causal, a window and kv_wrap ([B] int32 cursors),
// with ring_len <= Skv; dtype 0 = float32, 1 = bfloat16 (shared by q, k,
// v and o).
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, const void* qoff,
                               const void* kv_wrap, int B, int H,
                               int KVH, int Sq, int Skv, int D,
                               long long q_sb, long long q_sh, long long q_ss,
                               long long k_sb, long long k_sh, long long k_ss,
                               long long v_sb, long long v_sh, long long v_ss,
                               long long o_sb, long long o_sh, long long o_ss,
                               int causal, int window, int ring_len,
                               int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH || Sq <= 0 || Skv <= 0 ||
      B > 65535 || H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (ring_len > 0 &&
      (!causal || window <= 0 || kv_wrap == nullptr || ring_len > Skv))
    return (int)cudaErrorInvalidValue;
  FlashParams p{q, k, v, o, static_cast<const int*>(qoff),
                ring_len > 0 ? static_cast<const int*>(kv_wrap) : nullptr,
                H, KVH, Sq, Skv,
                q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                o_sb, o_sh, o_ss, causal, window, ring_len,
                (float)(1.0 / sqrt((double)D))};   // the reference's scale
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch_layout<16>(p, B, dtype, st);
    case 32: return (int)launch_layout<32>(p, B, dtype, st);
    case 80: return (int)launch_layout<80>(p, B, dtype, st);
    case 128: return (int)launch_layout<128>(p, B, dtype, st);
    case 256: return (int)launch_layout<256>(p, B, dtype, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
