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
// cursor (slot order is not position order, so no skip inside the ring is
// sound); tail tiles keep the causal skip on their positions; a tile that
// straddles ring_len runs if either part is live.  Two more skips only drop
// tiles the masks would empty: the whole ring once the cursor is a window
// behind the block's first query (every ring slot is older than the
// cursor), and tail tiles wholly before that query's window (tail
// positions rise with the slot).  ring_len need not be a multiple of the
// 64-key tile.
//
// Bound on the H100: at llama3-8b's prefill chunk (B=4, H=32, KVH=8,
// d=128, 256 queries at offsets 0..1792 against a 2048-row bucket) the
// unmasked products are about 16 GFLOP, ~16 us at 989 TFLOP/s, ahead of
// the live KV prefix's bytes.  At zamba2-2.7b's (H=KVH=32, d=80) the
// bytes bound it (about 45 MB, ~13 us).  At gemma3-1b's ring chunk (B=4,
// H=4, KVH=1, d=256, 512 ring slots + 256 chunk keys) it moves about 7 MB,
// ~2 us.
//
// Design: the TPU walks KV blocks along a sequential grid axis with
// (m, l, acc) in VMEM scratch.  Here a block loops over 64-key KV tiles
// itself with (m, l, acc) in registers.  In the plain layout the loop
// starts at the first tile inside the window and stops after the last key
// the block's last query may see, q_offset[b] + its position (the per-row
// causal skip of _flash_kernel :63-68), so a short-prefix row never reads
// a long row's KV; keys at or past Skv are masked.  In the ring layout the
// block walks the live ring tiles, then the live tail tiles (kv_tiles
// below).  q, k, v and o are read and written through strides, so the
// caller hands in a bucket view of a [B, S, KV, d] cache without a copy.
// P is rounded to bf16 for the P.V product (the Pallas kernel keeps it in
// fp32); the row sums l are taken from the fp32 P.  The error this adds
// stays inside the bf16 tolerance, 2e-2 of each query row's own max |o|.
//
// bf16 at every head_dim (16 and 32 for the tests, 64 for qwen2.5-0.5b
// and llama3.2-1b, 80 zamba2-2.7b and hubert-xlarge, 96 phi-3-mini, 128
// llama3-8b, 256 gemma3-1b): wgmma and TMA.  Q and K run d padded to 64,
// 128 or 256 columns (TMA fills the columns past d with zeros), but
// S = Q K^T walks only the d / 16 k-steps that hold data (5 at d = 80, not
// 8).  At d = 80 and 96, V comes in 16-column panels with the 32-byte
// swizzle (wgmma's N-major operand then comes in 16-column atoms, where
// the 128-byte swizzle's are 64), so P V runs at N = d (m64n80k16,
// m64n96k16) and O holds d / 2 floats a thread; elsewhere P V runs at the
// padded width.  A block's query rows are the query heads of one KV head
// packed together (rows pos * G + g for a group of G = 1, 2, 4 or 8; one
// head otherwise), so each K/V tile is loaded once for the group.  One
// producer thread keeps TMA loads of K and V tiles in flight into a ring
// of 2 (d=256) or 4 (d <= 128) stages tracked by mbarriers, after Q, which
// TMA brings once.  Consumer warpgroups own 64 rows each: wgmma m64n64k16
// gives S = Q K^T from shared memory, the online softmax runs in registers
// (the scale folded into the exponent's FMA, ex2.approx), and wgmma adds
// P V with P from registers.  Each warpgroup issues tile j's S product
// together with tile j-1's P V and runs tile j's softmax while that P V is
// still on the tensor cores (FlashAttention-3's intra-warpgroup overlap;
// it holds two stages of the ring while the others fill, so d = 256, whose
// shared memory holds two, runs its tiles in turn), and the warpgroups
// take turns issuing their products (named barriers), so one's softmax
// meets another's tensor work.  A block has two consumer warpgroups (128
// rows) or, at d = 64 to 96 in the plain layout where the plan finds that
// no more padded, three (192 rows): every K/V tile, streamed from L2 once
// a query tile, then serves 1.5x the rows.  At hubert-xlarge's non-causal
// shape that stream bounds the kernel: with S, P V or the exponentials
// left out it runs only 3-14% faster on an H100 80GB HBM3 at 700 W
// (scripts/kernel_variants.py fwd_flash_d80, PERF.md).  setmaxnreg gives the consumers 232 registers
// and the producer warpgroup 40 (the d=256 accumulator alone is 128 a
// thread); with three consumers, 160 and 24.  When the query tiles are
// fewer than the 132 SMs (gemma3-1b's four heads and one KV head), each
// tile's keys are split across blocks as flash/ops.py plans: the tiles the
// masks leave a query tile go to as many of its splits as get two tiles
// each, and the rest return at once.  Each split writes its unnormalised
// (acc, m, l); the block that draws the last ticket of the tile merges
// them exactly, in split order whichever block that is, and resets the
// ticket.  Blocks start with the batch rows of the largest q_offset and
// the last query tiles, which see the most keys.
// fp32: CUDA cores.  Each warp owns 4 query rows; lane j scores key j of a
// 32-key tile, and each lane accumulates its own columns of the output.
// Its tiles live in static shared memory up to d=128 and in dynamic
// shared memory at d=256 (82 KB, past the 48 KB static limit).
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using repro::make_map;
using repro::pack_bf16;
using repro::tma_tile;

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
  float* lse;           // [B,H,Sq] natural log-sum-exp of each row, or null
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
  // every ring slot holds a position below the cursor, so none is inside
  // the window of the block's first query once wrap - 1 <= qa - window
  const int ring_live = wrap - 1 > qa - p.window ? ring_keys : 0;
  t.n_head = (ring_live + tile - 1) / tile;
  // tail slot j (position wrap + j - ring_len) is live for the block while
  // that position is at most qb and inside the window of qa
  const int tail_hi = min(p.Skv, ring + qb - wrap + 1);
  const int tail_lo = max(ring, ring + qa - p.window + 1 - wrap);
  const int end = tail_hi > ring ? (tail_hi + tile - 1) / tile : 0;
  t.t_tail = max(tail_lo / tile, t.n_head);
  t.n = t.n_head + max(0, end - t.t_tail);
  return t;
}

// whether every query at positions [qa, qb] sees every key slot of the
// tile [k0, k0 + tile): no mask is needed there.  Only tail tiles of the
// ring layout qualify (ring slots are not in position order).
template <bool kRing>
__device__ __forceinline__ bool tile_full(const FlashParams& p, int wrap,
                                          int k0, int tile, int qa, int qb) {
  const int k1 = k0 + tile - 1;
  if (k1 >= p.Skv || (kRing && k0 < p.ring_len)) return false;
  const int pos0 = kRing ? wrap + (k0 - p.ring_len) : k0;
  const int pos1 = pos0 + tile - 1;
  return (!p.causal || pos1 <= qa) && (p.window <= 0 || qb - pos0 < p.window);
}

constexpr int kWarps = 4;   // warps of an fp32 block

// ------------------------------------------------------ bf16: wgmma

// A block's consumer warpgroups own 64 query rows each: WG = 2 (128 rows)
// or 3 (192 rows, d = 64 to 96 in the plain layout, where the plan finds
// them no more padded: each K/V tile read from L2 then serves 1.5x the
// rows); one more warpgroup holds the producer.
constexpr int kWK = 64;          // keys a tile
constexpr int kPanel = 64;       // bf16 columns of one 128-byte swizzle panel
constexpr int kVPanel = 16;      // bf16 columns of one 32-byte swizzle panel
constexpr int kMaxFSplit = 8;    // key splits of a query tile
// the consumer warpgroups take turns issuing their products (named
// barriers 2, 3, ...), so one's softmax meets another's tensor work
constexpr bool kTurns = true;

// The launch plan (computed in Python from shapes, flash/ops.py) and the
// tensor maps' coordinate order: map dim i takes the logical coordinate
// (d, head, row, batch)[byte i of perm].
struct WgmmaPlan {
  int B, hp, npos, q_tiles, HG, nsplit;
  int rows_pos_major;   // Q rows: pos * hp + g (1) or g * npos + pos (0)
  int q_perm, k_perm, v_perm;   // byte i: the logical index of map dim i
  float* part_acc;      // [tiles][nsplit][rows][D] when nsplit > 1
  float* part_ml;       // [tiles][nsplit][rows][2]
  int* tickets;         // [tiles], zero between calls
};

// Q and K run d padded to the next multiple of the 64-column panel (16
// and 32 to 64, 80 and 96 to 128): TMA fills the columns past d with
// zeros, and Q K^T walks only the d / 16 k-steps that hold data.  P V runs
// at N = d where wgmma takes it from 16-column panels: at d = 80 and 96,
// V is staged in panels of 16 columns (32-byte swizzle) and O holds d / 2
// floats a thread; elsewhere V comes in 64-column panels and P V runs at
// the padded width.
template <int D, int WG>
struct WSmem {
  static constexpr int kDP = (D + kPanel - 1) / kPanel * kPanel;
  static constexpr int kPanels = kDP / kPanel;
  static constexpr bool kNarrowV = D > kPanel && D % kPanel != 0;
  static constexpr int kVN = kNarrowV ? D : kDP;   // columns of P V
  static constexpr int kStages = kDP > 128 ? 2 : 4;
  // tile j's S issued beside tile j-1's P V holds two stages while a
  // third fills: with two stages the tiles run one after the other
  static constexpr bool kOverlap = kStages > 2;
  static constexpr int kRows = 64 * WG;
  static constexpr int kThreads = 128 * (WG + 1);
  static constexpr int kQBytes = kRows * kDP * 2;
  static constexpr int kKBytes = kWK * kDP * 2;
  static constexpr int kVBytes = kWK * kVN * 2;
  static constexpr int kStageBytes = kKBytes + kVBytes;
  // 1024 bytes of slack to align the tiles for the swizzle
  static constexpr int kBytes = kQBytes + kStages * kStageBytes + 1024;
  static_assert(kStageBytes % 1024 == 0, "stages keep the 1024-byte "
                "alignment of the 128-byte swizzle");
};

// the key splits of ns that share a query tile's n KV tiles: at least
// kMinSplitTiles each, so a split's merge never costs more than its tiles
constexpr int kMinSplitTiles = 2;
__device__ __forceinline__ int active_splits(int n, int ns) {
  return max(1, min(ns, n / kMinSplitTiles));
}

// barrier 1 over the consumer warpgroups' `n` threads
__device__ __forceinline__ void consumer_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(n) : "memory");
}
// named barrier `id` over two consumer warpgroups: wait, or arrive only
__device__ __forceinline__ void turn_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void turn_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

template <int D, bool kRing, int WG>
__global__ void __launch_bounds__(128 * (WG + 1), 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, FlashParams p,
                   WgmmaPlan w) {
  using L = WSmem<D, WG>;
  constexpr int NP = L::kPanels, NS = L::kStages, DP = L::kDP, VN = L::kVN;
  constexpr int kWRows = L::kRows, kConsumers = 128 * WG;
  // the turns go round the warpgroups: WG w waits on barrier 2 + w and
  // passes to the next; the last starts the round
  constexpr bool kTurn = kTurns && L::kOverlap;
  static_assert(D % 16 == 0 && (DP == 64 || DP == 128 || DP == 256),
                "wgmma takes d padded to 64, 128 or 256 columns");
  __shared__ __align__(8) uint64_t full_bar[NS], empty_bar[NS], q_bar;
  __shared__ int s_last;
  extern __shared__ __align__(1024) unsigned char wgmma_smem[];
  unsigned char* base =
      wgmma_smem + ((1024 - (repro::smem_u32(wgmma_smem) & 1023)) & 1023);
  // Q [NP][rows][64], then stages of K [NP][kWK][64] and V ([NP][kWK][64],
  // or [D / 16][kWK][16] at d = 80 and 96)
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(base);
  unsigned char* kvs = base + L::kQBytes;

  // the block's (batch row, head group, query tile, key split): batch rows
  // by descending q_offset and query tiles from the last, so the rows with
  // the most keys start first
  int i = blockIdx.x;
  const int split = i % w.nsplit;
  i /= w.nsplit;
  const int hg = i % w.HG;
  i /= w.HG;
  const int brank = i % w.B;
  const int qt = w.q_tiles - 1 - i / w.B;
  int b = brank;
  if (p.qoff) {
    for (int c = 0; c < w.B; ++c) {
      const int oc = p.qoff[c];
      int rank = 0;
      for (int e = 0; e < w.B; ++e) {
        const int oe = p.qoff[e];
        rank += oe > oc || (oe == oc && e < c);
      }
      if (rank == brank) b = c;
    }
  }
  const int kvh = hg * w.hp / (p.H / p.KVH);
  const int q0 = qt * w.npos;
  const int qoff = p.qoff ? p.qoff[b] : 0;
  const int wrap = kRing ? p.kv_wrap[b] : 0;
  const int q_last = min(q0 + w.npos, p.Sq) - 1;
  const Tiles tl = kv_tiles<kRing>(p, wrap, qoff + q0, qoff + q_last, kWK);
  // the tiles the masks leave this query tile are cut among the first
  // n_active splits, at least two tiles each; the other splits return at
  // once, and with one active split the block writes its rows itself
  const int n_active = active_splits(tl.n, w.nsplit);
  if (split >= n_active) return;
  const int t_lo = (int)((long long)tl.n * split / n_active);
  const int n_mine = (int)((long long)tl.n * (split + 1) / n_active) - t_lo;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      repro::mbar_init(&full_bar[s], 1);
      repro::mbar_init(&empty_bar[s], 4 * WG);   // the consumers' warps
    }
    repro::mbar_init(&q_bar, 1);
    repro::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread keeps the TMA loads of the K/V ring in flight
    repro::setmaxnreg_dec<WG == 3 ? 24 : 40>();
    if (threadIdx.x == kConsumers && n_mine > 0) {
      repro::mbar_expect_tx(&q_bar, L::kQBytes);
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)
        tma_tile(qs + pn * kWRows * kPanel, &tq, &q_bar, w.q_perm,
                 pn * kPanel, hg * w.hp, q0, b);
      for (int j = 0; j < n_mine; ++j) {
        const int st = j % NS;
        repro::mbar_wait(&empty_bar[st], ((j / NS) & 1) ^ 1);
        repro::mbar_expect_tx(&full_bar[st], L::kStageBytes);
        const int key0 = tile_at<kRing>(tl, t_lo + j) * kWK;
        __nv_bfloat16* ks =
            reinterpret_cast<__nv_bfloat16*>(kvs + (size_t)st * L::kStageBytes);
        __nv_bfloat16* vs = ks + kWK * DP;
#pragma unroll
        for (int pn = 0; pn < NP; ++pn)
          tma_tile(ks + pn * kWK * kPanel, &tk, &full_bar[st], w.k_perm,
                   pn * kPanel, kvh, key0, b);
        if constexpr (L::kNarrowV) {
#pragma unroll
          for (int pn = 0; pn < D / kVPanel; ++pn)
            tma_tile(vs + pn * kWK * kVPanel, &tv, &full_bar[st], w.v_perm,
                     pn * kVPanel, kvh, key0, b);
        } else {
#pragma unroll
          for (int pn = 0; pn < NP; ++pn)
            tma_tile(vs + pn * kWK * kPanel, &tv, &full_bar[st], w.v_perm,
                     pn * kPanel, kvh, key0, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the block
    repro::setmaxnreg_inc<WG == 3 ? 160 : 232>();
    const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int r0 = wg * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
    const int pos0 = q0 + (w.rows_pos_major ? r0 / w.hp : r0 % w.npos);
    const int pos1 = q0 + (w.rows_pos_major ? r1 / w.hp : r1 % w.npos);
    const int qpos0 = qoff + pos0, qpos1 = qoff + pos1;
    const int gc = (lane & 3) * 2;

    float o[VN / 2];
#pragma unroll
    for (int k = 0; k < VN / 2; ++k) o[k] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
    const float scale2 = p.scale * 1.4426950408889634f;   // log2(e)
    const uint32_t q_addr = repro::smem_u32(qs) + wg * 64 * 128;
    if (n_mine > 0) repro::mbar_wait(&q_bar, 0);

    // S = Q K^T of tile j into s: 64 rows x kWK keys, Q and K K-major in
    // shared memory, over the d / 16 k-steps that hold data
    float s[kWK / 2];
    auto issue_s = [&](int j) {
      const uint32_t k_addr =
          repro::smem_u32(kvs + (size_t)(j % NS) * L::kStageBytes);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = repro::wgmma_desc(
            q_addr + (kk >> 2) * kWRows * 128 + (kk & 3) * 32, 16, 1024);
        const uint64_t db = repro::wgmma_desc(
            k_addr + (kk >> 2) * kWK * 128 + (kk & 3) * 32, 16, 1024);
        repro::wgmma_ss<kWK>(s, da, db, kk > 0);
      }
      repro::wgmma_commit();
    };
    // O += P V of tile j: P in bf16 from registers (the accumulator's
    // layout is the A operand's), V N-major in shared memory
    uint32_t pa[kWK / 16][4];
    auto issue_pv = [&](int j) {
      const uint32_t v_addr =
          repro::smem_u32(kvs + (size_t)(j % NS) * L::kStageBytes) +
          L::kKBytes;
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk) {
        if constexpr (L::kNarrowV)
          repro::wgmma_rs<VN>(o, pa[kk], repro::wgmma_desc(
              v_addr + kk * 16 * kVPanel * 2, kWK * kVPanel * 2,
              8 * kVPanel * 2, repro::kSwizzle32));
        else
          repro::wgmma_rs<VN>(o, pa[kk], repro::wgmma_desc(
              v_addr + kk * 2048, kWK * 128, 1024));
      }
      repro::wgmma_commit();
    };
    // mask tile j's scores, then the online softmax in base 2 on the
    // scores times scale * log2(e), the scale folded into the exponent's
    // FMA: s[4n + e] is (r0, key 8n + gc + e), s[4n + 2 + e] is (r1, the
    // same key).  A masked score is -inf, so its P is 0 whatever the row's
    // max (which starts finite, at kNegInf).  A tile every key of which
    // every query of the block sees skips the masks.  s ends as P in fp32;
    // c0, c1 rescale what O holds.
    float c0, c1;
    auto softmax = [&](int j) {
      const int k0 = tile_at<kRing>(tl, t_lo + j) * kWK;
      if (!tile_full<kRing>(p, wrap, k0, kWK, qoff + q0, qoff + q_last)) {
#pragma unroll
        for (int n = 0; n < kWK / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + n * 8 + gc + e;
            const int kpos = key_pos<kRing>(p, wrap, key);
            if (!key_ok<kRing>(p, qpos0, key, kpos))
              s[4 * n + e] = -INFINITY;
            if (!key_ok<kRing>(p, qpos1, key, kpos))
              s[4 * n + 2 + e] = -INFINITY;
          }
        }
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int n = 0; n < kWK / 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * scale2);
      const float mn1 = fmaxf(m1, mx1 * scale2);
      c0 = repro::exp2_approx(m0 - mn0);
      c1 = repro::exp2_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
      for (int n = 0; n < kWK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * n + e] = repro::exp2_approx(fmaf(s[4 * n + e], scale2, -mn0));
          s[4 * n + 2 + e] =
              repro::exp2_approx(fmaf(s[4 * n + 2 + e], scale2, -mn1));
          rs0 += s[4 * n + e];
          rs1 += s[4 * n + 2 + e];
        }
      }
      l0 = l0 * c0 + rs0;   // this thread's columns; the quad sums at the end
      l1 = l1 * c1 + rs1;
    };
    // O rescaled to the new max, and P packed for the next P V
    auto rescale_pack = [&]() {
#pragma unroll
      for (int k = 0; k < VN / 2; ++k) o[k] *= (k & 2) ? c1 : c0;
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    auto release = [&](int j) {   // tile j's K and V are read
      __syncwarp();
      if (lane == 0) repro::mbar_arrive(&empty_bar[j % NS]);
    };

    // Tile 0's S alone; then step j issues tile j's S and tile j-1's P V
    // together and runs tile j's softmax while that P V is still on the
    // tensor cores; then the last tile's P V alone.  With two stages (d =
    // 256) each tile runs S, softmax and P V in turn, in one loop.  Every
    // register fence comes before a step's first wgmma, so ptxas keeps
    // the products asynchronous.  Turns (kTurns) apply to the overlapped
    // order: each step's issue waits for the previous warpgroup's.
    if constexpr (!L::kOverlap) {
      for (int j = 0; j < n_mine; ++j) {
        repro::mbar_wait(&full_bar[j % NS], (j / NS) & 1);
        repro::reg_fence(s);
        repro::wgmma_fence();
        issue_s(j);
        repro::wgmma_wait0();
        repro::reg_fence(s);
        softmax(j);
        rescale_pack();
        repro::reg_fence(o);
        repro::wgmma_fence();
        issue_pv(j);
        repro::wgmma_wait0();
        repro::reg_fence(o);
        release(j);
      }
    } else if (n_mine > 0) {
      if (kTurn && wg == WG - 1) turn_arrive(2);
      repro::mbar_wait(&full_bar[0], 0);
      if (kTurn) turn_sync(2 + wg);
      repro::reg_fence(s);
      repro::wgmma_fence();
      issue_s(0);
      if (kTurn) turn_arrive(2 + (wg + 1) % WG);
      repro::wgmma_wait0();
      repro::reg_fence(s);
      softmax(0);
      rescale_pack();
      for (int j = 1; j < n_mine; ++j) {
        repro::mbar_wait(&full_bar[j % NS], (j / NS) & 1);
        if (kTurn) turn_sync(2 + wg);
        repro::reg_fence(s);
        repro::reg_fence(o);
        repro::wgmma_fence();
        issue_s(j);
        issue_pv(j - 1);
        if (kTurn) turn_arrive(2 + (wg + 1) % WG);
        repro::wgmma_wait<1>();
        repro::reg_fence(s);
        softmax(j);
        repro::wgmma_wait0();
        repro::reg_fence(o);
        release(j - 1);
        rescale_pack();
      }
      if (kTurn) turn_sync(2 + wg);
      repro::reg_fence(o);
      repro::wgmma_fence();
      issue_pv(n_mine - 1);
      if (kTurn && wg != WG - 1) turn_arrive(2 + (wg + 1) % WG);
      repro::wgmma_wait0();
      repro::reg_fence(o);
      release(n_mine - 1);
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    bool write = true;
    if (n_active > 1) {
      // key splits: write this split's unnormalised (o, m, l); the block
      // that draws the last ticket of the query tile merges them
      const int ti = (b * w.HG + hg) * w.q_tiles + qt;
      const long long tile0 = (long long)ti * w.nsplit;
      float* pacc = w.part_acc + (tile0 + split) * kWRows * D;
      float* pml = w.part_ml + (tile0 + split) * kWRows * 2;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<float2*>(pacc + r0 * D + n * 8 + gc) =
            make_float2(o[4 * n], o[4 * n + 1]);
        *reinterpret_cast<float2*>(pacc + r1 * D + n * 8 + gc) =
            make_float2(o[4 * n + 2], o[4 * n + 3]);
      }
      if ((lane & 3) == 0) {
        *reinterpret_cast<float2*>(pml + r0 * 2) = make_float2(m0, l0);
        *reinterpret_cast<float2*>(pml + r1 * 2) = make_float2(m1, l1);
      }
      __threadfence();
      consumer_sync(kConsumers);
      if (threadIdx.x == 0)
        s_last = atomicAdd(&w.tickets[ti], 1) == n_active - 1;
      consumer_sync(kConsumers);
      write = s_last;
      if (write) {
        // every split's partial from L2 in split order, whichever block
        // finishes last, so the sums run in one order on every call
        __threadfence();
        float ma0 = kNegInf, ma1 = kNegInf;
        for (int sp = 0; sp < n_active; ++sp) {
          const float* ml = w.part_ml + (tile0 + sp) * kWRows * 2;
          ma0 = fmaxf(ma0, __ldcg(ml + r0 * 2));
          ma1 = fmaxf(ma1, __ldcg(ml + r1 * 2));
        }
        l0 = l1 = 0.0f;
#pragma unroll
        for (int k = 0; k < VN / 2; ++k) o[k] = 0.0f;
        for (int sp = 0; sp < n_active; ++sp) {
          const float* ml = w.part_ml + (tile0 + sp) * kWRows * 2;
          const float* px = w.part_acc + (tile0 + sp) * kWRows * D;
          const float2 e0 = __ldcg(reinterpret_cast<const float2*>(
              ml + r0 * 2));
          const float2 e1 = __ldcg(reinterpret_cast<const float2*>(
              ml + r1 * 2));
          const float f0 = exp2f(e0.x - ma0), f1 = exp2f(e1.x - ma1);
          l0 += e0.y * f0;
          l1 += e1.y * f1;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            const float2 x0 = __ldcg(reinterpret_cast<const float2*>(
                px + r0 * D + n * 8 + gc));
            const float2 x1 = __ldcg(reinterpret_cast<const float2*>(
                px + r1 * D + n * 8 + gc));
            o[4 * n] = fmaf(x0.x, f0, o[4 * n]);
            o[4 * n + 1] = fmaf(x0.y, f0, o[4 * n + 1]);
            o[4 * n + 2] = fmaf(x1.x, f1, o[4 * n + 2]);
            o[4 * n + 3] = fmaf(x1.y, f1, o[4 * n + 3]);
          }
        }
        if (threadIdx.x == 0) w.tickets[ti] = 0;
        m0 = ma0;
        m1 = ma1;
      }
    }
    if (write) {
      const float inv0 = 1.0f / fmaxf(l0, 1e-37f);
      const float inv1 = 1.0f / fmaxf(l1, 1e-37f);
      const int h0 = hg * w.hp + (w.rows_pos_major ? r0 % w.hp : r0 / w.npos);
      const int h1 = hg * w.hp + (w.rows_pos_major ? r1 % w.hp : r1 / w.npos);
      __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb;
      if (p.lse != nullptr && (lane & 3) == 0) {
        // scores ran in base 2 times scale: ln(sum) = (m + log2 l) ln 2
        float* lb = p.lse + (size_t)b * p.H * p.Sq;
        if (pos0 < p.Sq)
          lb[(size_t)h0 * p.Sq + pos0] = (m0 + log2f(l0)) * 0.6931471805599453f;
        if (pos1 < p.Sq)
          lb[(size_t)h1 * p.Sq + pos1] = (m1 + log2f(l1)) * 0.6931471805599453f;
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = n * 8 + gc;
        if (pos0 < p.Sq)
          *reinterpret_cast<uint32_t*>(og + h0 * p.o_sh +
                                       (long long)pos0 * p.o_ss + col) =
              pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
        if (pos1 < p.Sq)
          *reinterpret_cast<uint32_t*>(og + h1 * p.o_sh +
                                       (long long)pos1 * p.o_ss + col) =
              pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
      }
    }
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
    if (p.lse != nullptr && lane == 0)
      p.lse[((size_t)b * p.H + h) * p.Sq + r] = m[i] + logf(l[i]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) og[(long long)r * p.o_ss + d] = acc[i][c] * inv;
    }
  }
}

template <int D, bool kRing, int WG>
cudaError_t launch_wgmma(const FlashParams& p, WgmmaPlan w,
                         cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  const int npos = w.npos;
  if (!make_map(&tq, p.q, D, p.H, p.q_sh, p.Sq, p.q_ss, w.B, p.q_sb, w.hp,
                npos, &w.q_perm) ||
      !make_map(&tk, p.k, D, p.KVH, p.k_sh, p.Skv, p.k_ss, w.B, p.k_sb, 1,
                kWK, &w.k_perm) ||
      !(WSmem<D, WG>::kNarrowV
            ? make_map(&tv, p.v, D, p.KVH, p.v_sh, p.Skv, p.v_ss, w.B, p.v_sb,
                       1, kWK, &w.v_perm, kVPanel, CU_TENSOR_MAP_SWIZZLE_32B)
            : make_map(&tv, p.v, D, p.KVH, p.v_sh, p.Skv, p.v_ss, w.B, p.v_sb,
                       1, kWK, &w.v_perm)))
    return cudaErrorInvalidValue;
  // Q rows land head-minor when the head dim precedes the row dim in the
  // map
  int head_at = 0, row_at = 0;
  for (int i = 0; i < 4; ++i) {
    if (((w.q_perm >> (8 * i)) & 255) == 1) head_at = i;
    if (((w.q_perm >> (8 * i)) & 255) == 2) row_at = i;
  }
  w.rows_pos_major = head_at < row_at;
  auto kern = flash_wgmma_kernel<D, kRing, WG>;
  constexpr int bytes = WSmem<D, WG>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const long long blocks =
      (long long)w.nsplit * w.HG * w.q_tiles * w.B;
  kern<<<(unsigned)blocks, WSmem<D, WG>::kThreads, bytes, st>>>(tq, tk, tv,
                                                                p, w);
  return cudaGetLastError();
}

// three consumer warpgroups: the plain layout at d = 64 to 96 (at d = 128
// their 160 registers a thread would spill)
template <int D, bool kRing>
constexpr bool kWide = !kRing && D >= 64 && D <= 96;

template <int D, bool kRing>
cudaError_t launch(const FlashParams& p, const WgmmaPlan& w, int dtype,
                   cudaStream_t st) {
  if (dtype == 1) {
    if (w.npos * w.hp == 128) return launch_wgmma<D, kRing, 2>(p, w, st);
    if constexpr (kWide<D, kRing>)
      return launch_wgmma<D, kRing, 3>(p, w, st);
    return cudaErrorInvalidValue;
  }
  constexpr size_t bytes = F32Smem<D>::kDynamicBytes;
  auto kern = flash_f32_kernel<D, kRing>;
  if constexpr (bytes > 0) {
    // once per instantiation, so a launch inside CUDA-graph capture makes
    // no configuration call
    static const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (attr != cudaSuccess) return attr;
  }
  dim3 grid((p.Sq + kFQ - 1) / kFQ, p.H, w.B);
  kern<<<grid, kWarps * 32, bytes, st>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_layout(const FlashParams& p, const WgmmaPlan& w,
                          int dtype, cudaStream_t st) {
  return p.ring_len > 0 ? launch<D, true>(p, w, dtype, st)
                        : launch<D, false>(p, w, dtype, st);
}

}  // namespace

// q: [B,H,Sq,D], k, v: [B,KVH,Skv,D], o: [B,H,Sq,D], each through its
// (batch, head, row) strides in elements with unit stride along D; qoff:
// [B] int32 or null; window <= 0 for none; ring_len > 0 selects the ring
// layout, which needs causal, a window and kv_wrap ([B] int32 cursors),
// with ring_len <= Skv; dtype 0 = float32, 1 = bfloat16 (shared by q, k,
// v and o).  bf16 runs the wgmma kernel with the plan (block_rows query
// rows a block: 128, or 192 in the plain layout at d = 64 to 96;
// heads_packed query heads of one KV head a block, nsplit key splits;
// part_acc [tiles, nsplit, block_rows, D] and part_ml [tiles, nsplit,
// block_rows, 2] fp32 scratch and tickets [tiles] int32, zero before and
// after, when nsplit > 1, tiles = B * H / heads_packed * ceil(Sq *
// heads_packed / block_rows)); fp32 takes heads_packed = nsplit = 1 and
// block_rows = 128.  lse: null, or [B,H,Sq]
// fp32, which receives each query row's log-sum-exp of its scaled scores
// (natural log; the backward's input, when training).
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, const void* qoff,
                               const void* kv_wrap, int B, int H,
                               int KVH, int Sq, int Skv, int D,
                               long long q_sb, long long q_sh, long long q_ss,
                               long long k_sb, long long k_sh, long long k_ss,
                               long long v_sb, long long v_sh, long long v_ss,
                               long long o_sb, long long o_sh, long long o_ss,
                               int causal, int window, int ring_len,
                               int heads_packed, int nsplit, int block_rows,
                               void* part_acc, void* part_ml, void* tickets,
                               void* lse, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH || Sq <= 0 || Skv <= 0 ||
      B > 65535 || H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (ring_len > 0 &&
      (!causal || window <= 0 || kv_wrap == nullptr || ring_len > Skv))
    return (int)cudaErrorInvalidValue;
  const bool wgmma = dtype == 1;
  const int hp = heads_packed;
  if (wgmma ? (hp < 1 || (H / KVH) % hp ||
               (block_rows != 128 && block_rows != 192) || block_rows % hp ||
               nsplit < 1 ||
               nsplit > kMaxFSplit ||
               (nsplit > 1 && (part_acc == nullptr || part_ml == nullptr ||
                               tickets == nullptr)))
            : (hp != 1 || nsplit != 1 || block_rows != 128))
    return (int)cudaErrorInvalidValue;
  FlashParams p{q, k, v, o, static_cast<const int*>(qoff),
                ring_len > 0 ? static_cast<const int*>(kv_wrap) : nullptr,
                H, KVH, Sq, Skv,
                q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                o_sb, o_sh, o_ss, causal, window, ring_len,
                (float)(1.0 / sqrt((double)D)),    // the reference's scale
                static_cast<float*>(lse)};
  const int npos = block_rows / hp;
  WgmmaPlan w{B, hp, npos, (Sq + npos - 1) / npos, H / hp, nsplit, 1,
              0, 0, 0, static_cast<float*>(part_acc),
              static_cast<float*>(part_ml), static_cast<int*>(tickets)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch_layout<16>(p, w, dtype, st);
    case 32: return (int)launch_layout<32>(p, w, dtype, st);
    case 64: return (int)launch_layout<64>(p, w, dtype, st);
    case 80: return (int)launch_layout<80>(p, w, dtype, st);
    case 96: return (int)launch_layout<96>(p, w, dtype, st);
    case 128: return (int)launch_layout<128>(p, w, dtype, st);
    case 256: return (int)launch_layout<256>(p, w, dtype, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
