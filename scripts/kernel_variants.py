"""Time variants of the flash kernel's, the SSD scan's, the Mamba-2 or
Mamba-1 decode step's, the selective scan's or causal conv1d's source
against each other on one card.

    python3 scripts/kernel_variants.py SET [--micro] [--tree TREE]

SET names a set in ``SETS`` below, or a JSON file of the same form:
``{"variant": [["file in csrc/", "text", "replacement"], ...], ...}`` (a
path such as ``../ssd/ops.py`` reaches a wrapper beside ``csrc/``); a
variant with no edits is the source as it stands. Needs an NVIDIA card
and ``nvcc``. Each variant is a copy of ``src/repro_torch`` (of TREE, the
root of another checkout, where ``--tree`` names one: a set whose edits
are to an earlier source) under ``build/variants/<name>/`` (listed in
.gitignore) with its edits applied, so the repository's sources are
never edited; the second pass reuses the first's copies and builds; a
child process
builds it and times the flash kernel (``chip_smoke.device_ms``) at the
bf16 shapes of ``chip_smoke.attention_cases`` and
``chip_smoke.ring_cases``, or with ``--micro`` at one compute-bound
shape (4224 queries of 4 heads over one KV head, no mask, 132 blocks
sharing K/V through L2, d=128 and 256, 1024 and 4096 keys); a set whose
name starts with ``ssd`` times and checks the SSD scan in bf16 at
mamba2-2.7b's and zamba2-2.7b's shapes (B=4) on 2 chunks of phase 3's
draws and on 16 chunks at the model's scales (``chip_smoke.check_ssd``'s
limits); one whose name starts with ``mamba2_decode`` the Mamba-2 decode
step at both models' shapes, bf16 and fp32, on
``chip_smoke.mamba2_decode_inputs``; one that starts with
``mamba1_decode`` the Mamba-1 decode step at mamba-130m's shape, bf16,
B=4, B=1 and B=16, on ``chip_smoke.mamba1_decode_inputs``; one that starts
with ``conv1d`` causal conv1d in bf16 at B=4, S=256 and the channel
counts of ``chip_smoke.conv_shapes``, without and (where the wrapper
takes them) with ragged lengths; one that starts with ``scan1`` the
selective scan in bf16 at mamba-130m's width, B=4, S=256 and B=1, S=2048
and 16384, on ``scan1.ref.model_scale_inputs`` (``chip_smoke.scan_ratio``'s
limits); one that starts with ``bwd_flash``, ``bwd_ssd`` or
``bwd_scan1`` that backward kernel in bf16 at ``chip_smoke.bwd_cases``
(checked at B=4, S=512 and the training shapes, timed at the training
shapes; ``BWD_TOL``'s limits, a second call bit for bit). Each variant's kernels that ptxas
reports spilling are printed. The variants run in turn, then again in
reverse order; each case prints every variant's two times and its worst
ratio to the check's limit (1 is the limit). An output past the limit
also prints WRONG (a variant that drops a product is wrong on purpose).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("repro_torch", "kernels", "csrc")

# conv1d's launch rule, which the conv1d_design variants replace
_RULE = ("  const int rows = threads(v, 16) >= kFill ? 16 : 8;\n"
         "  while (v > 1 && threads(v, rows) < kFill) v /= 2;\n")

# the Mamba-1 step with one cluster per batch row, each block updating
# its whole tile's state (the shared-memory bound is then the widest
# tile's in bf16 only)
_M1_ONE_CLUSTER = [
    ["mamba1_decode.cu", "constexpr int kHalves = 2;",
     "constexpr int kHalves = 1;"],
    ["mamba1_decode.cu", "static_assert(Layout(",
     "static_assert(kHalves == 1 || Layout("]]

# text of csrc/scan1.cu that the scan1 variants cut
_SCAN1_NO_STATES = ["scan1.cu", "    for (int g0 = 0; g0 < N; g0 += G) {",
                    "    for (int g0 = 0; g0 < 0; g0 += G) {"]
_SCAN1_NO_EX2 = ["scan1.cu",
                 "for (int i = 0; i < K; ++i) a[g][i] = ex2(dtv[i] * a2);",
                 "for (int i = 0; i < K; ++i) a[g][i] = dtv[i] * a2;"]
_SCAN1_NO_SCAN = ["scan1.cu", "for (int off = 1; off < 32; off *= 2) {",
                  "for (int off = 32; off < 32; off *= 2) {"]
_SCAN1_NO_B = ["scan1.cu",
               "load_g<T, G>(brow + i * kRowW + g0 * L::kEsz / 4, bv);",
               "for (int g = 0; g < G; ++g) bv[g] = 1.0f;"]
_SCAN1_NO_WALK = ["scan1.cu",
                  "        load_g<T, G>(crow + i * kRowW + g0 * L::kEsz / 4, cv);\n"
                  "#pragma unroll\n"
                  "        for (int g = 0; g < G; ++g) {\n"
                  "          h[g] = fmaf(a[g][i], h[g], u[g][i]);\n"
                  "          acc[i] = fmaf(cv[g], h[g], acc[i]);\n"
                  "        }\n",
                  "        for (int g = 0; g < G; ++g) acc[i] += h[g];\n"]
_SCAN1_NO_LOADS = ["scan1.cu",
                   "  auto stage = [&](int s, int t0) {\n",
                   "  auto stage = [&](int s, int t0) {\n"
                   "    if (t0 >= 0) return repro::cp_async_commit();\n"]
_SCAN1_NO_COOK = ["scan1.cu", "      ob[o] = rb[q];\n      oc[o] = rc[q];\n",
                  "      (void)o;\n"]
_SCAN1_NO_OUTPUT = ["scan1.cu",
                    "    for (int t = tid; t < rows; t += kN) {",
                    "    for (int t = tid; t < 0; t += kN) {"]
_SCAN1_RULE = ["../scan1/ops.py", "index = 1 if b * ldc >= 3 * sms * 8 else 0"]

# the tensor-core SSD backward's fp32 operands split back into hi + lo
# bf16 terms (the source rounds each to one term): e^cum dy in the local
# pass, the states h_c and dh'_c, the masked and decayed score blocks
_SSD_BWD_SPLIT_EDY = [
    ["ssd_bwd.cu", "      uint32_t yr[4], a[4];",
     "      uint32_t yr[4], a[4], alo[4];"],
    ["ssd_bwd.cu",
     "        a[q] = repro::pack_bf16(yv.x * ecum[j], yv.y * ecum[j + 1]);",
     "        repro::split_bf16(yv.x * ecum[j], yv.y * ecum[j + 1], a[q], "
     "alo[q]);"],
    ["ssd_bwd.cu",
     "        mma_bf16(acc[t], a, r[0], r[1]);\n"
     "        mma_bf16(acc[t + 1], a, r[2], r[3]);\n",
     "        mma_bf16(acc[t], a, r[0], r[1]);\n"
     "        mma_bf16(acc[t], alo, r[0], r[1]);\n"
     "        mma_bf16(acc[t + 1], a, r[2], r[3]);\n"
     "        mma_bf16(acc[t + 1], alo, r[2], r[3]);\n"]]
_SSD_BWD_SPLIT_STATES = [
    ["ssd_bwd.cu", "2 * (size_t)P * BS) *", "4 * (size_t)P * BS) *"],
    ["ssd_bwd.cu",
     "  bf16* hb = dhb + P * BS;                        // [P][BS] h_c\n"
     "  float* dts = reinterpret_cast<float*>(hb + P * BS);",
     "  bf16* dhl = dhb + P * BS;\n  bf16* hb = dhl + P * BS;\n"
     "  bf16* hl = hb + P * BS;\n"
     "  float* dts = reinterpret_cast<float*>(hl + P * BS);"],
    ["ssd_bwd.cu",
     "        *reinterpret_cast<uint2*>(hb + off) = make_uint2(\n"
     "            repro::pack_bf16(hv.x, hv.y), repro::pack_bf16(hv.z, hv.w));"
     "\n        *reinterpret_cast<uint2*>(dhb + off) = make_uint2(\n"
     "            repro::pack_bf16(dv.x, dv.y), repro::pack_bf16(dv.z, dv.w));",
     "        uint32_t h0_, l0_, h1_, l1_;\n"
     "        repro::split_bf16(hv.x, hv.y, h0_, l0_);\n"
     "        repro::split_bf16(hv.z, hv.w, h1_, l1_);\n"
     "        *reinterpret_cast<uint2*>(hb + off) = make_uint2(h0_, h1_);\n"
     "        *reinterpret_cast<uint2*>(hl + off) = make_uint2(l0_, l1_);\n"
     "        repro::split_bf16(dv.x, dv.y, h0_, l0_);\n"
     "        repro::split_bf16(dv.z, dv.w, h1_, l1_);\n"
     "        *reinterpret_cast<uint2*>(dhb + off) = make_uint2(h0_, h1_);\n"
     "        *reinterpret_cast<uint2*>(dhl + off) = make_uint2(l0_, l1_);"],
    ["ssd_bwd.cu", "                                             const bf16* st,"
     " int n0,",
     "                                             const bf16* st, "
     "const bf16* slo, int n0,"],
    ["ssd_bwd.cu",
     "      repro::ldmatrix_x4_trans(r, st + off + t * 8);\n"
     "      repro::mma_bf16(acc[t], af, r[0], r[1]);\n"
     "      repro::mma_bf16(acc[t + 1], af, r[2], r[3]);\n",
     "      repro::ldmatrix_x4_trans(r, st + off + t * 8);\n"
     "      repro::mma_bf16(acc[t], af, r[0], r[1]);\n"
     "      repro::mma_bf16(acc[t + 1], af, r[2], r[3]);\n"
     "      repro::ldmatrix_x4_trans(r, slo + off + t * 8);\n"
     "      repro::mma_bf16(acc[t], af, r[0], r[1]);\n"
     "      repro::mma_bf16(acc[t + 1], af, r[2], r[3]);\n"],
    ["ssd_bwd.cu", "(t2, xs, r0, dhb, nh * 64, lane)",
     "(t2, xs, r0, dhb, dhl, nh * 64, lane)"],
    ["ssd_bwd.cu", "(t2, dys, r0, hb, nh * 64, lane)",
     "(t2, dys, r0, hb, hl, nh * 64, lane)"],
    ["ssd_bwd.cu",
     "        repro::ldmatrix_x4(r, dhb + off);\n"
     "        repro::mma_bf16(dxa[2 * pp], af, r[0], r[1]);\n"
     "        repro::mma_bf16(dxa[2 * pp + 1], af, r[2], r[3]);\n",
     "        repro::ldmatrix_x4(r, dhb + off);\n"
     "        repro::mma_bf16(dxa[2 * pp], af, r[0], r[1]);\n"
     "        repro::mma_bf16(dxa[2 * pp + 1], af, r[2], r[3]);\n"
     "        repro::ldmatrix_x4(r, dhl + off);\n"
     "        repro::mma_bf16(dxa[2 * pp], af, r[0], r[1]);\n"
     "        repro::mma_bf16(dxa[2 * pp + 1], af, r[2], r[3]);\n"]]
_SSD_BWD_SPLIT_SCORES = [
    ["ssd_bwd.cu",
     "                                       uint32_t (&a)[4]) {\n"
     "  a[0] = repro::pack_bf16(x[0][0], x[0][1]);\n"
     "  a[1] = repro::pack_bf16(x[0][2], x[0][3]);\n"
     "  a[2] = repro::pack_bf16(x[1][0], x[1][1]);\n"
     "  a[3] = repro::pack_bf16(x[1][2], x[1][3]);\n",
     "                                       uint32_t (&a)[4], "
     "uint32_t (&lo)[4]) {\n"
     "  repro::split_bf16(x[0][0], x[0][1], a[0], lo[0]);\n"
     "  repro::split_bf16(x[0][2], x[0][3], a[1], lo[1]);\n"
     "  repro::split_bf16(x[1][0], x[1][1], a[2], lo[2]);\n"
     "  repro::split_bf16(x[1][2], x[1][3], a[3], lo[3]);\n"],
    ["ssd_bwd.cu",
     "                                         const uint32_t (&a)[4],\n",
     "                                         const uint32_t (&a)[4],\n"
     "                                         const uint32_t (&lo)[4],\n"],
    ["ssd_bwd.cu",
     "    repro::mma_bf16(acc[t], a, r[0], r[1]);\n"
     "    repro::mma_bf16(acc[t + 1], a, r[2], r[3]);\n",
     "    repro::mma_bf16(acc[t], a, r[0], r[1]);\n"
     "    repro::mma_bf16(acc[t], lo, r[0], r[1]);\n"
     "    repro::mma_bf16(acc[t + 1], a, r[2], r[3]);\n"
     "    repro::mma_bf16(acc[t + 1], lo, r[2], r[3]);\n"],
    ["ssd_bwd.cu",
     "      uint32_t ga[4];\n      pack_a(gs, ga);\n"
     "      a_x_rows<NT, BS>(dCa, ga, bs, cb * 16, lane);",
     "      uint32_t ga[4], gl[4];\n      pack_a(gs, ga, gl);\n"
     "      a_x_rows<NT, BS>(dCa, ga, gl, bs, cb * 16, lane);"],
    ["ssd_bwd.cu",
     "      uint32_t ma[4], ga[4];\n      pack_a(gt, ma);\n"
     "      pack_a(dmt, ga);\n"
     "      a_x_rows<PT, XS>(dxa, ma, dys, ib_ * 16, lane);\n"
     "      a_x_rows<NT, BS>(dBa, ga, cs, ib_ * 16, lane);",
     "      uint32_t ma[4], ml[4], ga[4], gl[4];\n"
     "      pack_a(gt, ma, ml);\n      pack_a(dmt, ga, gl);\n"
     "      a_x_rows<PT, XS>(dxa, ma, ml, dys, ib_ * 16, lane);\n"
     "      a_x_rows<NT, BS>(dBa, ga, gl, cs, ib_ * 16, lane);"]]
_FLASH_BWD_SCORES = [
    ["flash_bwd.cu", "scores64<D / 16>(" + call, "scores64<DP / 16>(" + call]
    for call in ("s, k_addr, kWKeys, q_addr);",
                 "dp, v_addr, kWKeys, do_addr);",
                 "s, q_addr, kWQRows, k_addr);",
                 "dp, do_addr, kWQRows, v_addr);")]

# flash.cu's forward: its ring at three stages; Q K^T over the padded
# d's k-steps; no turns between the consumer warpgroups; 128-key tiles
# (three stages, and the plan's split rule on 128-key tiles)
_FLASH_3_STAGES = ["flash.cu",
                   "static constexpr int kStages = kDP > 128 ? 2 : 4;",
                   "static constexpr int kStages = kDP > 128 ? 2 : 3;"]
_FLASH_PADDED_KSTEPS = ["flash.cu",
                        "      for (int kk = 0; kk < D / 16; ++kk) {\n"
                        "        const uint64_t da = repro::wgmma_desc(\n"
                        "            q_addr",
                        "      for (int kk = 0; kk < DP / 16; ++kk) {\n"
                        "        const uint64_t da = repro::wgmma_desc(\n"
                        "            q_addr"]
_FLASH_NO_TURNS = ["flash.cu", "constexpr bool kTurns = true;",
                   "constexpr bool kTurns = false;"]
_FLASH_128_KEYS = [["flash.cu", "constexpr int kWK = 64;          // keys a "
                    "tile", "constexpr int kWK = 128;         // keys a tile"],
                   _FLASH_3_STAGES,
                   ["../flash/ops.py", "KEY_TILE = 64 ", "KEY_TILE = 128 "]]
# flash.cu's forward with a part of each tile left out (wrong on purpose)
_FLASH_NO_S = ["flash.cu", "        repro::wgmma_ss<kWK>(s, da, db, kk > 0);",
               "        (void)da; (void)db;"]
_FLASH_NO_PV = ["flash.cu",
                "      for (int kk = 0; kk < kWK / 16; ++kk) {\n"
                "        if constexpr (L::kNarrowV)",
                "      for (int kk = 0; kk < 0; ++kk) {\n"
                "        if constexpr (L::kNarrowV)"]
_FLASH_NO_EXP = [["flash.cu",
                  "          s[4 * n + e] = repro::exp2_approx(fmaf(s[4 * n "
                  "+ e], scale2, -mn0));",
                  "          s[4 * n + e] = fmaf(s[4 * n + e], scale2, "
                  "-mn0);"],
                 ["flash.cu",
                  "              repro::exp2_approx(fmaf(s[4 * n + 2 + e], "
                  "scale2, -mn1));",
                  "              fmaf(s[4 * n + 2 + e], scale2, -mn1);"]]
# the conv1d backward plan's vector bytes (ops.py)
_CONV_BWD_VEC = ["../conv1d/ops.py", "BWD_VEC_BYTES = 8"]

# the selective-scan backward's launches, each cut
_SCAN1_BWD_NO_A = ["scan1_bwd.cu", "  states<<<", "  if (0) states<<<"]
_SCAN1_BWD_NO_B = ["scan1_bwd.cu", "  bwd<<<", "  if (0) bwd<<<"]
_SCAN1_BWD_NO_FINISH = ["scan1_bwd.cu", "  scan1_bwd_finish<T, N><<<",
                        "  if (0) scan1_bwd_finish<T, N><<<"]
_SCAN1_BWD_NO_SUMS = [
    ["scan1_bwd.cu",
     "          rw[(0 * G + g) * L::kRedRow + i] = dtx[i] * gv;   // dB\n"
     "          rw[(1 * G + g) * L::kRedRow + i] = h[g] * dyv[i];  // dC\n",
     ""],
    ["scan1_bwd.cu", "          for (int i = 0; i < kH; i += 4)\n",
     "          for (int i = 0; i < 0; i += 4)\n"],
    ["scan1_bwd.cu", "          for (int i = 0; i < kH; ++i)\n"
     "            if (t0 + stp + i < S) dst[i] = sum[i];",
     "          for (int i = 0; i < 0; ++i)\n"
     "            if (t0 + stp + i < S) dst[i] = sum[i];"]]

SETS = {
    # the tensor-core SSD backward's fp32 operands split back into hi + lo
    # bf16 terms, one kind at a time and all at once: what each split buys
    # in error and costs in time
    "bwd_ssd_operands": {
        "one term (as is)": [],
        "split e^cum dy": _SSD_BWD_SPLIT_EDY,
        "split states": _SSD_BWD_SPLIT_STATES,
        "split scores": _SSD_BWD_SPLIT_SCORES,
        "split everywhere": (_SSD_BWD_SPLIT_EDY + _SSD_BWD_SPLIT_STATES
                             + _SSD_BWD_SPLIT_SCORES),
    },
    # each launch of the tensor-core SSD backward left out (wrong on
    # purpose): what each pass costs
    "bwd_ssd_breakdown": {
        "as is": [],
        "no local": [["ssd_bwd.cu", "  ssd_bwd_local<P, N><<<",
                      "  if (0) ssd_bwd_local<P, N><<<"]],
        "no state": [["ssd_bwd.cu", "  ssd_bwd_state<<<",
                      "  if (0) ssd_bwd_state<<<"]],
        "no chunk": [["ssd_bwd.cu", "  ssd_bwd_chunk<P, N><<<",
                      "  if (0) ssd_bwd_chunk<P, N><<<"]],
        "no finish": [["ssd_bwd.cu", "  ssd_bwd_finish_tc<<<",
                       "  if (0) ssd_bwd_finish_tc<<<"]],
    },
    # each launch of the wgmma flash backward left out (wrong on purpose):
    # what each costs, and so what folding dQ into the dK/dV kernel (FA3's
    # deterministic form) could save at most
    "bwd_flash_breakdown": {
        "as is": [],
        "no stats": [["flash_bwd.cu", "  flash_bwd_stats<<<",
                      "  if (0) flash_bwd_stats<<<"]],
        "no dK/dV": [["flash_bwd.cu", "  flash_bwd_dkdv_wgmma<D>\n",
                      "  if (0) flash_bwd_dkdv_wgmma<D>\n"]],
        "no dQ": [["flash_bwd.cu", "  flash_bwd_dq_wgmma<D>\n",
                   "  if (0) flash_bwd_dq_wgmma<D>\n"]],
    },
    # each launch of the selective-scan backward alone (wrong on
    # purpose): the forward's carries (pass 1), the backward scan (pass
    # 2), the partials' sums (pass 3); and pass 2 without its dB / dC sums
    # (no contributions to shared memory, no block or cluster sums)
    "bwd_scan1_breakdown": {
        "as is": [],
        "states pass alone": [_SCAN1_BWD_NO_B, _SCAN1_BWD_NO_FINISH],
        "backward pass alone": [_SCAN1_BWD_NO_A, _SCAN1_BWD_NO_FINISH],
        "finish alone": [_SCAN1_BWD_NO_A, _SCAN1_BWD_NO_B],
        "no dB / dC sums": _SCAN1_BWD_NO_SUMS,
    },
    # where the selective-scan backward pass's time goes (wrong on
    # purpose): its dB / dC sums cut (no contributions to shared memory,
    # no partials written), its lane scan cut; and 8 channels a block in
    # bf16, two blocks an SM (right; twice the partials)
    "bwd_scan1_cuts": {
        "as is": [],
        "8 channels a block, two an SM": [
            ["scan1_bwd.cu", "constexpr int kCT = sizeof(T) == 2 ? 16 : 8;",
             "constexpr int kCT = 8;"],
            ["scan1_bwd.cu", "  auto bwd = scan1_bwd_kernel<T, N, kK, CT, kG, 1>;",
             "  auto bwd = scan1_bwd_kernel<T, N, kK, CT, kG, "
             "sizeof(T) == 2 ? 2 : 1>;"],
            ["../scan1/ops.py", "BWD_CHANNELS = {2: 16, 4: 8}",
             "BWD_CHANNELS = {2: 8, 4: 8}"]],
        "no dB / dC sums": _SCAN1_BWD_NO_SUMS,
        "no lane scan": [
            ["scan1_bwd.cu",
             "      for (int off = 1; off < 32; off *= 2) {\n#pragma unroll\n"
             "        for (int g = 0; g < G; ++g) {\n"
             "          const float qp",
             "      for (int off = 32; off < 32; off *= 2) {\n#pragma unroll\n"
             "        for (int g = 0; g < G; ++g) {\n"
             "          const float qp"]],
    },
    # the flash backward's score products over the padded d (d = 80: 8
    # k-steps instead of 5), and the depth of its ring
    "bwd_flash": {
        "as is": [],
        "padded k-steps": _FLASH_BWD_SCORES,
        "2 stages": [["flash_bwd.cu", "constexpr int kWStages = 4;",
                      "constexpr int kWStages = 2;"]],
        "3 stages": [["flash_bwd.cu", "constexpr int kWStages = 4;",
                      "constexpr int kWStages = 3;"]],
    },
    # K/V pipeline depth of the d <= 128 instances
    "stages": {
        "4 stages": [],
        "3 stages": [_FLASH_3_STAGES],
    },
    # each step of the forward's route at d = 80 and 96: Q K^T over the
    # padded d's k-steps, P V at the padded N (V in 64-column panels), no
    # overlap of a tile's softmax with the last tile's P V, no turns
    # between the consumer warpgroups, 128-row blocks (two consumer
    # warpgroups) where the plan takes 192, 128-key tiles (three stages
    # then fit), three stages; and what each part costs (a product or the
    # exponentials left out: wrong on purpose)
    "fwd_flash_d80": {
        "as is": [],
        "k-steps over the padded d": [_FLASH_PADDED_KSTEPS],
        "P V at the padded N": [["flash.cu",
                                 "  static constexpr bool kNarrowV = D > "
                                 "kPanel && D % kPanel != 0;",
                                 "  static constexpr bool kNarrowV = false;"]],
        "no overlap": [["flash.cu", "        repro::wgmma_wait<1>();",
                        "        repro::wgmma_wait0();"]],
        "no turns": [_FLASH_NO_TURNS],
        "128-row blocks": [["../flash/ops.py", "                rows = "
                            "WIDE_ROWS", "                rows = BLOCK_ROWS"]],
        "128-key tiles": _FLASH_128_KEYS,
        "3 stages": [_FLASH_3_STAGES],
        "no S (wrong)": [_FLASH_NO_S],
        "no P V (wrong)": [_FLASH_NO_PV],
        "no exponentials (wrong)": _FLASH_NO_EXP,
    },
    # the conv1d backward: the plan's vector width (16, 8 or 4 bytes), the
    # rows a thread walks (its halo costs K - 1 recomputed rows), the
    # partials (four warps a block: twice as many), the rows whose loads
    # go together, and no register cap (one block an SM)
    "conv1d_bwd_design": {
        "as is": [],
        "16-byte vectors": [_CONV_BWD_VEC + ["BWD_VEC_BYTES = 16"]],
        "4-byte vectors": [_CONV_BWD_VEC + ["BWD_VEC_BYTES = 4"]],
        "32 rows a thread": [
            ["conv1d_bwd.cu", "constexpr int kRows = 16;",
             "constexpr int kRows = 32;"],
            ["../conv1d/ops.py", "BWD_ROWS = 16", "BWD_ROWS = 32"]],
        "8 rows a thread": [
            ["conv1d_bwd.cu", "constexpr int kRows = 16;",
             "constexpr int kRows = 8;"],
            ["../conv1d/ops.py", "BWD_ROWS = 16", "BWD_ROWS = 8"]],
        "4 warps a block (twice the partials)": [
            ["conv1d_bwd.cu", "constexpr int kRowGroups = 8;",
             "constexpr int kRowGroups = 4;"],
            ["../conv1d/ops.py", "BWD_ROW_GROUPS = 8", "BWD_ROW_GROUPS = 4"]],
        "loads in batches of 8 rows": [
            ["conv1d_bwd.cu", "constexpr int kBatch = 4;",
             "constexpr int kBatch = 8;"]],
        "no register cap": [
            ["conv1d_bwd.cu", "constexpr int kMinBlocks = 2;",
             "constexpr int kMinBlocks = 1;"]],
    },
    # what each part of a tile costs: drop a product or the exponentials
    "breakdown": {
        "as is": [],
        "no S": [_FLASH_NO_S],
        "no PV": [_FLASH_NO_PV],
        "no exp": _FLASH_NO_EXP,
    },
    # the SSD kernel's fp32 operands each as one bf16 term instead of two
    # (hi + lo): what each split buys in error and costs in time
    "ssd_operands": {
        "split (as is)": [],
        "one-term scores": [["ssd.cu",
                             "        mma_bf16(acc[2 * pp], plo, "
                             "vb[0], vb[1]);\n"
                             "        mma_bf16(acc[2 * pp + 1], plo, "
                             "vb[2], vb[3]);\n", ""]],
        "one-term state": [["ssd.cu",
                            "        mma_bf16(acc[2 * pp], ca[kk], "
                            "bl4[0], bl4[1]);\n"
                            "        mma_bf16(acc[2 * pp + 1], ca[kk], "
                            "bl4[2], bl4[3]);\n", ""]],
        "one-term x*w": [["ssd.cu",
                          "        mma_bf16(sacc[t], alo, r[0], "
                          "r[1]);\n", ""],
                         ["ssd.cu",
                          "        mma_bf16(sacc[t + 1], alo, r[2], "
                          "r[3]);\n", ""]],
    },
    # what each part of the SSD kernel's chunk costs: drop a product or
    # the score exponentials
    "ssd_breakdown": {
        "as is": [],
        "no intra-chunk (C B^T and its product)": [
            ["ssd.cu", "    for (int cb = 0; cb <= rt; ++cb) {\n",
             "    for (int cb = 0; cb < 0; ++cb) {\n"]],
        "no inter-chunk (C . state^T)": [
            ["ssd.cu",
             "        mma_bf16(acc[2 * pp], ca[kk], bh4[0], bh4[1]);\n"
             "        mma_bf16(acc[2 * pp + 1], ca[kk], bh4[2], "
             "bh4[3]);\n"
             "        mma_bf16(acc[2 * pp], ca[kk], bl4[0], bl4[1]);\n"
             "        mma_bf16(acc[2 * pp + 1], ca[kk], bl4[2], "
             "bl4[3]);\n", ""]],
        "no state update": [
            ["ssd.cu",
             "        mma_bf16(sacc[t], ahi, r[0], r[1]);\n"
             "        mma_bf16(sacc[t], alo, r[0], r[1]);\n"
             "        mma_bf16(sacc[t + 1], ahi, r[2], r[3]);\n"
             "        mma_bf16(sacc[t + 1], alo, r[2], r[3]);\n", ""]],
        "no score exponentials": [
            ["ssd.cu", "exp2_approx(cuma - cj[jj])", "(cuma - cj[jj])"],
            ["ssd.cu", "exp2_approx(cumb - cj[jj])", "(cumb - cj[jj])"]],
        "skeleton (loads, scan, stores; no products, no exponentials)": [
            ["ssd.cu", "    for (int cb = 0; cb <= rt; ++cb) {\n",
             "    for (int cb = 0; cb < 0; ++cb) {\n"],
            ["ssd.cu",
             "        mma_bf16(acc[2 * pp], ca[kk], bh4[0], bh4[1]);\n"
             "        mma_bf16(acc[2 * pp + 1], ca[kk], bh4[2], "
             "bh4[3]);\n"
             "        mma_bf16(acc[2 * pp], ca[kk], bl4[0], bl4[1]);\n"
             "        mma_bf16(acc[2 * pp + 1], ca[kk], bl4[2], "
             "bl4[3]);\n", ""],
            ["ssd.cu",
             "        mma_bf16(sacc[t], ahi, r[0], r[1]);\n"
             "        mma_bf16(sacc[t], alo, r[0], r[1]);\n"
             "        mma_bf16(sacc[t + 1], ahi, r[2], r[3]);\n"
             "        mma_bf16(sacc[t + 1], alo, r[2], r[3]);\n", ""],
            ["ssd.cu", "        ecum[i] = exp2_approx(c2);\n"
             "        wend[i] = dtc[i] * exp2_approx(last2 - c2);\n",
             "        ecum[i] = c2;\n        wend[i] = dtc[i] * (last2 - c2);\n"]],
    },
    # what the SSD kernel's chunk loads cost: B and C (shared by every
    # head of a batch row, read from L2 by each head's block) or x loaded
    # for the first chunk only (wrong after it, on purpose)
    "ssd_traffic": {
        "as is": [],
        "B and C for chunk 0 only": [
            ["ssd.cu",
             "    for (int e = tid; e < Q * BV; e += kTThreads) {\n",
             "    for (int e = tid; ci == 0 && e < Q * BV; e += kTThreads) {\n"]],
        "x for chunk 0 only": [
            ["ssd.cu",
             "    for (int e = tid; e < Q * XV; e += kTThreads) {\n",
             "    for (int e = tid; ci == 0 && e < Q * XV; e += kTThreads) {\n"]],
    },
    # the Mamba-2 decode step's copy of the conv window into the new
    # cache: its own loop (unrolled or not) or inside the conv loop, which
    # has the window's values loaded already
    "mamba2_decode_window": {
        "own loop (as is)": [],
        "own loop, not unrolled": [["decode_fused.cu",
                                    "      for (int k = 0; k < K - 2; ++k)",
                                    "#pragma unroll 1\n      for (int k = 0; "
                                    "k < K - 2; ++k)"]],
        "in the conv loop": [["decode_fused.cu", "    for (int k = 0; k < kMaxK; ++k) {\n      if (k < K) {\n        const float v = k < K - 1 ? repro::to_f32(conv_b[(size_t)k * C + c])\n                                  : repro::to_f32(xt);\n        acc = __fadd_rn(acc, __fmul_rn(v, w[c * K + k]));\n      }\n    }\n", "    for (int k = 0; k < kMaxK; ++k) {\n      if (k < K) {\n        const T raw = k < K - 1 ? conv_b[(size_t)k * C + c] : xt;\n        acc = __fadd_rn(acc, __fmul_rn(repro::to_f32(raw), w[c * K + k]));\n        if (write_window && k > 0) nconv_b[(size_t)(k - 1) * C + c] = raw;\n      }\n    }\n"],
                             ["decode_fused.cu", "    if (write_window) {\n      for (int k = 0; k < K - 2; ++k)\n        nconv_b[(size_t)k * C + c] = conv_b[(size_t)(k + 1) * C + c];\n      nconv_b[(size_t)(K - 2) * C + c] = xt;\n    }\n", ""]],
    },
    # the Mamba-1 decode step before its cluster design (one block per
    # 128-channel tile and batch row, each rerunning the conv for every
    # channel and the whole x_proj product): what each phase costs.  Its
    # edits are to that earlier source, so run it with --tree on a
    # checkout of the commit before the cluster design.
    "mamba1_decode_breakdown_tiled": {
        "as is": [],
        "conv for the tile's channels only": [
            ["mamba1_decode.cu",
             "  for (int c = tid; c < di; c += kThreads) {\n"
             "    const T xt = xit[(size_t)b * di + c];",
             "  for (int c = c0 + tid; c < min(di, c0 + kTile); "
             "c += kThreads) {\n"
             "    const T xt = xit[(size_t)b * di + c];"]],
        "no x_proj product": [
            ["mamba1_decode.cu", "  if (tid < R * V) {\n",
             "  if (false) {\n"]],
        "no state phase": [
            ["mamba1_decode.cu",
             "    if (c < di) {                        // the same for the N "
             "lanes\n",
             "    if (false) {\n"]],
    },
    # the redesigned step (8-block clusters, two per batch row, each
    # updating half of every tile's state): one phase cut, the floors (the
    # launch, a cluster barrier, the staged bytes), and cumulatively,
    # returning after one more phase
    "mamba1_decode_breakdown": {
        "as is": [],
        "no x_proj product": [
            ["mamba1_decode.cu", "      for (int i = r0; i < nc; i += R) {",
             "      for (int i = r0; i < 0; i += R) {"]],
        "no exchange between blocks (own partial only)": [
            ["mamba1_decode.cu",
             "        cluster.map_shared_rank(parts, q)[rank * F + f] = s;",
             "        parts[q * F + f] = s;"]],
        "no state phase": [
            ["mamba1_decode.cu",
             "    if (i < ns) {                        // the same for the "
             "N lanes\n",
             "    if (false) {\n"]],
        "no exponentials in the state update": [
            ["mamba1_decode.cu",
             "      const float a = -expf(als[i * N + n]);\n"
             "      const float da = expf(dt * a);\n",
             "      const float da = dt * als[i * N + n];\n"]],
        "no staging": [
            ["mamba1_decode.cu",
             "  stage(xps, 0, xp + (size_t)c0 * F, 0, 1, nc * F, tid);\n", ""],
            ["mamba1_decode.cu",
             "  stage(hs, 0, ssm + ((size_t)b * di + c0 + s0) * N, 0, 1, "
             "ns * N, tid);\n  stage(als, 0, A_log + (size_t)(c0 + s0) * N, "
             "0, 1, ns * N, tid);\n  stage(dps, ts, dtp + c0 + s0, di, dtr, "
             "ns, tid);\n", ""]],
        "one cluster per batch row (no state halves)": _M1_ONE_CLUSTER,
        "launch only (returns at once)": [
            ["mamba1_decode.cu", "  const int tid = threadIdx.x;\n",
             "  const int tid = threadIdx.x;\n  if (di > 0) return;\n"]],
        "one cluster barrier only": [
            ["mamba1_decode.cu", "  const int tid = threadIdx.x;\n",
             "  const int tid = threadIdx.x;\n"
             "  if (di > 0) { cluster.sync(); return; }\n"]],
        "up to the conv step and the staging": [
            ["mamba1_decode.cu",
             "  repro::cp_async_wait<1>();\n  __syncthreads();\n",
             "  if (di > 0) { repro::cp_async_wait<0>(); return; }\n"
             "  repro::cp_async_wait<1>();\n  __syncthreads();\n"]],
        "up to the exchange": [
            ["mamba1_decode.cu",
             "    proj[f] = repro::to_f32(repro::from_f32<T>(s));\n  }\n",
             "    proj[f] = repro::to_f32(repro::from_f32<T>(s));\n  }\n"
             "  if (di > 0) { repro::cp_async_wait<0>(); return; }\n"]],
        "up to dt": [
            ["mamba1_decode.cu",
             "      dts[tid] = repro::softplus(s + dtb);\n    }\n"
             "    __syncthreads();\n  }\n",
             "      dts[tid] = repro::softplus(s + dtb);\n    }\n"
             "    __syncthreads();\n  }\n"
             "  if (di > 0) return;\n"]],
    },
    # the Mamba-1 step's exchange and layout: the partials pushed into
    # every block before one barrier (as is) against each block pulling
    # the others' after it, with a second barrier before exit; and one
    # cluster per batch row against two (also at B=16, two waves)
    "mamba1_decode_exchange": {
        "push, one barrier (as is)": [],
        "pull, a second barrier before exit": [
            ["mamba1_decode.cu",
             "#pragma unroll\n      for (int q = 0; q < kCluster; ++q)\n"
             "        cluster.map_shared_rank(parts, q)[rank * F + f] = s;",
             "      parts[rank * F + f] = s;"],
            ["mamba1_decode.cu",
             "    for (int q = 0; q < kCluster; ++q) s += parts[q * F + f];",
             "    for (int q = 0; q < kCluster; ++q)\n"
             "      s += cluster.map_shared_rank(parts, q)[q * F + f];"],
            ["mamba1_decode.cu",
             "    proj[f] = repro::to_f32(repro::from_f32<T>(s));\n  }\n",
             "    proj[f] = repro::to_f32(repro::from_f32<T>(s));\n  }\n"
             "  cluster.sync();\n"]],
        "one cluster per batch row (no state halves)": _M1_ONE_CLUSTER,
    },
    # causal conv1d: the launch rule's (vector, rows) against fixed ones,
    # one channel a thread, the floors (its loads and stores alone, its
    # arithmetic alone with the window made up from the row and channel
    # indices), SiLU with the IEEE division, and the taps read from
    # memory instead of staged in shared memory
    "conv1d_design": {
        "the launch rule (as is)": [],
        "16-byte vectors, 8 rows": [
            ["conv1d.cu", _RULE, "  const int rows = 8;\n"]],
        "16-byte vectors, 16 rows": [
            ["conv1d.cu", _RULE, "  const int rows = 16;\n"]],
        "8-byte vectors, 16 rows": [
            ["conv1d.cu", _RULE,
             "  const int rows = 16;\n  v = v > 1 ? v / 2 : 1;\n"]],
        "8-byte vectors, 8 rows": [
            ["conv1d.cu", _RULE,
             "  const int rows = 8;\n  v = v > 1 ? v / 2 : 1;\n"]],
        "one channel a thread, 8 rows": [
            ["conv1d.cu", _RULE, "  const int rows = 8;\n  v = 1;\n"]],
        "loads and stores only (y = x)": [
            ["conv1d.cu", "        res[e] = silu(acc);",
             "        res[e] = win[r + K - 1].get(e);"]],
        "arithmetic only (no window loads)": [
            ["conv1d.cu",
             "      else if (r < S) win[i].load(xb + (size_t)r * C);",
             "      else if (r < S) {\n"
             "        for (int q = 0; q < Vec<T, V>::kWords; ++q)\n"
             "          win[i].u[q] = (unsigned)(r * 40503 + c * 7 + q) & "
             "0x3fff3fffu;\n      }"]],
        "SiLU with the IEEE division": [
            ["conv1d.cu", "        res[e] = silu(acc);",
             "        res[e] = repro::silu(acc);"]],
        "taps read from memory": [
            ["conv1d.cu",
             "    for (int i = 0; i < K; ++i) wk[e][i] = ws[i][padded(tid * V "
             "+ e)];\n    bc[e] = ws[K][padded(tid * V + e)];",
             "    for (int i = 0; i < K; ++i) wk[e][i] = w[(size_t)(c + e) * K "
             "+ i];\n    bc[e] = bias[c + e];"]],
    },
    # where the selective scan's time goes: each phase of a tile alone,
    # and each cut from the whole
    "scan1_breakdown": {
        "as is": [],
        "staging alone (no state work)": [_SCAN1_NO_STATES],
        "ex2 alone (staging, ex2, the fold; no B, scan or second walk)": [
            _SCAN1_NO_SCAN, _SCAN1_NO_B, _SCAN1_NO_WALK],
        "shuffle scan alone (staging, the fold, the scan; no ex2, B or "
        "second walk)": [_SCAN1_NO_EX2, _SCAN1_NO_B, _SCAN1_NO_WALK],
        "no ex2": [_SCAN1_NO_EX2],
        "no B loads": [_SCAN1_NO_B],
        "no shuffle scan": [_SCAN1_NO_SCAN],
        "no second walk": [_SCAN1_NO_WALK],
    },
    # the tile's skeleton: the loads, the B/C copy and the y rows each
    # cut
    "scan1_skeleton": {
        "as is": [],
        "no loads (shared memory as it is)": [_SCAN1_NO_LOADS],
        "no B/C copy": [_SCAN1_NO_COOK],
        "no y rows": [_SCAN1_NO_OUTPUT],
    },
    # the scan's launch plans at every shape: scan1_plan's rule against
    # each plan everywhere, two warps a channel (each scanning half of
    # the states), 16 steps a lane, and other state groups
    "scan1_plans": {
        "rule (as is)": [],
        "4 channels a block everywhere": [_SCAN1_RULE + ["index = 0"]],
        "8 channels a block everywhere": [_SCAN1_RULE + ["index = 1"]],
        "16 steps a lane at B=1": [
            ["scan1.cu", "launch<T, N, 8, 4, 2, 4>",
             "launch<T, N, 16, 4, 2, 3>"]],
        "groups of 4 states": [
            ["scan1.cu", "launch<T, N, 8, 4, 2, 4>",
             "launch<T, N, 8, 4, 4, 4>"],
            ["scan1.cu", "launch<T, N, 8, 8, 2, 2>",
             "launch<T, N, 8, 8, 4, 2>"]],
    },
}


def scan1_child() -> int:
    """The selective scan's check (chip_smoke's limits on y and the state,
    worst ratio) and its time in bf16 at mamba-130m's width: B=4, S=256
    (a served chunk), B=1, S=2048 and B=1, S=16384, on inputs at the
    model's scales (``scan1.ref.model_scale_inputs``)."""
    import torch

    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.configs import mamba_130m as cfg
    from repro_torch.kernels.scan1 import ops, ref

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    c, n = cfg.ssm.d_inner(cfg.d_model), cfg.ssm.d_state
    out = {}
    for b, s in ((4, 256), (1, 2048), (1, 16384)):
        args, h0 = ref.model_scale_inputs(gen, b, s, c, n, bf16)
        got = ops.selective_scan(*args, initial_state=h0)
        want = ref.selective_scan_ref(*args, h0)
        out[f"scan1 B={b} S={s}"] = (
            cs.scan_ratio(got, want, bf16),
            cs.device_ms(lambda: ops.selective_scan(*args, initial_state=h0),
                         calls=10 if s <= 2048 else 3,
                         reps=25 if s <= 2048 else 10))
        del args, h0, got, want
    print(json.dumps(out))
    return 0


def m1_child() -> int:
    """The Mamba-1 decode step's check (chip_smoke's limit on inputs at
    the model's scales, worst output) and its time at mamba-130m's shape,
    bf16, B=4, B=1 and B=16."""
    import torch

    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.configs import mamba_130m as cfg
    from repro_torch.kernels.decode_fused import ops, ref
    from repro_torch.models.mamba1 import dt_rank

    gen = torch.Generator(device="cuda").manual_seed(0)
    s = cfg.ssm
    c, n, k, r = s.d_inner(cfg.d_model), s.d_state, s.conv_kernel, \
        dt_rank(cfg.d_model, s)
    kw = dict(d_state=n, dt_rank=r)
    out = {}
    for b in (4, 1, 16):
        args = cs.mamba1_decode_inputs(gen, b, c, n, r, k, torch.bfloat16)
        tol = cs.TOL["decode_fused"][torch.bfloat16]
        got = ops.mamba1_decode_fused(*args, **kw)
        want = ref.mamba1_decode_fused_ref(*args, **kw)
        out[f"mamba1_decode {cfg.name} B={b} bfloat16"] = (
            max(cs.whole_ratio(x, y, tol) for x, y in zip(got, want)),
            cs.device_ms(lambda: ops.mamba1_decode_fused(*args, **kw)))
    print(json.dumps(out))
    return 0


def conv_child() -> int:
    """causal conv1d's check (chip_smoke's limit, worst output) and its
    time in bf16 at B=4, S=256 and the channel counts of mamba2-2.7b,
    zamba2-2.7b and mamba-130m; with ragged ``lengths`` too where the
    wrapper takes them."""
    import inspect

    import torch

    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels.conv1d import ops, ref

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    takes_lengths = "lengths" in inspect.signature(
        ops.causal_conv1d).parameters
    out = {}
    for label, c in cs.conv_shapes():
        x = torch.randn((4, 256, c), generator=gen, device="cuda").to(bf16)
        w = torch.randn((c, 4), generator=gen, device="cuda")
        b = torch.randn((c,), generator=gen, device="cuda")
        st = torch.randn((4, 3, c), generator=gen, device="cuda").to(bf16)
        tol = cs.TOL["conv1d"][bf16]
        calls = {"": {}}
        if takes_lengths:
            calls[" lengths"] = dict(lengths=torch.tensor(
                [256, 200, 2, 0], dtype=torch.int32, device="cuda"))
        for tag, kw in calls.items():
            got = ops.causal_conv1d(x, w, b, initial_state=st, **kw)
            want = ref.causal_conv1d_ref(x, w, b, st, **kw)
            out[f"conv1d {label}{tag}"] = (
                max(cs.whole_ratio(g, v, tol) for g, v in zip(got, want)),
                cs.device_ms(lambda: ops.causal_conv1d(
                    x, w, b, initial_state=st, **kw)))
    print(json.dumps(out))
    return 0


def decode_child() -> int:
    """The Mamba-2 decode step's check (chip_smoke's limit on inputs at
    the model's scales, worst output) and its time, bf16 and fp32."""
    import torch

    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.configs import mamba2_2p7b, zamba2_2p7b
    from repro_torch.kernels.decode_fused import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for cfg in (mamba2_2p7b, zamba2_2p7b):
        s = cfg.ssm
        h, p, g, n, k = (s.n_ssm_heads(cfg.d_model), s.headdim, s.n_groups,
                         s.d_state, s.conv_kernel)
        kw = dict(n_groups=g, d_state=n, headdim=p)
        for dt in (torch.bfloat16, torch.float32):
            args = cs.mamba2_decode_inputs(gen, 4, h, p, g, n, k, dt)
            tol = cs.TOL["decode_fused"][dt]
            got = ops.mamba2_decode_fused(*args, **kw)
            want = ref.mamba2_decode_fused_ref(*args, **kw)
            out[f"mamba2_decode {cfg.name} {str(dt)[6:]}"] = (
                max(cs.whole_ratio(a, b, tol) for a, b in zip(got, want)),
                cs.device_ms(lambda: ops.mamba2_decode_fused(*args, **kw)))
    print(json.dumps(out))
    return 0


def ssd_child() -> int:
    """Each SSD case's check (chip_smoke.check_ssd's worst ratio to its
    limits) and its time."""
    import torch

    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.configs import mamba2_2p7b, zamba2_2p7b
    from repro_torch.kernels.ssd import ops, ref

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def worst(got, want):
        tol = cs.TOL["ssd"][bf16]
        return max(cs.whole_ratio(got[0], want[0], tol),
                   cs.whole_ratio(got[1], want[1], tol),
                   cs.row_ratio(got[0], want[0], tol))

    out = {}
    for cfg in (mamba2_2p7b, zamba2_2p7b):
        s = cfg.ssm
        b, h, p, n, q = 4, s.n_ssm_heads(cfg.d_model), s.headdim, \
            s.d_state, s.chunk
        # phase 3's unscaled draws at the served shape, then 16 chunks at
        # the model's scales
        args = (rn(b, 2 * q, h, p, dtype=bf16),
                ref.softplus(rn(b, 2 * q, h) - 2.0), -torch.exp(rn(h)),
                rn(b, 2 * q, 1, n, dtype=bf16), rn(b, 2 * q, 1, n, dtype=bf16),
                rn(h))
        h0 = rn(b, h, p, n)
        kw = dict(chunk=q, initial_state=h0)
        out[f"ssd {cfg.name} 2 chunks"] = (
            worst(ops.ssd_chunked(*args, **kw),
                  ref.ssd_chunked_ref(*args, **kw)),
            cs.device_ms(lambda: ops.ssd_chunked(*args, **kw)))
        args16, h16 = ref.model_scale_inputs(gen, b, 16 * q, h, p, n, bf16)
        kw16 = dict(chunk=q, initial_state=h16)
        out[f"ssd {cfg.name} 16 chunks"] = (
            worst(ops.ssd_chunked(*args16, **kw16),
                  ref.ssd_chunked_ref(*args16, **kw16)),
            cs.device_ms(lambda: ops.ssd_chunked(*args16, **kw16), calls=3,
                         reps=10))
    print(json.dumps(out))
    return 0


def bwd_child(which: str) -> int:
    """The flash (``which`` "flash"), SSD ("ssd") or selective-scan
    ("scan1") backward's check at ``chip_smoke.bwd_cases`` (B=4, S=512,
    bf16: the worst gradient's ratio to ``BWD_TOL`` of its max |g|, inf if
    two calls differ) and its time at the training shapes (zamba2-2.7b's
    B=4, S=2048; smollm-135m's flash and mamba-130m's scan at B=8)."""
    import torch

    sys.path.insert(1, ROOT)
    import chip_smoke as cs

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    at_b8 = {"flash_bwd_smollm", "scan1_bwd"}
    shapes = ((4, 512), (8, 2048)) if which == "scan1" else (
        (4, 512), (4, 2048), (8, 2048))
    for b, s in shapes:
        for name, (kern, plain, *_r) in cs.bwd_cases(gen, bf16, b,
                                                     s).items():
            if not name.startswith(which + "_bwd") or (
                    b == 8 and name not in at_b8):
                continue
            got, again, want = kern(), kern(), plain()
            ratio = max(cs.whole_ratio(g, w, cs.BWD_TOL[bf16],
                                       floor=torch.finfo(torch.float32).tiny)
                        for g, w in zip(got, want))
            if not all(torch.equal(g, g2) for g, g2 in zip(got, again)):
                ratio = float("inf")
            del got, again, want
            out[f"{name} B={b}, S={s}"] = (ratio, cs.device_ms(kern, 2, 5))
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def fwd_child() -> int:
    """The flash forward at d = 80 and 96 in bf16: non-causal at
    hubert-xlarge's encoder shape (B=4, 16 heads on 16, 1500 frames) and
    at d = 96, and the causal chunks of ``chip_smoke.attention_cases`` at
    zamba2-2.7b's and phi-3-mini's head dims; each query row against the
    plain version (``row_ratio``), and its time."""
    import torch

    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels.flash import ops, ref

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = {}
    for d in (80, 96):
        q, k, v = (torch.randn((4, 1500, 16, d), generator=gen,
                               device="cuda").to(bf16).transpose(1, 2)
                   for _ in range(3))
        calls[f"non-causal d={d}, 4 x 16 heads x 1500"] = (
            q, k, v, dict(causal=False))
    for label, h, kvh, d, bucket, offs, _ in cs.attention_cases():
        if d in (80, 96):
            q, k, v, _ = cs.attention_inputs(gen, h, kvh, d, bucket, bf16)
            off = torch.tensor(offs, dtype=torch.int32, device="cuda")
            calls[f"flash {label}"] = (q, k, v, dict(q_offset=off))
    out = {}
    for key, (q, k, v, kw) in calls.items():
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.attention_ref(q, k, v, **kw)
        out[key] = (cs.row_ratio(got, want, cs.TOL["attention"][bf16]),
                    cs.device_ms(lambda: ops.flash_attention(q, k, v, **kw)))
    print(json.dumps(out))
    return 0


def conv_bwd_child() -> int:
    """The conv1d backward at zamba2-2.7b's training shape (B=4, S=2048,
    C=5248, K=4) in bf16 and fp32: the worst gradient's ratio to
    ``chip_smoke.BWD_TOL`` of its max |g| (inf if two calls differ), and
    its time."""
    import torch

    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels.conv1d import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        x, dy = (torch.randn((4, 2048, 5248), generator=gen,
                             device="cuda").to(dt) for _ in range(2))
        w = 0.5 * torch.randn((5248, 4), generator=gen, device="cuda")
        b = 0.1 * torch.randn((5248,), generator=gen, device="cuda")
        got = ops.causal_conv1d_bwd_cuda(x, w, b, dy)
        again = ops.causal_conv1d_bwd_cuda(x, w, b, dy)
        want = ref.causal_conv1d_bwd_ref(x, w, b, dy)
        ratio = max(cs.whole_ratio(g, r, cs.BWD_TOL[dt],
                                   floor=torch.finfo(torch.float32).tiny)
                    for g, r in zip(got, want))
        if not all(torch.equal(g, g2) for g, g2 in zip(got, again)):
            ratio = float("inf")
        out[f"conv1d_bwd zamba2-2.7b B=4, S=2048 {str(dt)[6:]}"] = (
            ratio, cs.device_ms(
                lambda: ops.causal_conv1d_bwd_cuda(x, w, b, dy), 2, 10))
    print(json.dumps(out))
    return 0


def child(micro: bool) -> int:
    import torch

    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels.flash import ops, ref

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    calls = {}
    if micro:
        for d in (128, 256):
            for skv in (1024, 4096):
                q = rn(1, 4224, 4, d).transpose(1, 2)
                k, v = (rn(1, skv, 1, d).transpose(1, 2) for _ in range(2))
                calls[f"micro d={d} keys={skv}"] = (q, k, v,
                                                     dict(causal=False))
    else:
        for label, h, kvh, d, bucket, offs, _ in cs.attention_cases():
            q, k, v, _ = cs.attention_inputs(gen, h, kvh, d, bucket, bf16)
            off = torch.tensor(offs, dtype=torch.int32, device="cuda")
            calls[f"flash {label}"] = (q, k, v, dict(q_offset=off))
        r = cs.RING
        for label, ring_len, sq, wraps in cs.ring_cases():
            q = rn(r["B"], sq, r["H"], r["d"]).transpose(1, 2)
            k, v = (rn(r["B"], ring_len + sq, r["KVH"], r["d"]).transpose(
                1, 2) for _ in range(2))
            wrap = torch.tensor(wraps, dtype=torch.int32, device="cuda")
            calls[f"ring {label}"] = (q, k, v, dict(
                causal=True, window=r["window"], q_offset=wrap,
                kv_wrap=wrap, ring_len=ring_len))
    out = {}
    for key, (q, k, v, kw) in calls.items():
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.attention_ref(q, k, v, **kw)
        out[key] = (cs.row_ratio(got, want, cs.TOL["attention"][bf16]),
                    cs.device_ms(lambda: ops.flash_attention(q, k, v, **kw)))
    print(json.dumps(out))
    return 0


def run_variant(name: str, edits, micro: bool, kind: str, tree: str,
                fresh: bool):
    """Copy ``tree``'s package with ``name``'s edits (``fresh``; else the
    copy and its build from the first pass are reused) and time it."""
    base = os.path.join(ROOT, "build", "variants",
                        "".join(ch if ch.isalnum() else "_" for ch in name))
    if fresh:
        shutil.rmtree(base, ignore_errors=True)
        shutil.copytree(os.path.join(tree, "src", "repro_torch"),
                        os.path.join(base, "src", "repro_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        for src, old, new in edits:
            path = os.path.join(base, "src", CSRC, src)
            with open(path) as f:
                text = f.read()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the text to replace is not "
                                   f"found exactly once in {src}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
    env = dict(os.environ, PYTHONPATH=os.path.join(base, "src"))
    flag = {"ssd": ["--ssd"], "decode": ["--decode"], "m1": ["--m1"],
            "conv": ["--conv"], "scan1": ["--scan1"], "fwd": ["--fwd"],
            "conv_bwd": ["--conv-bwd"],
            "bwd_flash": ["--bwd", "flash"], "bwd_ssd": ["--bwd", "ssd"],
            "bwd_scan1": ["--bwd", "scan1"]}.get(
                kind, ["--micro"] if micro else [])
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--child"] + flag, env=env, capture_output=True,
                         text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(f"{name}: child failed\n{res.stdout}\n"
                           f"{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1]), spills(base)


def spills(base: str):
    """The kernels of a variant's build that ptxas reports spilling."""
    out, fn = [], None
    with open(os.path.join(base, "build", "repro_torch", "ptxas.log")) as f:
        for line in f:
            if "Function properties for" in line:
                fn = line.rsplit(" ", 1)[-1].strip()
            elif "spill stores" in line and not line.strip().startswith(
                    "0 bytes stack frame, 0 bytes spill"):
                out.append(f"{fn}: {line.strip()}")
    return out


def main(spec: str, micro: bool, tree: str) -> int:
    if spec in SETS:
        variants = SETS[spec]
    else:
        with open(spec) as f:
            variants = json.load(f)
    names = list(variants)
    kind = ("bwd_ssd" if spec.startswith("bwd_ssd") else
            "bwd_scan1" if spec.startswith("bwd_scan1") else
            "bwd_flash" if spec.startswith("bwd_flash") else
            "ssd" if spec.startswith("ssd") else
            "scan1" if spec.startswith("scan1") else
            "decode" if spec.startswith("mamba2_decode") else
            "m1" if spec.startswith("mamba1_decode") else
            "fwd" if spec.startswith("fwd_flash") else
            "conv_bwd" if spec.startswith("conv1d_bwd") else
            "conv" if spec.startswith("conv1d") else "flash")
    times, ratios = {}, {}
    for i, name in enumerate(names + names[::-1]):
        res, spilled = run_variant(name, variants[name], micro, kind, tree,
                                   fresh=i < len(names))
        if i < len(names):
            print(json.dumps({"variant": name, "spills": spilled}))
        for key, (ratio, ms) in res.items():
            times.setdefault(key, {}).setdefault(name, []).append(ms)
            ratios.setdefault(key, {}).setdefault(name, []).append(ratio)
            if ratio > 1.0:
                print(f"WRONG {name} {key}: {ratio} x its limit")
    for key, by_name in times.items():
        print(json.dumps({"case": key, "ms": by_name,
                          "of_limit": ratios[key]}))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    micro = "--micro" in args
    args = [a for a in args if a != "--micro"]
    tree = ROOT
    if "--tree" in args:
        i = args.index("--tree")
        tree = os.path.abspath(args[i + 1])
        del args[i:i + 2]
    children = {"--ssd": ssd_child, "--decode": decode_child,
                "--m1": m1_child, "--conv": conv_child,
                "--scan1": scan1_child, "--fwd": fwd_child,
                "--conv-bwd": conv_bwd_child}
    if args[:2] == ["--child", "--bwd"]:
        sys.exit(bwd_child(args[2]))
    if args[:1] == ["--child"] and args[1:] and args[1] in children:
        sys.exit(children[args[1]]())
    if args == ["--child"]:
        sys.exit(child(micro))
    if len(args) != 1:
        sys.exit(__doc__)
    sys.exit(main(args[0], micro, tree))
