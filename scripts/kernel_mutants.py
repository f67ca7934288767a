"""Show that chip_smoke.py's kernel checks catch planted faults that the
checks they replaced let through.

    python3 scripts/kernel_mutants.py [MUTANT ...]

Needs an NVIDIA card and ``nvcc``.  For the unchanged sources and for each
mutant below (or each one named), it copies ``src/repro_torch`` into
``build/mutants/<name>/`` (listed in .gitignore), applies the mutant's edit to one kernel source
there, and in a child process builds that copy and runs the check of the
mutant's kernel (every check for the unchanged sources):

- ``attention``: the flash and decode kernels against their plain
  versions at every shape of ``chip_smoke.attention_cases``
  (qwen2.5-0.5b, zamba2-2.7b, phi-3-mini, llama3-8b, gemma3-1b,
  falcon-h1-0.5b and glm4-9b on the ``wgmma`` flash at d=64, 80, 96, 128
  and 256 with its key splits; decode with up to 16 splits and up to 16
  query heads a KV head), the inputs of
  ``chip_smoke.phase_attention``, and decode over gemma3-1b's local ring
  (``chip_smoke.LOCAL_DECODE``).  ``ratio`` is the per-row check that
  chip_smoke.py applies (``row_ratio``), ``old_ratio`` the whole-tensor
  check it replaced (``whole_ratio``: 2e-2 of max(1, max |o|) in bf16).
- ``mamba1_decode``: the fused Mamba-1 decode step (one thread block
  cluster per batch row) against its plain version at mamba-130m's
  shapes (B=4).  ``ratio`` is chip_smoke.py's check on inputs at the
  model's scales (``mamba1_decode_inputs``), ``old_ratio`` the same limit
  on the unscaled normal draws it replaced, where dt is ~0 or ~100s;
  both the worst output's ``whole_ratio``.
- ``conv1d``: causal conv1d against its plain version at the channel
  counts of mamba2-2.7b, zamba2-2.7b and mamba-130m (B=4, S=256), and
  with ragged valid lengths: ``ratio`` the worst of y's limit and the
  new state's bit-equality, ``old_ratio`` y's limit alone.
- ``ring``: the flash kernel's ring mode against its plain version on
  every case of ``chip_smoke.ring_cases`` (gemma3-1b's shapes).
  ``ratio`` is chip_smoke.py's per-row check, ``old_ratio`` the
  whole-tensor limit.
- ``ssd``: the SSD scan against its plain version at mamba2-2.7b's and
  zamba2-2.7b's shapes (B=4).  ``ratio`` is chip_smoke.py's check on a
  16-chunk sequence at the model's scales
  (``ssd.ref.model_scale_inputs``): the worst of y's and the state's
  whole-tensor limits and y's per-row limit (``check_ssd``);
  ``old_ratio`` the whole-tensor limits on the 2-chunk unscaled draws
  that were the only check before.
- ``mamba2_decode``: the fused Mamba-2 decode step against its plain
  version at both models' shapes (B=4).  ``ratio`` is chip_smoke.py's
  check on inputs at the model's scales (``mamba2_decode_inputs``),
  ``old_ratio`` the same limit on unscaled normal draws; both the worst
  output's ``whole_ratio``.
- ``scan1``: the selective scan against its plain version at mamba-130m's
  width on inputs at the model's scales, over one tile and many
  (``scan1_readings``); a mutant of it must fail by 10x its limit.
- ``backward``: the three backward kernels (flash, SSD, conv1d) against
  their plain backwards at zamba2-2.7b's and smollm-135m's shapes
  (``chip_smoke.bwd_cases``, B=4, S=512), each gradient within
  ``chip_smoke.BWD_TOL`` of its own max |g| and two calls bit for bit;
  bf16 takes the tensor-core routes (flash on wgmma, SSD's chunk-parallel
  passes on mma.sync), fp32 the CUDA-core kernels, and each route has
  its planted fault; the selective-scan backward (in each type: dA
  without one tile's share, the gradient's carry between tiles zeroed,
  one warp's channel left out of a block's dB / dC sum), the flash
  backward's
  window and non-causal modes have theirs.

1 is the limit.  Exits 1 if the unchanged kernels fail a check or a
mutant passes its kernel's check (or, for ``scan1``, fails it by less
than 10x), or if a mutant of ``EXPECT_EQUAL`` (a fault no input can
show) reads other than the unchanged kernels.  The repository's own sources are never
edited.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("repro_torch", "kernels", "csrc")

# name -> (check, kernel source, text to replace, replacement, what it
# breaks)
MUTANTS = {
    "unchanged": None,
    "flash_drop_tile_17": (
        "attention", "flash.cu", "  bool ok = key < p.Skv;\n",
        "  bool ok = key < p.Skv && !(qpos >= 1024 && key / 64 == 17);\n",
        "flash: queries at positions >= 1024 lose KV tile 17 (keys "
        "1088-1151)"),
    "decode_drop_tile_1024": (
        "attention", "attn_decode.cu", "  return key < hi;\n",
        "  return key < hi && (key < 1024 || key >= 1056);\n",
        "decode: rows with more than 1024 valid keys lose keys 1024-1055"),
    "flash_drop_4_keys": (
        "attention", "flash.cu", "  bool ok = key < p.Skv;\n",
        "  bool ok = key < p.Skv && !(qpos >= 1536 && key >= 1536 && "
        "key < 1540);\n",
        "flash: queries at positions >= 1536 lose keys 1536-1539"),
    "decode_drop_4_keys": (
        "attention", "attn_decode.cu", "  return key < hi;\n",
        "  return key < hi && (key < 1536 || key >= 1540);\n",
        "decode: rows with more than 1536 valid keys lose keys 1536-1539"),
    "decode_second_tile_reads_first_queries": (
        "attention", "attn_decode.cu",
        "    const int g = j * kGTile + gr;\n",
        "    const int g = gr;\n",
        "decode (bf16, groups past 8): the second N tile scores the first "
        "tile's queries, so heads 8-15 of each KV head repeat heads 0-7"),
    "decode_merge_drops_last_split": (
        "attention", "attn_decode.cu",
        "      if (s < nlive) {\n        o.x",
        "      if (s < nlive - 1) {\n        o.x",
        "decode: the in-kernel merge leaves out the last live split"),
    "mamba1_drop_carry": (
        "mamba1_decode", "mamba1_decode.cu",
        "const float hn = __fadd_rn(__fmul_rn(hs[i * N + n], da),",
        "const float hn = __fadd_rn(0.0f * da,",
        "Mamba-1 decode: the new state drops h * exp(dt * A), "
        "h' = dt * x * B"),
    "mamba1_odd_readout": (
        "mamba1_decode", "mamba1_decode.cu",
        "y[(size_t)b * di + c0 + s0 + i] = __fadd_rn(v[it], xd[s0 + i]);",
        "y[(size_t)b * di + c0 + s0 + i] = __fadd_rn(((c0 + s0 + i) & 1) ? "
        "0.0f : v[it], xd[s0 + i]);",
        "Mamba-1 decode: odd channels lose C . h' from y"),
    "mamba1_cluster_drops_last_partial": (
        "mamba1_decode", "mamba1_decode.cu",
        "    for (int q = 0; q < kCluster; ++q) s += parts[q * F + f];\n",
        "    for (int q = 0; q < kCluster - 1; ++q) s += parts[q * F + f];\n",
        "Mamba-1 decode: the rank-order sum of the x_proj partials leaves "
        "out the last block's"),
    "conv1d_drop_halo": (
        "conv1d", "conv1d.cu",
        "  // the new state: rows len .. len + K - 2 of [init; x], copied as "
        "they are\n",
        "  if (blockIdx.y > 0) win[K - 2] = Vec<T, V>{};\n"
        "  // the new state: rows len .. len + K - 2 of [init; x], copied as "
        "they are\n",
        "conv1d: a sequence tile's first row ignores the previous tile's "
        "last input"),
    "conv1d_state_off_by_one": (
        "conv1d", "conv1d.cu", "      const int j = len + k;\n",
        "      const int j = min(len + k + 1, S + K - 2);\n",
        "conv1d: the new state starts at row len + 1 of [init; x]"),
    "ring_signed_mod": (
        "ring", "flash.cu", "  return r < 0 ? r + m : r;\n",
        "  return r;\n",
        "flash ring: C's signed %, so a slot at or past an unwrapped "
        "cursor reads as position j, not as never written"),
    "ring_skip_after_wrap": (
        "ring", "flash.cu",
        "  const int ring_keys = wrap >= p.window ? ring : max(0, min(ring, "
        "wrap));\n",
        "  const int ring_keys = max(0, min(ring, wrap % p.window));\n",
        "flash ring: ring tiles past the cursor's slot skipped after the "
        "wrap too"),
    "ssd_drop_carry": (
        "ssd", "ssd.cu", "      const float decay = ecum[Q - 1];\n",
        "      const float decay = 0.0f * ecum[Q - 1];\n",
        "SSD (tensor cores): the state carried into a chunk is dropped "
        "from the next state"),
    "ssd_drop_score_tile": (
        "ssd", "ssd.cu",
        "    for (int cb = 0; cb <= rt; ++cb) {\n",
        "    for (int cb = 0; cb <= rt; ++cb) {\n"
        "      if (rt == 5 && cb == 4) continue;\n",
        "SSD (tensor cores): rows 80-95 of each chunk lose the score tile "
        "of columns 64-79, just below the diagonal"),
    "mamba2_decode_drop_h_da": (
        "mamba2_decode", "decode_fused.cu",
        "return __fadd_rn(__fmul_rn(hval, da), upd);",
        "return __fadd_rn(0.0f * da, upd);",
        "Mamba-2 decode: the new state drops h * exp(dt * A), "
        "h' = dt * B * x"),
    "scan1_drop_carry": (
        "scan1", "scan1.cu", "        if (lane == g0 + g) hc = carry;\n",
        "        if (lane == g0 + g) hc = it + 1 < tiles ? 0.0f : carry;\n",
        "selective scan: the state carried from one 256-step tile to the "
        "next is zeroed (the last tile's carry, the final state, is kept)"),
    "scan1_shuffle_off_by_one": (
        "scan1", "scan1.cu",
        "          const float qa = __shfl_up_sync(0xffffffffu, pa, off);\n"
        "          const float qb = __shfl_up_sync(0xffffffffu, pb, off);\n",
        "          const int src = off == 4 ? 5 : off;\n"
        "          const float qa = __shfl_up_sync(0xffffffffu, pa, src);\n"
        "          const float qb = __shfl_up_sync(0xffffffffu, pb, src);\n",
        "selective scan: the warp scan's third level combines the lane 5 "
        "below, not 4"),
    "flash_merge_drops_last_split": (
        "ring", "flash.cu",
        "        for (int sp = 0; sp < n_active; ++sp) {\n"
        "          const float* ml = w.part_ml + (tile0 + sp) * kWRows * 2;\n"
        "          const float* px",
        "        for (int sp = 0; sp < n_active - 1; ++sp) {\n"
        "          const float* ml = w.part_ml + (tile0 + sp) * kWRows * 2;\n"
        "          const float* px",
        "flash (wgmma, key splits): the merge leaves out the last split"),
    "flash_bwd_drops_last_group_head": (
        "backward", "flash_bwd.cu", "  for (int g = 0; g < G; ++g) {\n",
        "  for (int g = 0; g < G - (G > 1); ++g) {\n",
        "flash backward (CUDA cores: fp32): dK and dV of a KV head leave "
        "out the last query head of its group (GQA only)"),
    "flash_bwd_wgmma_drops_last_group_head": (
        "backward", "flash_bwd.cu", "  const int n_tiles = G * nq;",
        "  const int n_tiles = (G - (G > 1)) * nq;",
        "flash backward (wgmma: bf16): the dK/dV kernel's walk leaves out "
        "the last query head of its group (GQA only)"),
    "ssd_bwd_drops_state_carry": (
        "backward", "ssd_bwd.cu",
        "          acc[r][c] = elast * dh[(ty + 16 * r) * N + tx + 16 * c];\n",
        "          acc[r][c] = 0.0f * dh[(ty + 16 * r) * N + tx + 16 * c];\n",
        "SSD backward (CUDA cores: fp32): the state gradient carried into "
        "the chunk before drops e^cum_last dh'"),
    "ssd_bwd_state_pass_drops_carry": (
        "backward", "ssd_bwd.cu", "      const float e = el[c0 + r];\n",
        "      const float e = 0.0f * el[c0 + r];\n",
        "SSD backward (tensor cores: bf16): the state pass drops the carry "
        "e^cum_last dh', so dh'(c-1) = U(c)"),
    "scan1_bwd_drops_chunk_dA": (
        "backward", "scan1_bwd.cu",
        "          dprev[g] = fmaf(dtv[i], w, dprev[g]);\n",
        "          if (it != 1) dprev[g] = fmaf(dtv[i], w, dprev[g]);\n",
        "selective-scan backward: dA leaves out the second tile's share "
        "(steps 256-511)"),
    "scan1_bwd_drops_tile_carry": (
        "backward", "scan1_bwd.cu",
        "        if (lane == g0 + g) gc = out;\n",
        "        if (lane == g0 + g) gc = 0.0f * out;\n",
        "selective-scan backward: the gradient's carry into each tile from "
        "the one above is zeroed"),
    "scan1_bwd_drops_warp_share": (
        "backward", "scan1_bwd.cu",
        "        for (int i = 0; i < kH; ++i) sum[i] = red[at + i];\n",
        "        for (int i = 0; i < kH; ++i) sum[i] = 0.0f * red[at + i];\n",
        "selective-scan backward: the block's dB / dC sum leaves out its "
        "first warp's channel"),
    "flash_bwd_window_off_by_one": (
        "backward", "flash_bwd.cu",
        "           (window <= 0 || i - j < window);\n",
        "           (window <= 0 || i - j <= window);\n",
        "flash backward, window: the band takes one key too many, i - j = "
        "window"),
    "flash_bwd_noncausal_no_key_mask": (
        "backward", "flash_bwd.cu",
        "    return i < S && j < S && (!causal || j <= i) &&\n",
        "    return i < S && (causal || j < S) && (!causal || j <= i) &&\n",
        "flash backward, non-causal: keys past S are not masked"),
    "flash_bwd_noncausal_drops_last_key_tile": (
        "backward", "flash_bwd.cu",
        "    hi = causal ? min(n, (q0 + qn - 1) / tr + 1) : n;\n",
        "    hi = causal ? min(n, (q0 + qn - 1) / tr + 1) : n - 1;\n",
        "flash backward, non-causal: dQ's walk leaves out the last key "
        "tile"),
    "conv1d_bwd_drops_tap_0": (
        "backward", "conv1d_bwd.cu",
        "            float acc = dz[e] * wk[e][0];\n",
        "            float acc = 0.0f * wk[e][0];\n",
        "conv1d backward: dx leaves out tap 0"),
    "flash_qk_one_kstep_short": (
        "attention", "flash.cu",
        "      for (int kk = 0; kk < D / 16; ++kk) {\n"
        "        const uint64_t da = repro::wgmma_desc(\n            q_addr",
        "      for (int kk = 0; kk < D / 16 - 1; ++kk) {\n"
        "        const uint64_t da = repro::wgmma_desc(\n            q_addr",
        "flash (wgmma): Q K^T walks one k-step short of d / 16 (d = 80: "
        "dims 64-79 left out)"),
}


def attention_readings(cs, torch, gen) -> dict:
    from repro_torch.kernels.attn_decode import ops as dec_ops
    from repro_torch.kernels.attn_decode import ref as dec_ref
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref

    out = {}

    def reading(key, got, want, tol):
        out[key] = dict(
            ratio=cs.row_ratio(got, want, tol),
            old_ratio=cs.whole_ratio(got, want, tol),
            max_abs_err=float((got.float() - want.float()).abs().max()))

    for label, h, kvh, d, bucket, offs, lens in cs.attention_cases():
        for dt in (torch.bfloat16, torch.float32):
            tol = cs.TOL["attention"][dt]
            q, k, v, qd = cs.attention_inputs(gen, h, kvh, d, bucket, dt)
            off = torch.tensor(offs, dtype=torch.int32, device="cuda")
            vl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            reading(f"flash {label} {str(dt)[6:]}",
                    flash_ops.flash_attention(q, k, v, q_offset=off),
                    flash_ref.attention_ref(q, k, v, q_offset=off), tol)
            reading(f"decode {label} {str(dt)[6:]}",
                    dec_ops.decode_attention(qd, k, v, valid_len=vl),
                    dec_ref.decode_attention_ref(qd, k, v, valid_len=vl),
                    tol)
    loc = cs.LOCAL_DECODE
    for dt in (torch.bfloat16, torch.float32):
        def rn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)
        k, v = (rn(cs.B_ATTN, loc["ring"], loc["KVH"], loc["d"]).transpose(
            1, 2) for _ in range(2))
        qd = rn(cs.B_ATTN, loc["H"], loc["d"])
        vl = torch.tensor(loc["valid"], dtype=torch.int32, device="cuda")
        reading(f"decode gemma3-1b local {str(dt)[6:]}",
                dec_ops.decode_attention(qd, k, v, valid_len=vl),
                dec_ref.decode_attention_ref(qd, k, v, valid_len=vl),
                cs.TOL["attention"][dt])
    return out


def mamba1_decode_readings(cs, torch, gen) -> dict:
    from repro_torch.configs import mamba_130m as cfg
    from repro_torch.kernels.decode_fused import ops as dec_ops
    from repro_torch.kernels.decode_fused import ref as dec_ref
    from repro_torch.models.mamba1 import dt_rank

    s = cfg.ssm
    b, c, n, k = 4, s.d_inner(cfg.d_model), s.d_state, s.conv_kernel
    r = dt_rank(cfg.d_model, s)
    kw = dict(d_state=n, dt_rank=r)

    def unscaled(dt):
        def rn(*shape, dtype=torch.float32):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)
        return (rn(b, k - 1, c, dtype=dt), rn(b, c, n), rn(b, c, dtype=dt),
                rn(c, k), rn(c), rn(c, r + 2 * n, dtype=dt),
                rn(r, c, dtype=dt), rn(c), rn(c, n), rn(c))

    def worst(args, tol):
        got = dec_ops.mamba1_decode_fused(*args, **kw)
        want = dec_ref.mamba1_decode_fused_ref(*args, **kw)
        return (max(cs.whole_ratio(g, w, tol) for g, w in zip(got, want)),
                cs.max_err(got, want))

    out = {}
    for dt in (torch.bfloat16, torch.float32):
        tol = cs.TOL["decode_fused"][dt]
        ratio, err = worst(cs.mamba1_decode_inputs(gen, b, c, n, r, k, dt),
                           tol)
        old_ratio, _ = worst(unscaled(dt), tol)
        out[f"mamba1_decode {cfg.name} {str(dt)[6:]}"] = dict(
            ratio=ratio, old_ratio=old_ratio, max_abs_err=err)
    return out


def conv1d_readings(cs, torch, gen) -> dict:
    """causal conv1d at B=4, S=256 and the channel counts of
    ``chip_smoke.conv_shapes``, and on six rows with valid lengths 0, 1,
    2, K-1, 200 and S: ``ratio`` the worst of y's whole-tensor limit and
    the new state's bit-equality (0 if equal, else inf), ``old_ratio``
    y's limit alone without lengths."""
    from repro_torch.kernels.conv1d import ops, ref

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    out = {}
    for label, c in cs.conv_shapes():
        for dt in (torch.bfloat16, torch.float32):
            tol = cs.TOL["conv1d"][dt]
            w, b = rn(c, 4), rn(c)
            x, st = rn(4, 256, c, dtype=dt), rn(4, 3, c, dtype=dt)
            lens = torch.tensor([0, 1, 2, 3, 200, 256], dtype=torch.int32,
                                device="cuda")
            xl, stl = rn(6, 256, c, dtype=dt), rn(6, 3, c, dtype=dt)
            ratios = []
            for args, kw in (((x, w, b), dict(initial_state=st)),
                             ((xl, w, b), dict(initial_state=stl,
                                               lengths=lens))):
                (y, s_), (wy, ws) = (ops.causal_conv1d(*args, **kw),
                                     ref.causal_conv1d_ref(*args, **kw))
                ratios.append((cs.whole_ratio(y, wy, tol),
                               0.0 if torch.equal(s_, ws) else float("inf"),
                               float((y.float() - wy.float()).abs().max())))
            out[f"conv1d {label} {str(dt)[6:]}"] = dict(
                ratio=max(max(r[:2]) for r in ratios),
                old_ratio=ratios[0][0],
                max_abs_err=max(r[2] for r in ratios))
    return out


def ring_readings(cs, torch, gen) -> dict:
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref

    b, h, kvh, d, w = (cs.RING[k] for k in ("B", "H", "KVH", "d", "window"))
    out = {}
    for label, ring_len, sq, wraps in cs.ring_cases():
        for dt in (torch.bfloat16, torch.float32):
            def rn(*shape):
                return torch.randn(shape, generator=gen,
                                   device="cuda").to(dt)
            q = rn(b, sq, h, d).transpose(1, 2)
            k, v = (rn(b, ring_len + sq, kvh, d).transpose(1, 2)
                    for _ in range(2))
            wrap = torch.tensor(wraps, dtype=torch.int32, device="cuda")
            kw = dict(causal=True, window=w, q_offset=wrap, kv_wrap=wrap,
                      ring_len=ring_len)
            got = flash_ops.flash_attention(q, k, v, **kw)
            want = flash_ref.attention_ref(q, k, v, **kw)
            tol = cs.TOL["attention"][dt]
            out[f"ring {label} {str(dt)[6:]}"] = dict(
                ratio=cs.row_ratio(got, want, tol),
                old_ratio=cs.whole_ratio(got, want, tol),
                max_abs_err=float((got.float() - want.float()).abs().max()))
    return out


def ssd_readings(cs, torch, gen) -> dict:
    from repro_torch.configs import mamba2_2p7b, zamba2_2p7b
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    out = {}
    for cfg in (mamba2_2p7b, zamba2_2p7b):
        s = cfg.ssm
        b, h, p, n, q = 4, s.n_ssm_heads(cfg.d_model), s.headdim, \
            s.d_state, s.chunk
        for dt in (torch.bfloat16, torch.float32):
            tol = cs.TOL["ssd"][dt]
            args, h0 = ssd_ref.model_scale_inputs(gen, b, 16 * q, h, p, n,
                                                  dt)
            got = ssd_ops.ssd_chunked(*args, chunk=q, initial_state=h0)
            want = ssd_ref.ssd_chunked_ref(*args, chunk=q, initial_state=h0)
            ratio = max(cs.whole_ratio(got[0], want[0], tol),
                        cs.whole_ratio(got[1], want[1], tol),
                        cs.row_ratio(got[0], want[0], tol))
            err = cs.max_err(got, want)
            del args, h0, got, want

            def rn(*shape, dtype=torch.float32):
                return torch.randn(shape, generator=gen,
                                   device="cuda").to(dtype)
            old = (rn(b, 2 * q, h, p, dtype=dt),
                   ssd_ref.softplus(rn(b, 2 * q, h) - 2.0),
                   -torch.exp(rn(h)), rn(b, 2 * q, 1, n, dtype=dt),
                   rn(b, 2 * q, 1, n, dtype=dt), rn(h))
            h0 = rn(b, h, p, n)
            got = ssd_ops.ssd_chunked(*old, chunk=q, initial_state=h0)
            want = ssd_ref.ssd_chunked_ref(*old, chunk=q, initial_state=h0)
            out[f"ssd {cfg.name} {str(dt)[6:]}"] = dict(
                ratio=ratio, old_ratio=max(cs.whole_ratio(g, w, tol)
                                           for g, w in zip(got, want)),
                max_abs_err=err)
    return out


def mamba2_decode_readings(cs, torch, gen) -> dict:
    from repro_torch.configs import mamba2_2p7b, zamba2_2p7b
    from repro_torch.kernels.decode_fused import ops as dec_ops
    from repro_torch.kernels.decode_fused import ref as dec_ref

    out = {}
    for cfg in (mamba2_2p7b, zamba2_2p7b):
        s = cfg.ssm
        b, h, p, g, n, k = (4, s.n_ssm_heads(cfg.d_model), s.headdim,
                            s.n_groups, s.d_state, s.conv_kernel)
        kw = dict(n_groups=g, d_state=n, headdim=p)
        c = h * p + 2 * g * n

        def unscaled(dt):
            def rn(*shape, dtype=torch.float32):
                return torch.randn(shape, generator=gen,
                                   device="cuda").to(dtype)
            return (rn(b, k - 1, c, dtype=dt), rn(b, h, p, n),
                    rn(b, c, dtype=dt), rn(c, k), rn(c), rn(b, h, dtype=dt),
                    rn(h), rn(h), rn(h))

        def worst(args, tol):
            got = dec_ops.mamba2_decode_fused(*args, **kw)
            want = dec_ref.mamba2_decode_fused_ref(*args, **kw)
            return (max(cs.whole_ratio(gg, ww, tol)
                        for gg, ww in zip(got, want)),
                    cs.max_err(got, want))
        for dt in (torch.bfloat16, torch.float32):
            tol = cs.TOL["decode_fused"][dt]
            ratio, err = worst(cs.mamba2_decode_inputs(gen, b, h, p, g, n, k,
                                                       dt), tol)
            old_ratio, _ = worst(unscaled(dt), tol)
            out[f"mamba2_decode {cfg.name} {str(dt)[6:]}"] = dict(
                ratio=ratio, old_ratio=old_ratio, max_abs_err=err)
    return out


def scan1_readings(cs, torch, gen) -> dict:
    """The selective scan at mamba-130m's width on inputs at the model's
    scales (``scan1.ref.model_scale_inputs``): B=4, S=256 (a served
    chunk, one tile), B=4, S=1000 and B=1, S=4133 (many tiles, the last
    one partial).  ``ratio`` is chip_smoke.py's check (``scan_ratio``: y
    within its limit of max |y|, the state allclose), ``old_ratio`` the
    same on the unscaled draws of B=4, S=256 it replaced (dt =
    softplus(normal - 2), A = -exp(normal): one tile, and a state that
    decays within a few steps)."""
    from repro_torch.configs import mamba_130m as cfg
    from repro_torch.kernels.scan1 import ops, ref
    from repro_torch.kernels.ssd.ref import softplus

    c, n = cfg.ssm.d_inner(cfg.d_model), cfg.ssm.d_state
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        def rn(*shape, dtype=torch.float32):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)
        old = (rn(4, 256, c, dtype=dt), softplus(rn(4, 256, c) - 2.0),
               -torch.exp(rn(c, n)), rn(4, 256, n, dtype=dt),
               rn(4, 256, n, dtype=dt), rn(c), rn(4, c, n))
        old_ratio = cs.scan_ratio(
            ops.selective_scan(*old[:6], initial_state=old[6]),
            ref.selective_scan_ref(*old), dt)
        for b, s in ((4, 256), (4, 1000), (1, 4133)):
            args, h0 = ref.model_scale_inputs(gen, b, s, c, n, dt)
            got = ops.selective_scan(*args, initial_state=h0)
            want = ref.selective_scan_ref(*args, h0)
            out[f"scan1 B={b} S={s} {str(dt)[6:]}"] = dict(
                ratio=cs.scan_ratio(got, want, dt), old_ratio=old_ratio,
                max_abs_err=cs.max_err(got, want))
    return out


def backward_readings(cs, torch, gen) -> dict:
    """The backward kernels against their plain backwards at
    ``chip_smoke.BWD_CHECKS`` (zamba2-2.7b's SSD, conv1d and flash,
    smollm-135m's flash, mamba-130m's scan and conv1d, gemma3-1b's flash
    in its window and causal at d = 256, hubert-xlarge's non-causal
    flash), bf16 and fp32: ``ratio`` is chip_smoke.py's check, the worst
    gradient's ``whole_ratio`` to ``BWD_TOL`` of its own max |g| (inf
    when two calls differ); ``old_ratio`` the same (no check preceded
    it)."""
    tiny = torch.finfo(torch.float32).tiny
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        for name, b, s in cs.BWD_CHECKS:
            kern, plain, *_ = cs.bwd_cases(gen, dt, b, s, (name,))[name]
            got, again, want = kern(), kern(), plain()
            ratio = max(cs.whole_ratio(g, w, cs.BWD_TOL[dt], floor=tiny)
                        for g, w in zip(got, want))
            if not all(torch.equal(g, g2) for g, g2 in zip(got, again)):
                ratio = float("inf")
            out[f"{name} {str(dt)[6:]}"] = dict(
                ratio=ratio, old_ratio=ratio,
                max_abs_err=cs.max_err(got, want))
    return out


CHECKS = {"attention": attention_readings,
          "mamba1_decode": mamba1_decode_readings,
          "conv1d": conv1d_readings,
          "ring": ring_readings,
          "ssd": ssd_readings,
          "mamba2_decode": mamba2_decode_readings,
          "scan1": scan1_readings,
          "backward": backward_readings}
# how far past its limit a mutant of a check must land (1 where unlisted)
MUST_FAIL_BY = {"scan1": 10.0}
# mutants of a kernel whose one route serves both types: each type's
# readings must fail on their own
BOTH_TYPES = {"scan1_bwd_drops_chunk_dA", "scan1_bwd_drops_tile_carry",
              "scan1_bwd_drops_warp_share"}
# mutants whose fault no input can show, kept to hold why: their
# readings must equal the unchanged kernels' exactly
EXPECT_EQUAL = {
    "flash_bwd_noncausal_no_key_mask":
        "TMA and the CUDA-core loads fill the K and V rows past S with "
        "zeros, so a stray P there multiplies zeros in dQ and only feeds "
        "the dK, dV rows past S, which are never written"}


def child(checks) -> int:
    """Run ``checks`` (all when empty) on the package first on
    ``sys.path``."""
    import torch

    sys.path.insert(1, ROOT)
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for check in checks or CHECKS:
        out[check] = CHECKS[check](
            cs, torch, torch.Generator(device="cuda").manual_seed(0))
    print(json.dumps(out))
    return 0


def run_one(name: str, mutant) -> dict:
    """Build ``name``'s copy and run its kernel's check (every check for
    the unchanged sources)."""
    base = os.path.join(ROOT, "build", "mutants", name)
    shutil.rmtree(base, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                    os.path.join(base, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    if mutant is not None:
        _, src, old, new, _ = mutant
        path = os.path.join(base, "src", CSRC, src)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the text to replace is not found "
                               f"exactly once in {src}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    env = dict(os.environ, PYTHONPATH=os.path.join(base, "src"))
    checks = [] if mutant is None else [mutant[0]]
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--child", *checks], env=env, capture_output=True,
                         text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"{name}: child failed\n{res.stdout}\n"
                           f"{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(names) -> int:
    unknown = set(names) - set(MUTANTS)
    if unknown:
        sys.exit(f"no such mutant: {sorted(unknown)}")
    failed = []
    for name, mutant in MUTANTS.items():
        if names and mutant is not None and name not in names:
            continue
        readings = run_one(name, mutant)
        what = "no edit" if mutant is None else mutant[4]
        print(f"{name} ({what}): {json.dumps(readings)}", flush=True)
        if mutant is None:
            unchanged = readings
            for check, rs in readings.items():
                if max(r["ratio"] for r in rs.values()) > 1.0:
                    failed.append(f"{name}: unchanged kernels fail the "
                                  f"{check} check")
        elif name in EXPECT_EQUAL:
            if readings[mutant[0]] != unchanged[mutant[0]]:
                failed.append(f"{name}: its readings differ from the "
                              f"unchanged kernels' ({EXPECT_EQUAL[name]})")
        else:
            rs = readings[mutant[0]]
            groups = ([[r for k, r in rs.items() if k.endswith(t)]
                       for t in ("bfloat16", "float32")]
                      if name in BOTH_TYPES else [list(rs.values())])
            if any(max(r["ratio"] for r in g) <= MUST_FAIL_BY.get(
                    mutant[0], 1.0) for g in groups):
                failed.append(f"{name}: the {mutant[0]} check passes this "
                              f"mutant (in one type, where both must "
                              f"fail), or fails it by less than "
                              f"{MUST_FAIL_BY.get(mutant[0], 1.0)}x")
    for line in failed:
        print("FAIL " + line)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(child(sys.argv[2:]) if sys.argv[1:2] == ["--child"]
             else main(sys.argv[1:]))
