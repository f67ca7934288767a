"""Time variants of the flash kernel's, the SSD scan's or the Mamba-2
decode step's source against each other on one card.

    python3 scripts/kernel_variants.py SET [--micro]

SET names a set in ``SETS`` below, or a JSON file of the same form:
``{"variant": [["file in csrc/", "text", "replacement"], ...], ...}`` (a
path such as ``../ssd/ops.py`` reaches a wrapper beside ``csrc/``); a
variant with no edits is the source as it stands. Needs an NVIDIA card
and ``nvcc``. Each variant is a copy of ``src/repro_torch`` under
``build/variants/<name>/`` (listed in .gitignore) with its edits
applied, so the repository's sources are never edited; a child process
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
``chip_smoke.mamba2_decode_inputs``. Each variant's kernels that ptxas
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

SETS = {
    # K/V pipeline depth of the d=128 instance
    "stages": {
        "3 stages": [],
        "4 stages": [["flash.cu",
                      "static constexpr int kStages = kDP > 128 ? 2 : 3;",
                      "static constexpr int kStages = kDP > 128 ? 2 : 4;"]],
    },
    # what each part of a tile costs: drop a product or the exponentials
    "breakdown": {
        "as is": [],
        "no S": [["flash.cu", "        repro::wgmma_ss_n64(s, da, db, 1);",
                  "        (void)da; (void)db;"]],
        "no PV": [["flash.cu",
                   "        wgmma_pv<DP>(o, pa[kk],\n"
                   "                    repro::wgmma_desc(v_addr + kk * 2048,"
                   " kWK * 128, 1024));",
                   "        (void)pa[kk];"]],
        "no exp": [["flash.cu",
                    "          s[4 * n + e] = exp2f(s[4 * n + e] - mn0);\n"
                    "          s[4 * n + 2 + e] = exp2f(s[4 * n + 2 + e] - "
                    "mn1);",
                    "          s[4 * n + e] = s[4 * n + e] - mn0;\n"
                    "          s[4 * n + 2 + e] = s[4 * n + 2 + e] - mn1;"]],
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
}


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


def run_variant(name: str, edits, micro: bool, kind: str):
    base = os.path.join(ROOT, "build", "variants", name.replace(" ", "_"))
    shutil.rmtree(base, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                    os.path.join(base, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for src, old, new in edits:
        path = os.path.join(base, "src", CSRC, src)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the text to replace is not found "
                               f"exactly once in {src}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    env = dict(os.environ, PYTHONPATH=os.path.join(base, "src"))
    flag = {"ssd": ["--ssd"], "decode": ["--decode"]}.get(
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


def main(spec: str, micro: bool) -> int:
    if spec in SETS:
        variants = SETS[spec]
    else:
        with open(spec) as f:
            variants = json.load(f)
    names = list(variants)
    kind = ("ssd" if spec.startswith("ssd") else
            "decode" if spec.startswith("mamba2_decode") else "flash")
    times, ratios = {}, {}
    for i, name in enumerate(names + names[::-1]):
        res, spilled = run_variant(name, variants[name], micro, kind)
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
    if args == ["--child", "--ssd"]:
        sys.exit(ssd_child())
    if args == ["--child", "--decode"]:
        sys.exit(decode_child())
    if args == ["--child"]:
        sys.exit(child(micro))
    if len(args) != 1:
        sys.exit(__doc__)
    sys.exit(main(args[0], micro))
