"""Time variants of the flash kernel's source against each other on one
card.

    python3 scripts/kernel_variants.py SET [--micro]

SET names a set in ``SETS`` below, or a JSON file of the same form:
``{"variant": [["file in csrc/", "text", "replacement"], ...], ...}``; a
variant with no edits is the source as it stands.  Needs an NVIDIA card
and ``nvcc``.  Each variant is a copy of ``src/repro_torch`` under
``build/variants/<name>/`` (listed in .gitignore) with its edits applied,
so the repository's sources are never edited; a child process builds it
and times the flash kernel (``chip_smoke.device_ms``) at the bf16 shapes
of ``chip_smoke.attention_cases`` that run on ``wgmma`` (llama3-8b,
gemma3-1b) and ``chip_smoke.ring_cases``, or with ``--micro`` at one
compute-bound shape (4224 queries of 4 heads over one KV head, no mask,
132 blocks sharing K/V through L2, d=128 and 256, 1024 and 4096 keys).
The variants run in turn, then again in reverse order; each case prints
every variant's two times.  An output past chip_smoke's per-row limit
prints WRONG (a variant that drops a product is wrong on purpose).
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
                      "static constexpr int kStages = D > 128 ? 2 : 3;",
                      "static constexpr int kStages = D > 128 ? 2 : 4;"]],
    },
    # what each part of a tile costs: drop a product or the exponentials
    "breakdown": {
        "as is": [],
        "no S": [["flash.cu", "        repro::wgmma_ss_n64(s, da, db, 1);",
                  "        (void)da; (void)db;"]],
        "no PV": [["flash.cu",
                   "        wgmma_pv<D>(o, pa[kk],\n"
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
}


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
            if d not in ops.WGMMA_HEAD_DIMS:
                continue
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


def run_variant(name: str, edits, micro: bool):
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
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--child"] + (["--micro"] if micro else []),
                         env=env, capture_output=True, text=True,
                         timeout=900)
    if res.returncode:
        raise RuntimeError(f"{name}: child failed\n{res.stdout}\n"
                           f"{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(spec: str, micro: bool) -> int:
    if spec in SETS:
        variants = SETS[spec]
    else:
        with open(spec) as f:
            variants = json.load(f)
    names = list(variants)
    times = {}
    for name in names + names[::-1]:
        for key, (ratio, ms) in run_variant(name, variants[name],
                                            micro).items():
            times.setdefault(key, {}).setdefault(name, []).append(ms)
            if ratio > 1.0:
                print(f"WRONG {name} {key}: {ratio} x the per-row limit")
    for key, by_name in times.items():
        print(json.dumps({"case": key, "ms": by_name}))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    micro = "--micro" in args
    args = [a for a in args if a != "--micro"]
    if args == ["--child"]:
        sys.exit(child(micro))
    if len(args) != 1:
        sys.exit(__doc__)
    sys.exit(main(args[0], micro))
