"""Hold the attention kernels of this checkout against another tree's, on
one card: each tree's outputs within the plain version's per-row limit,
the largest difference between the trees, and their device times.

    python3 scripts/ab_kernels.py OTHER_TREE

OTHER_TREE is the root of another checkout of the repository (for
example the parent commit unpacked with ``git archive`` into a directory
that .gitignore lists).  Needs an NVIDIA card and ``nvcc``.  Each tree
runs in a child process of its own, in the order other, this, this,
other, with its own ``src/`` first on ``sys.path`` and its kernels built
into its own ``build/repro_torch/``.  A child draws the inputs of
``chip_smoke.attention_cases``, ``chip_smoke.ring_cases`` and
``chip_smoke.LOCAL_DECODE`` (this checkout's ``chip_smoke.py``) from one
seed, runs the flash and decode kernels on them in bf16 and fp32 (the
ring cases in bf16), and saves the outputs, the plain versions' outputs
and the device times (``chip_smoke.device_ms``).  The cases are those
whose head_dim both trees take.  Prints one JSON line per case: each
run's worst row over chip_smoke's per-row limit (``row_ratio``, 1 is the
limit), the largest difference between any two runs, and each run's
time.  Exits 1 if any run passes its limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cases(cs, torch, flash_ops, dec_ops):
    """(key, dtype, fn of a generator -> (kernel call, plain call))."""
    from repro_torch.kernels.attn_decode import ref as dec_ref
    from repro_torch.kernels.flash import ref as flash_ref

    out = []
    for label, h, kvh, d, bucket, offs, lens in cs.attention_cases():
        if d not in flash_ops.HEAD_DIMS or d not in dec_ops.HEAD_DIMS:
            continue
        for dt in (torch.bfloat16, torch.float32):
            def make(gen, h=h, kvh=kvh, d=d, bucket=bucket, offs=offs,
                     lens=lens, dt=dt):
                q, k, v, qd = cs.attention_inputs(gen, h, kvh, d, bucket, dt)
                off = torch.tensor(offs, dtype=torch.int32, device="cuda")
                vl = torch.tensor(lens, dtype=torch.int32, device="cuda")
                return {
                    "flash": (lambda: flash_ops.flash_attention(
                        q, k, v, q_offset=off),
                        lambda: flash_ref.attention_ref(q, k, v,
                                                        q_offset=off)),
                    "decode": (lambda: dec_ops.decode_attention(
                        qd, k, v, valid_len=vl),
                        lambda: dec_ref.decode_attention_ref(
                            qd, k, v, valid_len=vl))}
            out.append((f"{label} {str(dt)[6:]}", dt, make))
    r = cs.RING
    b, h, kvh, d, w = r["B"], r["H"], r["KVH"], r["d"], r["window"]
    for label, ring_len, sq, wraps in cs.ring_cases():
        def make(gen, ring_len=ring_len, sq=sq, wraps=wraps):
            def rn(*shape):
                return torch.randn(shape, generator=gen,
                                   device="cuda").to(torch.bfloat16)
            q = rn(b, sq, h, d).transpose(1, 2)
            k, v = (rn(b, ring_len + sq, kvh, d).transpose(1, 2)
                    for _ in range(2))
            wrap = torch.tensor(wraps, dtype=torch.int32, device="cuda")
            kw = dict(causal=True, window=w, q_offset=wrap, kv_wrap=wrap,
                      ring_len=ring_len)
            return {"flash": (
                lambda: flash_ops.flash_attention(q, k, v, **kw),
                lambda: flash_ref.attention_ref(q, k, v, **kw))}
        out.append((f"gemma3-1b {label} bfloat16", torch.bfloat16, make))
    loc = cs.LOCAL_DECODE
    for dt in (torch.bfloat16, torch.float32):
        def make(gen, dt=dt):
            def rn(*shape):
                return torch.randn(shape, generator=gen,
                                   device="cuda").to(dt)
            k, v = (rn(b, loc["ring"], loc["KVH"], loc["d"]).transpose(1, 2)
                    for _ in range(2))
            qd = rn(b, loc["H"], loc["d"])
            vl = torch.tensor(loc["valid"], dtype=torch.int32,
                              device="cuda")
            return {"decode": (
                lambda: dec_ops.decode_attention(qd, k, v, valid_len=vl),
                lambda: dec_ref.decode_attention_ref(qd, k, v,
                                                     valid_len=vl))}
        out.append((f"gemma3-1b local {str(dt)[6:]}", dt, make))
    return out


def child(out_path: str) -> int:
    import torch

    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels.attn_decode import ops as dec_ops
    from repro_torch.kernels.flash import ops as flash_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for label, dt, make in cases(cs, torch, flash_ops, dec_ops):
        runs = make(torch.Generator(device="cuda").manual_seed(0))
        for name, (fn, plain) in runs.items():
            out[f"{name} {label}"] = dict(
                o=fn().cpu(), want=plain().cpu(), ms=cs.device_ms(fn),
                tol=cs.TOL["attention"][dt])
    torch.save(out, out_path)
    return 0


def run_tree(tree: str, out_path: str) -> dict:
    import torch

    env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--child", out_path], env=env,
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(f"{tree}: child failed\n{res.stdout}\n"
                           f"{res.stderr}")
    return torch.load(out_path)


def main(other: str) -> int:
    import torch

    sys.path.insert(1, ROOT)
    from chip_smoke import row_ratio

    trees = [("other", os.path.abspath(other)), ("this", ROOT),
             ("this", ROOT), ("other", os.path.abspath(other))]
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, tree) in enumerate(trees):
            results.append((name, run_tree(tree, os.path.join(
                tmp, f"{i}.pt"))))
    failed = False
    for key in results[0][1]:
        runs = [r[key] for _, r in results]
        ratios = [row_ratio(r["o"], r["want"], r["tol"]) for r in runs]
        failed |= not all(x <= 1.0 for x in ratios)
        diff = max(float((a["o"].float() - b["o"].float()).abs().max())
                   for a in runs for b in runs)
        print(json.dumps({"case": key, "worst_row_of_limit": [
            [name, x] for (name, _), x in zip(results, ratios)],
            "max_abs_diff_between_runs": diff,
            "ms": [[name, r[key]["ms"]] for name, r in results]}))
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2]))
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
