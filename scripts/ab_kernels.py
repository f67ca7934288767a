"""Hold the attention kernels of this checkout against another tree's, on
one card: the same outputs, bit for bit, and their device times.

    python3 scripts/ab_kernels.py OTHER_TREE

OTHER_TREE is the root of another checkout of the repository (for
example the parent commit unpacked with ``git archive`` into a directory
that .gitignore lists).  Needs an NVIDIA card and ``nvcc``.  Each tree
runs in a child process of its own, in the order other, this, this,
other, with its own ``src/`` first on ``sys.path`` and its kernels built
into its own ``build/repro_torch/``.  A child draws the inputs of
``chip_smoke.attention_cases`` (this checkout's ``chip_smoke.py``) from
one seed, runs the flash and decode kernels on them in bf16 and fp32,
and saves the outputs and the device times (``chip_smoke.device_ms``).
The cases are those whose head_dim both trees take.  Prints one JSON
line per case: whether every run gave the same bits, and each run's
time.  Exits 1 if any output differs.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(out_path: str) -> int:
    import torch

    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels.attn_decode import ops as dec_ops
    from repro_torch.kernels.flash import ops as flash_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for label, h, kvh, d, bucket, offs, lens in cs.attention_cases():
        if d not in flash_ops.HEAD_DIMS or d not in dec_ops.HEAD_DIMS:
            continue
        for dt in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device="cuda").manual_seed(0)
            q, k, v, qd = cs.attention_inputs(gen, h, kvh, d, bucket, dt)
            off = torch.tensor(offs, dtype=torch.int32, device="cuda")
            vl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            runs = {
                "flash": lambda: flash_ops.flash_attention(q, k, v,
                                                           q_offset=off),
                "decode": lambda: dec_ops.decode_attention(qd, k, v,
                                                           valid_len=vl),
            }
            for name, fn in runs.items():
                key = f"{name} {label} {str(dt)[6:]}"
                out[key] = dict(o=fn().cpu(), ms=cs.device_ms(fn))
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

    trees = [("other", os.path.abspath(other)), ("this", ROOT),
             ("this", ROOT), ("other", os.path.abspath(other))]
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, tree) in enumerate(trees):
            results.append((name, run_tree(tree, os.path.join(
                tmp, f"{i}.pt"))))
    failed = False
    for key in results[0][1]:
        ref = results[0][1][key]["o"]
        same = all(torch.equal(r[key]["o"], ref) for _, r in results)
        failed |= not same
        print(json.dumps({"case": key, "bit_identical": same,
                          "ms": [[name, r[key]["ms"]]
                                 for name, r in results]}))
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2]))
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
