"""Show that chip_smoke.py's attention check catches a kernel that is wrong
only on long rows.

    python3 scripts/attention_mutants.py

Needs an NVIDIA card and ``nvcc``.  For the unchanged sources and for each
mutant below, it copies ``src/repro_torch`` into ``build/mutants/<name>/``
(listed in .gitignore), applies the mutant's edit to one kernel source
there, and in a child process builds that copy and compares its flash and
decode kernels with their plain versions on zamba2-2.7b's shapes, the
inputs of ``chip_smoke.phase_attention``.  For each comparison it prints
the error over the limit of the per-row check that chip_smoke.py applies
(``row_ratio``) and of the whole-tensor check it replaced
(``whole_ratio``: 2e-2 of max(1, max |o|) in bf16); 1 is the limit.
Exits 1 if the unchanged kernels fail the per-row check or a mutant
passes it.  The repository's own sources are never edited.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("repro_torch", "kernels", "csrc")

# name -> (kernel source, text to replace, replacement, what it breaks)
MUTANTS = {
    "unchanged": None,
    "flash_drop_tile_17": (
        "flash.cu", "  bool ok = key < p.Skv;\n",
        "  bool ok = key < p.Skv && !(qpos >= 1024 && key / 64 == 17);\n",
        "flash: queries at positions >= 1024 lose KV tile 17 (keys "
        "1088-1151)"),
    "decode_drop_tile_1024": (
        "attn_decode.cu", "    const bool live = k0 + lane < hi;\n",
        "    const bool live = k0 + lane < hi && k0 != 1024;\n",
        "decode: rows with more than 1024 valid keys lose keys 1024-1055"),
    "flash_drop_4_keys": (
        "flash.cu", "  bool ok = key < p.Skv;\n",
        "  bool ok = key < p.Skv && !(qpos >= 1536 && key >= 1536 && "
        "key < 1540);\n",
        "flash: queries at positions >= 1536 lose keys 1536-1539"),
    "decode_drop_4_keys": (
        "attn_decode.cu", "    const bool live = k0 + lane < hi;\n",
        "    const bool live = k0 + lane < hi && (k0 + lane < 1536 || "
        "k0 + lane >= 1540);\n",
        "decode: rows with more than 1536 valid keys lose keys 1536-1539"),
}


def child() -> int:
    """Compare the kernels of the package first on ``sys.path``."""
    import torch

    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels.attn_decode import ops as dec_ops
    from repro_torch.kernels.attn_decode import ref as dec_ref
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    label, h, kvh, d, bucket, offs, lens = cs.attention_cases()[0]
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        tol = cs.TOL["attention"][dt]
        q, k, v, qd = cs.attention_inputs(gen, h, kvh, d, bucket, dt)
        off = torch.tensor(offs, dtype=torch.int32, device="cuda")
        vl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        pairs = {
            "flash": (flash_ops.flash_attention(q, k, v, q_offset=off),
                      flash_ref.attention_ref(q, k, v, q_offset=off)),
            "decode": (dec_ops.decode_attention(qd, k, v, valid_len=vl),
                       dec_ref.decode_attention_ref(qd, k, v, valid_len=vl)),
        }
        for name, (got, want) in pairs.items():
            out[f"{name} {label} {str(dt)[6:]}"] = dict(
                row_ratio=cs.row_ratio(got, want, tol),
                whole_ratio=cs.whole_ratio(got, want, tol),
                max_abs_err=float((got.float() - want.float()).abs().max()))
    print(json.dumps(out))
    return 0


def run_one(name: str, mutant) -> dict:
    base = os.path.join(ROOT, "build", "mutants", name)
    shutil.rmtree(base, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                    os.path.join(base, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    if mutant is not None:
        src, old, new, _ = mutant
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
                          "--child"], env=env, capture_output=True,
                         text=True, timeout=600)
    if res.returncode:
        raise RuntimeError(f"{name}: child failed\n{res.stdout}\n"
                           f"{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    failed = []
    for name, mutant in MUTANTS.items():
        readings = run_one(name, mutant)
        what = "no edit" if mutant is None else mutant[3]
        print(f"{name} ({what}): {json.dumps(readings)}", flush=True)
        worst = max(r["row_ratio"] for r in readings.values())
        if mutant is None and worst > 1.0:
            failed.append(f"{name}: unchanged kernels fail the per-row check")
        if mutant is not None and worst <= 1.0:
            failed.append(f"{name}: the per-row check passes this mutant")
    for line in failed:
        print("FAIL " + line)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(child() if sys.argv[1:] == ["--child"] else main())
