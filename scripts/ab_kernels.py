"""Hold the attention kernels, the SSD scan and the Mamba-2 decode step of
this checkout against another tree's, on one card: each tree's outputs
within chip_smoke.py's limits, the largest difference between the trees,
and their device times.

    python3 scripts/ab_kernels.py OTHER_TREE [--serving-pairs N]

OTHER_TREE is the root of another checkout of the repository (for
example the parent commit unpacked with ``git archive`` into a directory
that .gitignore lists).  Needs an NVIDIA card and ``nvcc``.  Each tree
runs in a child process of its own, in the order other, this, this,
other, with its own ``src/`` first on ``sys.path`` and its kernels built
into its own ``build/repro_torch/``.  A child draws the inputs of
``chip_smoke.attention_cases``, ``chip_smoke.ring_cases`` and
``chip_smoke.LOCAL_DECODE`` (this checkout's ``chip_smoke.py``) from one
seed, runs the flash and decode kernels on them in bf16 and fp32 (the
ring cases in bf16), runs the SSD scan (B=4, S=256) and the Mamba-2
decode step (B=4) at mamba2-2.7b's and zamba2-2.7b's shapes on inputs at
the model's scales (this checkout's ``ssd.ref.model_scale_inputs`` and
``chip_smoke.mamba2_decode_inputs``, so both trees get inputs drawn by
the same code) in bf16 and fp32, and saves the outputs, the plain
versions' outputs and the device times (``chip_smoke.device_ms``).
An attention kernel's cases are those whose head_dim both trees take.
Prints one JSON line per case: each run's worst output over chip_smoke's
limit (1 is the limit: ``row_ratio`` per attention row; for SSD the worst
of y's and the state's whole-tensor limits and y's per-row limit; for the
decode step the worst output's whole-tensor limit), the largest
difference between any two runs, and each run's time.  Then each child
serves mamba2-2.7b and zamba2-2.7b as phase 4 of chip_smoke.py does
(``chip_smoke.phase_serving``: full width and depth, 4 ragged requests,
the profiled decode burst and prefill chunk), and one JSON line per model
gives each run's TTFTs, decode rate, and the burst's and the chunk's
kernels, device memcpys and kernel-busy time.  Exits 1 if any run passes
its limit.

With ``--serving-pairs N`` only the serving runs are made, N rounds of
other, this, this, other (2N runs a tree), since host-bound rates move
from run to run: one JSON line per model and tree gives each run's
decode rate and TTFTs with their median, least and greatest.
"""
from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cases(cs, torch, flash_ops, dec_ops):
    """(key, check, fn of a generator -> {kernel: (kernel call, plain
    call)}); ``check`` names the limit (``CHECKS``) and its dtype."""
    from repro_torch.kernels.attn_decode import ref as dec_ref
    from repro_torch.kernels.flash import ref as flash_ref

    out = []
    for label, h, kvh, d, bucket, offs, lens in cs.attention_cases():
        for dt in (torch.bfloat16, torch.float32):
            def make(gen, h=h, kvh=kvh, d=d, bucket=bucket, offs=offs,
                     lens=lens, dt=dt):
                q, k, v, qd = cs.attention_inputs(gen, h, kvh, d, bucket, dt)
                off = torch.tensor(offs, dtype=torch.int32, device="cuda")
                vl = torch.tensor(lens, dtype=torch.int32, device="cuda")
                runs = {}
                if d in flash_ops.HEAD_DIMS:
                    runs["flash"] = (
                        lambda: flash_ops.flash_attention(q, k, v,
                                                          q_offset=off),
                        lambda: flash_ref.attention_ref(q, k, v,
                                                        q_offset=off))
                if d in dec_ops.HEAD_DIMS:
                    runs["decode"] = (
                        lambda: dec_ops.decode_attention(qd, k, v,
                                                         valid_len=vl),
                        lambda: dec_ref.decode_attention_ref(
                            qd, k, v, valid_len=vl))
                return runs
            out.append((f"{label} {str(dt)[6:]}", ("attention", dt), make))
    out += mamba2_cases(cs, torch)
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
        out.append((f"gemma3-1b {label} bfloat16",
                    ("attention", torch.bfloat16), make))
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
        out.append((f"gemma3-1b local {str(dt)[6:]}", ("attention", dt),
                    make))
    return out


def mamba2_cases(cs, torch):
    """The SSD scan (B=4, S=256) and the Mamba-2 decode step (B=4) at
    mamba2-2.7b's and zamba2-2.7b's shapes, inputs at the model's
    scales, through the call both trees take."""
    from repro_torch.configs import mamba2_2p7b, zamba2_2p7b
    from repro_torch.kernels.decode_fused import ops as m2_ops
    from repro_torch.kernels.decode_fused import ref as m2_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    draws = this_ssd_ref()
    out = []
    for cfg in (mamba2_2p7b, zamba2_2p7b):
        s = cfg.ssm
        h, p, g, n, k, q = (s.n_ssm_heads(cfg.d_model), s.headdim,
                            s.n_groups, s.d_state, s.conv_kernel, s.chunk)
        for dt in (torch.bfloat16, torch.float32):
            def make(gen, h=h, p=p, g=g, n=n, k=k, q=q, dt=dt):
                args, h0 = draws.model_scale_inputs(gen, 4, 2 * q, h, p, n,
                                                    dt)
                dargs = cs.mamba2_decode_inputs(gen, 4, h, p, g, n, k, dt)
                kw = dict(n_groups=g, d_state=n, headdim=p)
                return {
                    "ssd": (lambda: ssd_ops.ssd_chunked(
                        *args, chunk=q, initial_state=h0),
                        lambda: ssd_ref.ssd_chunked_ref(
                            *args, chunk=q, initial_state=h0)),
                    "mamba2_decode": (
                        lambda: m2_ops.mamba2_decode_fused(*dargs, **kw),
                        lambda: m2_ref.mamba2_decode_fused_ref(*dargs,
                                                               **kw))}
            out.append((f"{cfg.name} {str(dt)[6:]}", ("mamba2", dt), make))
    return out


def this_ssd_ref():
    """This checkout's ``repro_torch/kernels/ssd/ref.py`` (plain torch, no
    imports from the package), loaded by its path whichever tree is on
    ``sys.path``."""
    path = os.path.join(ROOT, "src", "repro_torch", "kernels", "ssd",
                        "ref.py")
    spec = importlib.util.spec_from_file_location("ab_ssd_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worst_of_limit(cs, kernel: str, dt, got, want) -> float:
    """chip_smoke.py's check of ``kernel``'s outputs, as the worst ratio
    to its limit (1 is the limit)."""
    if kernel == "ssd":
        tol = cs.TOL["ssd"][dt]
        return max(cs.whole_ratio(got[0], want[0], tol),
                   cs.whole_ratio(got[1], want[1], tol),
                   cs.row_ratio(got[0], want[0], tol))
    if kernel == "mamba2_decode":
        tol = cs.TOL["decode_fused"][dt]
        return max(cs.whole_ratio(g, w, tol) for g, w in zip(got, want))
    return cs.row_ratio(got[0], want[0], cs.TOL["attention"][dt])


def child(out_path: str, serving_only: bool) -> int:
    import torch

    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    from repro_torch.kernels.attn_decode import ops as dec_ops
    from repro_torch.kernels.flash import ops as flash_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    kernel_cases = [] if serving_only else cases(cs, torch, flash_ops,
                                                 dec_ops)
    for label, (_, dt), make in kernel_cases:
        runs = make(torch.Generator(device="cuda").manual_seed(0))
        for name, (fn, plain) in runs.items():
            got, want = as_list(fn()), as_list(plain())
            out[f"{name} {label}"] = dict(
                o=[t.cpu() for t in got], ms=cs.device_ms(fn),
                worst_of_limit=worst_of_limit(cs, name, dt, got, want))
    serving = {}
    from repro_torch.configs import mamba2_2p7b, zamba2_2p7b
    gen = torch.Generator(device="cuda").manual_seed(0)
    for cfg in (mamba2_2p7b, zamba2_2p7b):
        res, _ = cs.phase_serving(cfg, gen)
        torch.cuda.empty_cache()
        serving[cfg.name] = {k: res[k] for k in (
            "ttft_ms", "steady_b4_tokens_per_s", "profiled_decode_burst8_b4",
            "profiled_prefill_chunk_b4_s256")}
    torch.save({"kernels": out, "serving": serving}, out_path)
    return 0


def as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def run_tree(tree: str, out_path: str, serving_only: bool = False) -> dict:
    import torch

    env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--child", out_path]
                         + (["--serving-only"] if serving_only else []),
                         env=env, capture_output=True, text=True,
                         timeout=900)
    if res.returncode:
        raise RuntimeError(f"{tree}: child failed\n{res.stdout}\n"
                           f"{res.stderr}")
    return torch.load(out_path)


def main(other: str) -> int:
    trees = [("other", os.path.abspath(other)), ("this", ROOT),
             ("this", ROOT), ("other", os.path.abspath(other))]
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, tree) in enumerate(trees):
            results.append((name, run_tree(tree, os.path.join(
                tmp, f"{i}.pt"))))
    failed = False
    for key in results[0][1]["kernels"]:
        runs = [r["kernels"][key] for _, r in results]
        ratios = [r["worst_of_limit"] for r in runs]
        failed |= not all(x <= 1.0 for x in ratios)
        diff = max(float((x.float() - y.float()).abs().max())
                   for a in runs for b in runs
                   for x, y in zip(a["o"], b["o"]))
        print(json.dumps({"case": key, "worst_of_limit": [
            [name, x] for (name, _), x in zip(results, ratios)],
            "max_abs_diff_between_runs": diff,
            "ms": [[name, r["kernels"][key]["ms"]] for name, r in results]}))
    for model in results[0][1]["serving"]:
        print(json.dumps({"serving": model, "runs": [
            [name, r["serving"][model]] for name, r in results]}))
    return 1 if failed else 0


def spread(xs) -> dict:
    xs = sorted(xs)
    return {"median": statistics.median(xs), "min": xs[0], "max": xs[-1],
            "runs": xs}


def main_serving(other: str, pairs: int) -> int:
    trees = [("other", os.path.abspath(other)), ("this", ROOT),
             ("this", ROOT), ("other", os.path.abspath(other))] * pairs
    runs = {"other": [], "this": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, tree) in enumerate(trees):
            runs[name].append(run_tree(tree, os.path.join(tmp, f"{i}.pt"),
                                       serving_only=True)["serving"])
    for model in runs["this"][0]:
        for name, rs in runs.items():
            res = [r[model] for r in rs]
            print(json.dumps({
                "serving": model, "tree": name,
                "steady_b4_tokens_per_s": spread(
                    r["steady_b4_tokens_per_s"] for r in res),
                "ttft_ms": {k: spread(r["ttft_ms"][k] for r in res)
                            for k in res[0]["ttft_ms"]},
                "burst_memcpys": sorted({r["profiled_decode_burst8_b4"][
                    "memcpys"] for r in res}),
                "burst_kernels": sorted({r["profiled_decode_burst8_b4"][
                    "kernels"] for r in res})}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2], "--serving-only" in sys.argv[3:]))
    if len(sys.argv) == 4 and sys.argv[2] == "--serving-pairs":
        sys.exit(main_serving(sys.argv[1], int(sys.argv[3])))
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
