"""Hold the attention kernels, the SSD scan, both decode steps, the
selective scan and causal conv1d of this checkout against another
tree's, on one card: each tree's outputs within chip_smoke.py's limits,
the largest difference between the trees, and their device times.

    python3 scripts/ab_kernels.py OTHER_TREE [--serving-pairs N]
    python3 scripts/ab_kernels.py OTHER_TREE --chunk-pairs N

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
the same code) in bf16 and fp32, the Mamba-1 decode step (B=4) at
mamba-130m's shape on ``chip_smoke.mamba1_decode_inputs``, the
selective scan at mamba-130m's width (B=4, S=256 and B=1, S=16384, bf16
and fp32, on this checkout's ``scan1.ref.model_scale_inputs``) and causal
conv1d (B=4, S=256) at the channel counts of ``chip_smoke.conv_shapes``,
without and (where the tree's wrapper takes them) with ragged valid
lengths, the flash kernel non-causal at hubert-xlarge's encoder shape
(B=4, 16 heads of 80, 1500 frames; bf16 and fp32), and the conv1d
backward at zamba2-2.7b's channels (bf16 at B=4, S=2048; fp32 at S=512,
each gradient within ``chip_smoke.BWD_TOL`` of its max |g|), and saves
the outputs, the plain versions' outputs and the
device times (``chip_smoke.device_ms``).
An attention kernel's cases are those whose head_dim both trees take.
Prints one JSON line per case: each run's worst output over chip_smoke's
limit (1 is the limit: ``row_ratio`` per attention row; for the scan
``chip_smoke.scan_ratio``; for SSD the worst
of y's and the state's whole-tensor limits and y's per-row limit; for the
decode steps the worst output's whole-tensor limit; for conv1d y's limit
and the new state's bit-equality), the largest difference between any
two runs, and each run's time.  Then each child serves mamba2-2.7b,
zamba2-2.7b and mamba-130m as phase 4 of chip_smoke.py does
(``chip_smoke.phase_serving``: full width and depth, 4 ragged requests,
the profiled decode burst and prefill chunk), and one JSON line per model
gives each run's TTFTs, decode rate, and the burst's and the chunk's
kernels, device memcpys and kernel-busy time; the burst is the engine's
(a CUDA graph replay), so both trees need the graph runner
(``ServingEngine._decode_n``).  Exits 1 if any run passes its limit.

With ``--serving-pairs N`` only the serving runs are made, N rounds of
other, this, this, other (2N runs a tree), since host-bound rates move
from run to run: one JSON line per model and tree gives each run's
decode rate and TTFTs with their median, least and greatest.

With ``--chunk-pairs N`` only the eager prefill chunk is timed, N rounds
of other, this, this, other: each child builds falcon-h1-0.5b at full
width and depth (seeded weights, a 4 x 4096 cache at positions 300, 700,
1000 and 1792), runs one 4 x 256 ``lm_prefill_chunk`` (KV bucket 2048,
rope length 4096) three times, then times 20 more, each by the host
clock to the logits' transfer; one JSON line per tree gives the
median, least and greatest wall.  The chunk is bound by the host, so
this is where a change to the host's cost a call shows.
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
    out += mamba1_and_conv_cases(cs, torch)
    out += scan1_cases(torch)
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
    for dt in (torch.bfloat16, torch.float32):
        def make(gen, dt=dt):
            q, k, v = (torch.randn((4, 1500, 16, 80), generator=gen,
                                   device="cuda").to(dt).transpose(1, 2)
                       for _ in range(3))
            return {"flash": (
                lambda: flash_ops.flash_attention(q, k, v, causal=False),
                lambda: flash_ref.attention_ref(q, k, v, causal=False))}
        out.append((f"hubert-xlarge encoder, non-causal {str(dt)[6:]}",
                    ("attention", dt), make))
    out += conv_bwd_cases(torch)
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

    draws = this_ref("ssd")
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


def mamba1_and_conv_cases(cs, torch):
    """The Mamba-1 decode step at mamba-130m's shape (B=4, inputs at the
    model's scales) and causal conv1d (B=4, S=256) at the channel counts
    of ``chip_smoke.conv_shapes``, without and, where the tree's wrapper
    takes them, with ragged valid lengths (256, 200, 3, 0)."""
    import inspect

    from repro_torch.configs import mamba_130m
    from repro_torch.kernels.conv1d import ops as conv_ops
    from repro_torch.kernels.conv1d import ref as conv_ref
    from repro_torch.kernels.decode_fused import ops as dec_ops
    from repro_torch.kernels.decode_fused import ref as dec_ref
    from repro_torch.models.mamba1 import dt_rank

    out = []
    s = mamba_130m.ssm
    c, n, k = s.d_inner(mamba_130m.d_model), s.d_state, s.conv_kernel
    r = dt_rank(mamba_130m.d_model, s)
    for dt in (torch.bfloat16, torch.float32):
        def make(gen, dt=dt):
            args = cs.mamba1_decode_inputs(gen, 4, c, n, r, k, dt)
            kw = dict(d_state=n, dt_rank=r)
            return {"mamba1_decode": (
                lambda: dec_ops.mamba1_decode_fused(*args, **kw),
                lambda: dec_ref.mamba1_decode_fused_ref(*args, **kw))}
        out.append((f"{mamba_130m.name} {str(dt)[6:]}", ("mamba1", dt),
                    make))
    takes_lengths = "lengths" in inspect.signature(
        conv_ops.causal_conv1d).parameters
    for label, cc in cs.conv_shapes():
        for dt in (torch.bfloat16, torch.float32):
            def make(gen, cc=cc, dt=dt):
                def rn(*shape, dtype=torch.float32):
                    return torch.randn(shape, generator=gen,
                                       device="cuda").to(dtype)
                x, w, b = rn(4, 256, cc, dtype=dt), rn(cc, 4), rn(cc)
                st = rn(4, 3, cc, dtype=dt)
                lens = torch.tensor([256, 200, 3, 0], dtype=torch.int32,
                                    device="cuda")
                runs = {"conv1d": (
                    lambda: conv_ops.causal_conv1d(x, w, b,
                                                   initial_state=st),
                    lambda: conv_ref.causal_conv1d_ref(x, w, b, st))}
                if takes_lengths:
                    runs["conv1d lengths"] = (
                        lambda: conv_ops.causal_conv1d(
                            x, w, b, initial_state=st, lengths=lens),
                        lambda: conv_ref.causal_conv1d_ref(
                            x, w, b, st, lengths=lens))
                return runs
            out.append((f"{label} {str(dt)[6:]}", ("conv1d", dt), make))
    return out


def conv_bwd_cases(torch):
    """The conv1d backward at zamba2-2.7b's channels (C=5248, K=4) from
    zeros: bf16 at its training shape (B=4, S=2048), fp32 at S=512."""
    from repro_torch.kernels.conv1d import ops as conv_ops
    ref = this_ref("conv1d")
    out = []
    for dt, s in ((torch.bfloat16, 2048), (torch.float32, 512)):
        def make(gen, dt=dt, s=s):
            def rn(*shape, dtype=dt):
                return torch.randn(shape, generator=gen,
                                   device="cuda").to(dtype)
            x, dy = rn(4, s, 5248), rn(4, s, 5248)
            w, b = 0.5 * rn(5248, 4, dtype=torch.float32), 0.1 * rn(
                5248, dtype=torch.float32)
            return {"conv1d_bwd": (
                lambda: conv_ops.causal_conv1d_bwd_cuda(x, w, b, dy),
                lambda: ref.causal_conv1d_bwd_ref(x, w, b, dy))}
        out.append((f"zamba2-2.7b B=4, S={s} {str(dt)[6:]}",
                    ("conv1d_bwd", dt), make))
    return out


def scan1_cases(torch):
    """The selective scan at mamba-130m's width, B=4, S=256 (a served
    chunk) and B=1, S=16384 (long context), in bf16 and fp32, on inputs
    at the model's scales drawn by this checkout's
    ``scan1.ref.model_scale_inputs``."""
    from repro_torch.configs import mamba_130m
    from repro_torch.kernels.scan1 import ops, ref

    draws = this_ref("scan1")
    s = mamba_130m.ssm
    c, n = s.d_inner(mamba_130m.d_model), s.d_state
    out = []
    for b, seq in ((4, 256), (1, 16384)):
        for dt in (torch.bfloat16, torch.float32):
            def make(gen, b=b, seq=seq, dt=dt):
                args, h0 = draws.model_scale_inputs(gen, b, seq, c, n, dt)
                return {"scan1": (
                    lambda: ops.selective_scan(*args, initial_state=h0),
                    lambda: ref.selective_scan_ref(*args, h0))}
            out.append((f"{mamba_130m.name} B={b} S={seq} {str(dt)[6:]}",
                        ("scan1", dt), make))
    return out


def this_ref(kernel: str):
    """This checkout's ``repro_torch/kernels/<kernel>/ref.py`` (plain
    torch), loaded by its path whichever tree is on ``sys.path``."""
    path = os.path.join(ROOT, "src", "repro_torch", "kernels", kernel,
                        "ref.py")
    spec = importlib.util.spec_from_file_location(f"ab_{kernel}_ref", path)
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
    if kernel in ("mamba2_decode", "mamba1_decode"):
        tol = cs.TOL["decode_fused"][dt]
        return max(cs.whole_ratio(g, w, tol) for g, w in zip(got, want))
    if kernel == "scan1":
        return cs.scan_ratio(got, want, dt)
    if kernel == "conv1d_bwd":
        return max(cs.whole_ratio(g, w, cs.BWD_TOL[dt],
                                  floor=1.1754943508222875e-38)
                   for g, w in zip(got, want))
    if kernel.startswith("conv1d"):
        # y within the limit, the new state bit for bit (a copy)
        return max(cs.whole_ratio(got[0], want[0], cs.TOL["conv1d"][dt]),
                   0.0 if torch_equal(got[1], want[1]) else float("inf"))
    return cs.row_ratio(got[0], want[0], cs.TOL["attention"][dt])


def torch_equal(a, b) -> bool:
    import torch
    return torch.equal(a, b)


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
            # a long-context scan: fewer calls a timed replay
            long_ = got[0].numel() > 1 << 24
            out[f"{name} {label}"] = dict(
                o=[t.cpu() for t in got],
                ms=cs.device_ms(fn, calls=3 if long_ else 10,
                                reps=10 if long_ else 25),
                worst_of_limit=worst_of_limit(cs, name, dt, got, want))
    serving = {}
    from repro_torch.configs import mamba2_2p7b, mamba_130m, zamba2_2p7b
    gen = torch.Generator(device="cuda").manual_seed(0)
    for cfg in (mamba2_2p7b, zamba2_2p7b, mamba_130m):
        res = cs.phase_serving(cfg, gen)[0]
        torch.cuda.empty_cache()
        serving[cfg.name] = {k: res[k] for k in (
            "ttft_ms", "steady_b4_graph_tokens_per_s",
            "profiled_decode_burst8_b4_graph",
            "profiled_prefill_chunk_b4_s256")}
    torch.save({"kernels": out, "serving": serving}, out_path)
    return 0


def chunk_child(out_path: str, reps: int = 20) -> int:
    import time

    import torch
    from repro_torch.configs import falcon_h1_05b as cfg
    from repro_torch.models.lm import (init_lm_cache, init_lm_params,
                                       lm_prefill_chunk, prepare_params)

    gen = torch.Generator(device="cuda").manual_seed(0)
    params = prepare_params(cfg, init_lm_params(cfg, gen, device="cuda"))
    cache = init_lm_cache(cfg, 4, 4096, device="cuda")
    cache["pos"] = torch.tensor([300, 700, 1000, 1792], dtype=torch.int32,
                                device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (4, 256), generator=gen,
                           device="cuda")
    lengths = torch.full((4,), 256, dtype=torch.int32)

    def chunk():
        lm_prefill_chunk(cfg, params, tokens, cache, lengths=lengths,
                         kv_bucket=2048, rope_len=4096)[0].cpu()
    for _ in range(3):
        chunk()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        chunk()
        walls.append((time.perf_counter() - t0) * 1e3)
    torch.save({"chunk_wall_ms": walls}, out_path)
    return 0


def main_chunk(other: str, pairs: int) -> int:
    import torch

    trees = [("other", os.path.abspath(other)), ("this", ROOT),
             ("this", ROOT), ("other", os.path.abspath(other))] * pairs
    walls = {"other": [], "this": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, tree) in enumerate(trees):
            out = os.path.join(tmp, f"{i}.pt")
            env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
            res = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--chunk-child", out], env=env,
                                 capture_output=True, text=True, timeout=900)
            if res.returncode:
                raise RuntimeError(f"{tree}: child failed\n{res.stdout}\n"
                                   f"{res.stderr}")
            walls[name] += torch.load(out)["chunk_wall_ms"]
    for name, ws in walls.items():
        print(json.dumps({"eager_prefill_chunk_b4_s256": "falcon-h1-0.5b",
                          "tree": name, "wall_ms": spread(ws)}))
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
    keys = dict.fromkeys(k for _, r in results for k in r["kernels"])
    for key in keys:
        # a case one tree does not take (a head dim, conv1d's lengths)
        # is held against the runs that have it
        have = [(name, r["kernels"][key]) for name, r in results
                if key in r["kernels"]]
        ratios = [r["worst_of_limit"] for _, r in have]
        failed |= not all(x <= 1.0 for x in ratios)
        diff = max(float((x.float() - y.float()).abs().max())
                   for _, a in have for _, b in have
                   for x, y in zip(a["o"], b["o"]))
        print(json.dumps({"case": key, "worst_of_limit": [
            [name, x] for (name, _), x in zip(have, ratios)],
            "max_abs_diff_between_runs": diff,
            "ms": [[name, r["ms"]] for name, r in have]}))
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
                "steady_b4_graph_tokens_per_s": spread(
                    r["steady_b4_graph_tokens_per_s"] for r in res),
                "ttft_ms": {k: spread(r["ttft_ms"][k] for r in res)
                            for k in res[0]["ttft_ms"]},
                "burst_memcpys": sorted({r["profiled_decode_burst8_b4_graph"][
                    "memcpys"] for r in res}),
                "burst_kernels": sorted({r["profiled_decode_burst8_b4_graph"][
                    "kernels"] for r in res}),
                "chunk_memcpys": sorted({r["profiled_prefill_chunk_b4_s256"][
                    "memcpys"] for r in res}),
                "chunk_kernels": sorted({r["profiled_prefill_chunk_b4_s256"][
                    "kernels"] for r in res})}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2], "--serving-only" in sys.argv[3:]))
    if sys.argv[1:2] == ["--chunk-child"]:
        sys.exit(chunk_child(sys.argv[2]))
    if len(sys.argv) == 4 and sys.argv[2] == "--chunk-pairs":
        sys.exit(main_chunk(sys.argv[1], int(sys.argv[3])))
    if len(sys.argv) == 4 and sys.argv[2] == "--serving-pairs":
        sys.exit(main_serving(sys.argv[1], int(sys.argv[3])))
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
