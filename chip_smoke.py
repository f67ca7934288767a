"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (each prints its lines and is fatal on failure):
  1. the card's name and power limit (``nvidia-smi``); no CUDA -> exit 1;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. each kernel against its plain PyTorch version on the card, in bf16
     and fp32 with non-zero initial states, with its device time, the
     plain version's, a library call's where one exists, and its bound:
     conv1d at the channel counts of mamba2-2.7b, zamba2-2.7b and
     mamba-130m, also with valid lengths 0, 1, 2, K-1, 200 and S across
     rows (the new state held bit for bit) and timed once with L2
     flushed before each call;
     the Mamba-2 kernels at mamba2-2.7b's, zamba2-2.7b's and
     falcon-h1-0.5b's shapes (SSD also on a 16-chunk sequence, and the
     decode step again, with dt, A and the states drawn at the model's
     scales; each (token, head) row of SSD's y held to a limit of its
     own), the attention kernels at zamba2-2.7b's (d=80), llama3-8b's
     (d=128, GQA 4:1), qwen2.5-0.5b's (d=64, GQA 7:1), phi-3-mini's
     (d=96), falcon-h1-0.5b's (d=128, GQA 2:1) and glm4-9b's (d=128, 16
     query heads per KV head) shapes and a decode whose valid lengths fall
     on tile and split edges, each attention query row held to a limit of
     its own;
     the Mamba-1 kernels (selective scan, fused decode step) at
     mamba-130m's shapes, the step also at B=1 and B=16, and off their
     tiles (the decode step's inputs drawn at the model's scales; the
     scan's too at B=1 over S = 4133 and 16384, many 256-step tiles and
     off them, y and the final state), and the long-context scan (B=1,
     S=2048 and 16384) beside its bound (``scan_bound``: bytes,
     exponentials or other operations, whichever takes longest); the flash kernel's
     ring mode at gemma3-1b's shapes (B=4, H=4, KVH=1, d=256, window
     512): a 256-query chunk at cursors 0/300/700/1792 against a 512-slot
     ring, sliced rings, and a 1024-query chunk that wraps inside itself,
     with the plain flash and the decode kernel at d=256 (gemma3-1b's
     global layers), and decode over gemma3-1b's 512-slot local ring caches
     (valid 301/512/512/512); each attention row gives its grid
     (``blocks``);
  4. full-width, full-depth serving through ``ServingEngine`` (4 ragged
     requests, 32 new tokens each), random weights from a seed:
     mamba2-2.7b (64 layers), zamba2-2.7b (54 layers), mamba-130m
     (24 Mamba-1 layers), gemma3-1b (26 layers: 22 ring layers, 4
     global), then falcon-h1-0.5b (18 ``hybrid_par`` layers: attention
     and Mamba-2 side by side); the launch counters are reset just before each run and
     read just after, each run must launch exactly the kernels of its
     layer kinds, each exactly once per layer and prefill chunk (flash,
     ring flash, conv1d, SSD or the scan) or token step (decode
     attention, the decode steps); every decode burst runs through the
     engine's CUDA graphs (``serving/graphs.py``: the first burst at a
     key eagerly, then captured; every later one a replay); steady
     8-token bursts run both ways, eager ``decode_tokens`` then the
     graph runner, with their times, profiles and memory, and the graph
     bursts are held bit for bit to eager bursts from cloned caches
     (``phase_steady_bursts``); a profiled prefill chunk counts the
     state leaves copied into the new cache (none: every Mamba kernel
     writes its slot);
  5. the kernel path against the plain path on the card (one prompt,
     teacher-forced decode): mamba2-2.7b at 8 layers, zamba2-2.7b at 12
     layers (two shared-block positions), a 4-layer ``dense`` model at
     llama3-8b's width and mamba-130m at its 24 layers on a 512-token
     prompt, gemma3-1b at its 26 layers on a 1300-token prompt (past
     the window, so its rings wrap in prefill and again in decode), and
     qwen2.5-0.5b (d=64) and phi-3-mini (d=96) at full width and 4
     layers, in bf16 and, for all but the first three, again in fp32
     (where only the order of sums differs); then falcon-h1-0.5b at its
     18 layers, hymba-1.5b at its 24 (both ``hybrid_par``) in bf16 and
     fp32, smollm-135m at its 30 in bf16, and glm4-9b (16 query heads per
     KV head) at 4 layers in bf16 and fp32; the plain run must launch no
     kernel;
  6. mamba-130m, then falcon-h1-0.5b, at full width and depth prefill one
     16384-token prompt at B=1 in bf16 through ``lm_prefill``: wall time,
     kernel time and the shares of it of the scan (mamba-130m) or of
     flash, SSD and conv1d (falcon-h1-0.5b), exact launches, and its last
     logits against the same prompt in 64 chunks of 256 through
     ``lm_prefill_chunk`` within phase 5's bf16 limit; falcon-h1-0.5b then
     decodes 32 tokens at that context through the graph burst (ms per
     token step);
  7. the engine's control layer at full width and depth
     (``phase_control``: slots 4, max_seq 4096, chunks of 256, bursts of
     8, strict tiers, the engine's defaults: the sentinel and a
     checkpoint every 8 iterations).  zamba2-2.7b: run U serves 4
     class-0 requests (prompts 1100/1300/1500/1700, 48 new); run P adds
     2 class-1 requests (1200, 1600; 16 new) once all 4 are live, which
     preempt class-0 slots to the host; P's class-0 streams must equal
     U's bit for bit, every victim be restored, no graph key or capture
     be added and no state leaf copied, every burst at the 2048 rung.
     Then U's traffic with a NaN poked into slot 1 once all are live
     (one replay from its checkpoint, every stream U's) and P's with the
     first victim's preemption blob bit-flipped (only it fails, with
     ``CacheCorruption``).  gemma3-1b: prompts 600-900 past its
     512-slot rings, every burst at the 1024 rung: run P against U
     across the ring wrap, then U's traffic killed two iterations after
     all are live, with a ``CheckpointStore`` under
     ``build/repro_torch/``, and a fresh engine over the store finishing
     every stream bit for bit.  Each run prints its wall, checkpoints
     and their share of the wall against the reference's 5% budget,
     captures and keys, the steady burst's ms a step beside
     ``telemetry.estimate("decode", rung)``; each model's run U the
     offload and restore ms and MB of one slot, and the crc32's ms in
     each;
then a ``kernels`` JSON line (the five Mamba-2 and attention kernels at
zamba2-2.7b's shapes, the two Mamba-1 kernels at mamba-130m's and the
flash kernel's ring mode at gemma3-1b's, each with the launches of its
own config's serving run), the card line, and the result line last.
Imports nothing of JAX nor of the reference package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch

HBM_BYTES_PER_S = 3.35e12                        # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,            # dense bf16 tensor cores
              torch.float32: 67e12}              # fp32 outside tensor cores
# exponentials a second: the special-function units issue 16 ex2 a clock
# on each SM (sm_90), 132 SMs at the 1.98 GHz boost clock
EX2_PER_S = 16 * 132 * 1.98e9


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def device_ms(fn, calls: int = 10, reps: int = 25) -> float:
    """Device time of one ``fn()``: a CUDA graph of ``calls`` calls is
    replayed ``reps`` times between CUDA events; median over the replays,
    divided by ``calls``.  The graph removes host launch gaps, so this is
    the card's time for the work, inputs warm in L2."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_ms_cold(fn, reps: int = 25) -> float:
    """Device time of one ``fn()`` with L2 flushed before it: a 256 MB
    buffer is zeroed (past the 50 MB L2) and ``fn`` is timed between CUDA
    events right behind it; median over ``reps``."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_busy(fn, names=()) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and read the trace: wall
    time, the union of kernel intervals on the card, kernel launches, and
    the device-side memory copies (``copy_`` of one tensor into another
    of its type, as a cache leaf is stored, runs as a memcpy, not a
    kernel) with their summed time and their count by direction; for each
    of ``names``, the summed time of the kernels whose name holds it and
    its share of all kernel time.  Where the idle time lies: the device
    span (first device operation's start to the last one's end) and the
    idle share inside it (the gaps between operations), the first device
    operation's and the first kernel's offsets, both on the card's clock,
    from the end of a one-element fill launched right before ``fn`` (the
    card's and the host's clocks are not one clock), and the host time in
    ``cudaGraphLaunch``.  One small operation runs before ``fn``, so the
    tracer is live when ``fn`` starts; only the device operations of the
    calls ``fn`` made are read.  The trace is
    kept in ``build/repro_torch/`` (listed in .gitignore)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").sum()
        torch.cuda.synchronize()
        with record_function("device_busy_fn"):
            t0 = time.monotonic()
            with record_function("device_busy_marker"):
                marker.fill_(1.0)
            fn()
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "repro_torch", "decode_trace.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    prof.export_chrome_trace(out)
    with open(out) as f:
        events = json.load(f).get("traceEvents", [])
    def annotation(name):
        mark = next(e for e in events if e.get("name") == name
                    and e.get("cat") == "user_annotation")
        return mark["ts"], mark["ts"] + mark["dur"]

    def cuda_calls(lo, hi):
        return [e for e in events
                if str(e.get("cat", "")).startswith("cuda_")
                and lo <= e["ts"] <= hi]

    def correlations(calls):
        return {e.get("args", {}).get("correlation") for e in calls} - {None}

    host0, host1 = annotation("device_busy_fn")
    # the device operations of the CUDA API calls ``fn`` made, matched by
    # correlation id (the card's and the host's clocks may disagree by
    # more than the gap between a call and its work); the marker's fill
    # is the card-clock origin of the offsets below
    calls = cuda_calls(host0, host1)
    marker_ids = correlations(cuda_calls(*annotation("device_busy_marker")))
    ids = correlations(calls) - marker_ids
    marks = [e for e in events if "dur" in e
             and e.get("args", {}).get("correlation") in marker_ids
             and e.get("cat") in ("kernel", "gpu_memset")]
    dev0 = max(e["ts"] + e["dur"] for e in marks) if marks else None
    ops = [e for e in events if "dur" in e
           and e.get("args", {}).get("correlation") in ids]
    kernels = [e for e in ops if e.get("cat") == "kernel"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    total = sum(e["dur"] for e in kernels)
    by_name = {}
    for name in names:
        us = sum(e["dur"] for e in kernels if name in e.get("name", ""))
        by_name[name] = dict(kernel_ms=us / 1e3,
                             share=us / total if total else None)
    copies = [e for e in ops if e.get("cat") == "gpu_memcpy"]
    by_kind = {}
    for e in copies:
        kind = e.get("name", "").split(" ")[1:2] or ["?"]
        by_kind[kind[0]] = by_kind.get(kind[0], 0) + 1
    device_ops = sorted((e["ts"], e["ts"] + e["dur"])
                        for e in kernels + copies)
    graph_launch_us = sum(e["dur"] for e in calls
                          if e.get("name") == "cudaGraphLaunch")
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    span_us = (device_ops[-1][1] - device_ops[0][0]) if device_ops else 0
    return dict(wall_ms=wall_us / 1e3, kernel_busy_ms=busy / 1e3,
                kernels=len(spans), memcpys=len(copies),
                memcpy_ms=sum(e["dur"] for e in copies) / 1e3,
                memcpys_by_kind=by_kind,
                idle_share=(1 - busy / wall_us) if spans else None,
                device_span_ms=span_us / 1e3,
                idle_share_in_span=(1 - busy / span_us) if spans else None,
                first_device_op_ms=(
                    (device_ops[0][0] - dev0) / 1e3
                    if device_ops and dev0 is not None else None),
                first_kernel_ms=(spans[0][0] - dev0) / 1e3
                if spans and dev0 is not None else None,
                graph_launch_ms=graph_launch_us / 1e3,
                **({"by_name": by_name} if names else {}))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved: int, flops: float, dtype) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_bound(args, out) -> tuple:
    """The selective scan's bound: the larger of its bytes (each input read
    once, each output written once) over the HBM rate, its exponentials
    (one per state and step) over the special-function units' rate, and
    its other fp32 operations over the fp32 peak (per state and step dt*A,
    h*dA + (dt*x)*B, C.h: 6; per step dt*x, D*x, their sum: 3)."""
    b_, s_, c_ = args[0].shape
    steps = b_ * s_ * c_
    elems = steps * args[2].shape[-1]
    times = [(nbytes(*args) + nbytes(*out)) / HBM_BYTES_PER_S * 1e3,
             elems / EX2_PER_S * 1e3,
             (6.0 * elems + 3.0 * steps) / PEAK_FLOPS[torch.float32] * 1e3]
    best = max(range(3), key=times.__getitem__)
    return times[best], ("bytes", "exponentials", "operations")[best]


def max_err(got, want) -> float:
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want))


def whole_ratio(got, want, tol, floor=1.0) -> float:
    """max |got - want| over ``tol`` x max(``floor``, max |want|)."""
    scale = max(floor, float(want.float().abs().max()))
    return float((got.float() - want.float()).abs().max()) / (tol * scale)


def row_ratio(got, want, tol) -> float:
    """The worst row (all but the last dim) of max |got - want| over
    ``tol`` x that row's max |want|.  An attention row's output shrinks
    with the keys it attends (about sqrt(e / n) for n random keys), so a
    scale shared by the whole tensor, set by a one-key row's |o| ~ 4,
    would pass a fault confined to the rows that attend thousands."""
    g, w = got.float(), want.float()
    err = (g - w).abs().amax(-1)
    scale = w.abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
    return float((err / (tol * scale)).max())


def allclose_ratio(got, want, tol) -> float:
    """The worst element of |got - want| over ``tol`` x (1 + |want|):
    ``assert_allclose`` with rtol = atol = ``tol``."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (tol * (1.0 + w.abs()))).max())


def check_close(name, got, want, tol, ratio=whole_ratio, **kw):
    """Every output within its limit: ``ratio(output, reference, tol,
    **kw)`` at most 1."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name} output {i}: {a.shape}/{a.dtype} "
                                 f"!= {b.shape}/{b.dtype}")
        r = ratio(a, b, tol, **kw)
        if not r <= 1.0:
            raise AssertionError(f"{name} output {i}: error {r} x its limit "
                                 f"({ratio.__name__}, tol {tol})")


# stated tolerances: the reference's own kernel-test tolerances
# (tests/test_kernels.py, tests/test_decode_fused.py), relative to
# max(1, max |reference|); attention's relative to each query row's
# max |o| (row_ratio)
TOL = {"conv1d": {torch.float32: 2e-4, torch.bfloat16: 2e-2},
       "ssd": {torch.float32: 1e-3, torch.bfloat16: 2e-2},
       "decode_fused": {torch.float32: 1e-5, torch.bfloat16: 2e-2},
       "attention": {torch.float32: 2e-4, torch.bfloat16: 2e-2},
       # tests/test_scan1_kernel.py: y relative to max |y|, state 1e-3
       "scan1": {torch.float32: 2e-4, torch.bfloat16: 3e-2}}
SCAN1_STATE_TOL = 1e-3


def scan_ratio(got, want, dt) -> float:
    """The selective scan's check as its worst ratio to a limit (1 is the
    limit): y within ``TOL["scan1"]`` of max |y|, the final state
    allclose with rtol = atol = ``SCAN1_STATE_TOL``."""
    return max(whole_ratio(got[0], want[0], TOL["scan1"][dt],
                           floor=torch.finfo(torch.float32).tiny),
               allclose_ratio(got[1], want[1], SCAN1_STATE_TOL))


def phase_kernels(cfg, gen):
    """Compare and time the Mamba-2 kernels at ``cfg``'s shapes (B=4)."""
    from repro_torch.kernels.conv1d import ops as conv_ops, ref as conv_ref
    from repro_torch.kernels.decode_fused import (ops as dec_ops,
                                                  ref as dec_ref)
    from repro_torch.kernels.ssd import ops as ssd_ops, ref as ssd_ref

    s = cfg.ssm
    B, S = 4, 256
    H, P, N, G, K = (s.n_ssm_heads(cfg.d_model), s.headdim, s.d_state,
                     s.n_groups, s.conv_kernel)
    C = s.d_inner(cfg.d_model) + 2 * G * N
    dev = "cuda"

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rows = [conv_row(gen, cfg.name, C, K)]
    # conv1d off the kernel's vectors and tiles, and an input shorter than
    # the conv window
    for (b_, s_, c_) in ((3, 200, 5000), (3, 200, 5003), (2, 2, 1003)):
        for dt in (torch.bfloat16, torch.float32):
            x, w, bias = rn(b_, s_, c_, dtype=dt), rn(c_, K), rn(c_)
            st = rn(b_, K - 1, c_, dtype=dt)
            check_close(f"conv1d {dt} {(b_, s_, c_)}",
                        conv_ops.causal_conv1d(x, w, bias, initial_state=st),
                        conv_ref.causal_conv1d_ref(x, w, bias, st),
                        TOL["conv1d"][dt])

    for dt in (torch.bfloat16, torch.float32):
        x = rn(B, S, H, P, dtype=dt)
        dts = ssd_ref.softplus(rn(B, S, H) - 2.0)
        A = -torch.exp(rn(H))
        Bm, Cm = rn(B, S, G, N, dtype=dt), rn(B, S, G, N, dtype=dt)
        D, h0 = rn(H), rn(B, H, P, N)
        got = ssd_ops.ssd_chunked(x, dts, A, Bm, Cm, D, chunk=s.chunk,
                                  initial_state=h0)
        want = ssd_ref.ssd_chunked_ref(x, dts, A, Bm, Cm, D, chunk=s.chunk,
                                       initial_state=h0)
        check_ssd(f"ssd {dt}", got, want, dt)
        # 16 chunks at the model's scales: a fault in the carried state
        # or in one score tile shows in the rows it reaches
        args16, h16 = ssd_ref.model_scale_inputs(gen, B, 16 * s.chunk, H,
                                                  P, N, dt)
        check_ssd(f"ssd {dt} 16 chunks", ssd_ops.ssd_chunked(
            *args16, chunk=s.chunk, initial_state=h16),
            ssd_ref.ssd_chunked_ref(*args16, chunk=s.chunk,
                                    initial_state=h16), dt)
        del args16, h16
        if dt == torch.bfloat16:
            err = max_err(got, want)
            ms = device_ms(lambda: ssd_ops.ssd_chunked(
                x, dts, A, Bm, Cm, D, chunk=s.chunk, initial_state=h0))
            plain = device_ms(lambda: ssd_ref.ssd_chunked_ref(
                x, dts, A, Bm, Cm, D, chunk=s.chunk, initial_state=h0))
            q = s.chunk
            flops = 2.0 * B * H * (S // q) * (q * q * N + q * q * P
                                              + 2 * q * P * N)
            bms, by = bound(nbytes(x, dts, A, Bm, Cm, D, h0) + nbytes(*got),
                            flops, dt)
            plan = ssd_ops.ssd_plan(B, H, q, P, N, dt)
            rows.append(dict(
                name="ssd_chunked", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd.cu",
                replaces="src/repro/kernels/ssd/kernel.py:68",
                blocks=plan.blocks,
                smem_bytes=plan.smem_bytes, max_abs_err=err,
                worst_row_of_limit=row_ratio(got[0], want[0],
                                             TOL["ssd"][dt]),
                ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=None))

    for dt in (torch.bfloat16, torch.float32):
        conv, ssm, xbc = rn(B, K - 1, C, dtype=dt), rn(B, H, P, N), rn(B, C,
                                                                   dtype=dt)
        w, cb, dtr = rn(C, K), rn(C), rn(B, H, dtype=dt)
        dtb, al, D = rn(H), rn(H), rn(H)
        kw = dict(n_groups=G, d_state=N, headdim=P)
        args = (conv, ssm, xbc, w, cb, dtr, dtb, al, D)
        got = dec_ops.mamba2_decode_fused(*args, **kw)
        want = dec_ref.mamba2_decode_fused_ref(*args, **kw)
        check_close(f"decode_fused {dt}", got, want, TOL["decode_fused"][dt])
        scaled = mamba2_decode_inputs(gen, B, H, P, G, N, K, dt)
        check_close(f"decode_fused {dt} at the model's scales",
                    dec_ops.mamba2_decode_fused(*scaled, **kw),
                    dec_ref.mamba2_decode_fused_ref(*scaled, **kw),
                    TOL["decode_fused"][dt])
        if dt == torch.bfloat16:
            err = max_err(got, want)
            ms = device_ms(lambda: dec_ops.mamba2_decode_fused(*args, **kw))
            plain = device_ms(
                lambda: dec_ref.mamba2_decode_fused_ref(*args, **kw))
            bms, by = bound(nbytes(*args) + nbytes(*got),
                            6.0 * B * H * P * N, dt)
            rows.append(dict(
                name="mamba2_decode_fused", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_fused.cu",
                replaces="src/repro/kernels/decode_fused/kernel.py:66",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=None))
    return rows


def conv_row(gen, at, c, k):
    """causal conv1d at (B=4, S=256, ``c``) against its plain version in
    bf16 and fp32, the new state bit for bit, also with valid lengths
    0, 1, 2, K-1, 200 and S across six rows; the bf16 row of the kernels
    line: its time (inputs warm in L2, and once with L2 flushed before
    each call), with lengths, the plain version's, ``F.conv1d``'s on the
    padded input in its channels-first layout (no SiLU, no state) and
    the bound (x, w, b and the old state read once, y and the new state
    written once)."""
    import torch.nn.functional as F
    from repro_torch.kernels.conv1d import ops as conv_ops, ref as conv_ref

    B, S = 4, 256

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    row = None
    for dt in (torch.bfloat16, torch.float32):
        x, w, bias = rn(B, S, c, dtype=dt), rn(c, k), rn(c)
        st = rn(B, k - 1, c, dtype=dt)
        got = conv_ops.causal_conv1d(x, w, bias, initial_state=st)
        want = conv_ref.causal_conv1d_ref(x, w, bias, st)
        check_close(f"conv1d {dt} {(B, S, c)} at {at}", got, want,
                    TOL["conv1d"][dt])
        check_equal(f"conv1d {dt} {(B, S, c)} at {at} state", got[1],
                    want[1])
        lens = torch.tensor([0, 1, 2, k - 1, 200, S], dtype=torch.int32,
                            device="cuda")
        xl, stl = rn(6, S, c, dtype=dt), rn(6, k - 1, c, dtype=dt)
        gl = conv_ops.causal_conv1d(xl, w, bias, initial_state=stl,
                                    lengths=lens)
        wl = conv_ref.causal_conv1d_ref(xl, w, bias, stl, lengths=lens)
        check_close(f"conv1d {dt} lengths {lens.tolist()} at {at}", gl, wl,
                    TOL["conv1d"][dt])
        check_equal(f"conv1d {dt} lengths {lens.tolist()} at {at} state",
                    gl[1], wl[1])
        if dt != torch.bfloat16:
            continue
        lens4 = lens[[0, 3, 4, 5]]
        xp = torch.cat([st, x], 1).transpose(1, 2).contiguous()
        wl_, bl_ = w.to(dt)[:, None, :].contiguous(), bias.to(dt)
        bms, by = bound(nbytes(x, w, bias, st) + nbytes(*got),
                        2.0 * k * B * S * c, dt)
        row = dict(
            name="causal_conv1d", route="cuda", at=at,
            source="src/repro_torch/kernels/csrc/conv1d.cu",
            replaces="src/repro/kernels/conv1d/kernel.py:37",
            shape=f"B={B} S={S} C={c} K={k}",
            max_abs_err=max_err(got, want),
            ms=device_ms(lambda: conv_ops.causal_conv1d(
                x, w, bias, initial_state=st)),
            ms_lengths=device_ms(lambda: conv_ops.causal_conv1d(
                x, w, bias, initial_state=st, lengths=lens4)),
            cold_l2_ms=device_ms_cold(lambda: conv_ops.causal_conv1d(
                x, w, bias, initial_state=st)),
            plain_ms=device_ms(lambda: conv_ref.causal_conv1d_ref(
                x, w, bias, st)),
            bound_ms=bms, bound_by=by,
            library_ms=device_ms(lambda: F.conv1d(xp, wl_, bl_, groups=c)))
    return row


def conv_shapes():
    """(model, conv channels) of the served Mamba models: d_inner + 2 G N
    for Mamba-2, d_inner for Mamba-1."""
    from repro_torch.configs import (falcon_h1_05b, mamba2_2p7b, mamba_130m,
                                     zamba2_2p7b)
    out = []
    for cfg in (mamba2_2p7b, zamba2_2p7b, mamba_130m, falcon_h1_05b):
        s = cfg.ssm
        c = s.d_inner(cfg.d_model)
        if s.variant != "mamba1":
            c += 2 * s.n_groups * s.d_state
        out.append((cfg.name, c))
    return out


def check_equal(name, got, want):
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: not bit-equal to the plain version "
                             f"(max |diff| "
                             f"{float((got.float() - want.float()).abs().max())})")


def check_ssd(name, got, want, dt):
    """SSD's y and final state each within the whole-tensor limit, and each
    (token, head) row of y within the same tolerance of its own max |y|."""
    check_close(name, got, want, TOL["ssd"][dt])
    check_close(name + " y rows", got[:1], want[:1], TOL["ssd"][dt],
                ratio=row_ratio)


def mamba2_decode_inputs(gen, b, h, p, g, n, k, dt):
    """Inputs of one Mamba-2 decode step (conv window, state, token,
    conv_w, conv_b, dt_raw, dt_bias, A_log, D) at the model's scales:
    dt_raw small, dt_bias from the model's dt init (dt log-uniform in
    [1e-3, 1e-1]), A_log = log(uniform in [1, 16]), conv taps with std
    1/sqrt(K), so exp(dt * A) falls in [0.2, 1) and the old state's share
    h * exp(dt * A) dominates the new state, as in a served decode."""
    c = h * p + 2 * g * n

    def rn(*shape, dtype=torch.float32, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * std).to(dtype)

    u = torch.rand((h,), generator=gen, device="cuda")
    dt0 = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    a_log = torch.log(torch.rand((h,), generator=gen, device="cuda") * 15.0
                      + 1.0)
    return (rn(b, k - 1, c, dtype=dt), rn(b, h, p, n), rn(b, c, dtype=dt),
            rn(c, k, std=k ** -0.5), rn(c), rn(b, h, dtype=dt, std=0.1),
            dt0 + torch.log(-torch.expm1(-dt0)), a_log, rn(h))


def mamba1_decode_inputs(gen, b, c, n, r, k, dt):
    """Inputs of one Mamba-1 decode step (conv window, state, token,
    conv_w, conv_b, x_proj, dt_proj, dt_bias, A_log, D) at the model's
    scales: x_proj and dt_proj drawn with std 1/sqrt(fan-in), dt_bias the
    inverse softplus of dt log-uniform in [1e-3, 1e-1] (the model's
    init), A_log = log(1..n) per channel, so dt = softplus(dt_low @
    dt_proj + dt_bias) falls near the serving run's 1e-3..0.3 and the
    old state's share h * exp(dt * A) of the new state is of the order of
    dt * x * B.  Unscaled projections would give dt ~ 0 or ~ 100s, where
    exp(dt * A) is 1 or 0 and a fault in the carry hides below a limit
    set by |h'| ~ 1e6."""
    def rn(*shape, dtype=torch.float32, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * std).to(dtype)

    u = torch.rand((c,), generator=gen, device="cuda")
    dt_init = torch.exp(u * (math.log(1e-1) - math.log(1e-3))
                        + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device="cuda")).repeat(c, 1)
    return (rn(b, k - 1, c, dtype=dt), rn(b, c, n), rn(b, c, dtype=dt),
            rn(c, k, std=k ** -0.5), rn(c),
            rn(c, r + 2 * n, dtype=dt, std=c ** -0.5),
            rn(r, c, dtype=dt, std=r ** -0.5), dt_bias, a_log, rn(c))


def phase_mamba1_kernels(cfg, gen):
    """Compare and time the Mamba-1 kernels at ``cfg``'s shapes (B=4,
    S=256), off their tiles (S=200 with C=1000, and S=7); the scan also
    on inputs at the model's scales (``scan1.ref.model_scale_inputs``)
    at B=1 over S = 4133 and 16384 (many 256-step tiles, and off them)
    and at the served chunk, and one long-context scan (B=1, S=16384)
    against its bound.  No PyTorch call computes either function, so
    ``library_ms`` is None.  The decode step's bound counts operations at
    the fp32 CUDA-core peak; the scan's is ``scan_bound``."""
    from repro_torch.kernels.decode_fused import (ops as dec_ops,
                                                  ref as dec_ref)
    from repro_torch.kernels.scan1 import ops as scan_ops, ref as scan_ref
    from repro_torch.kernels.ssd.ref import softplus
    from repro_torch.models.mamba1 import dt_rank

    s = cfg.ssm
    B, S = 4, 256
    C, N, K = s.d_inner(cfg.d_model), s.d_state, s.conv_kernel
    R = dt_rank(cfg.d_model, s)
    F32 = torch.float32

    def rn(*shape, dtype=F32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def scan_inputs(b_, s_, c_, dt):
        return (rn(b_, s_, c_, dtype=dt), softplus(rn(b_, s_, c_) - 2.0),
                -torch.exp(rn(c_, N)), rn(b_, s_, N, dtype=dt),
                rn(b_, s_, N, dtype=dt), rn(c_), rn(b_, c_, N))

    def check_scan(name, got, want, dt):
        r = scan_ratio(got, want, dt)
        if not r <= 1.0:
            raise AssertionError(f"{name}: error {r} x its limit")
        return r

    def plan_of(args):
        b_, s_, c_ = args[0].shape
        p = scan_ops.scan1_plan(b_, s_, c_, N, args[0].dtype)
        return dict(plan=p.index, blocks=p.blocks, threads=p.threads,
                    smem_bytes=p.smem_bytes)

    rows = [conv_row(gen, cfg.name, C, K)]
    for (b_, s_, c_) in ((B, S, C), (3, 200, 1000), (2, 7, C)):
        for dt in (torch.bfloat16, F32):
            args = scan_inputs(b_, s_, c_, dt)
            got = scan_ops.selective_scan(*args[:6], initial_state=args[6])
            want = scan_ref.selective_scan_ref(*args)
            check_scan(f"selective scan {dt} {(b_, s_, c_)}", got, want, dt)
            if (b_, s_, c_) == (B, S, C) and dt == torch.bfloat16:
                bms, by = scan_bound(args, got)
                rows.append(dict(
                    name="selective_scan", route="cuda",
                    source="src/repro_torch/kernels/csrc/scan1.cu",
                    replaces="src/repro/kernels/scan1/kernel.py:52",
                    **plan_of(args),
                    max_abs_err=max_err(got, want),
                    ms=device_ms(lambda: scan_ops.selective_scan(
                        *args[:6], initial_state=args[6])),
                    plain_ms=device_ms(
                        lambda: scan_ref.selective_scan_ref(*args)),
                    bound_ms=bms, bound_by=by, library_ms=None, at=cfg.name))
    # at the model's scales a state lives for hundreds of steps, so a
    # carry lost between tiles, or a wrong lane in the warp's scan, shows
    scaled = {}
    for (b_, s_) in ((1, 4133), (1, 16384), (B, S)):
        for dt in (torch.bfloat16, F32):
            args, h0 = scan_ref.model_scale_inputs(gen, b_, s_, C, N, dt)
            scaled[f"B={b_} S={s_} {str(dt)[6:]}"] = check_scan(
                f"selective scan {dt} {(b_, s_, C)} at the model's scales",
                scan_ops.selective_scan(*args, initial_state=h0),
                scan_ref.selective_scan_ref(*args, h0), dt)
            del args, h0
    rows[-1]["model_scale_of_limit"] = scaled

    # long context: the kernel at S=2048 and 16384 against its bound; the
    # plain loop (one launch chain per step) is timed at S=2048 only
    long_ = {}
    for s_ in (2048, 16384):
        args = scan_inputs(1, s_, C, torch.bfloat16)
        got = scan_ops.selective_scan(*args[:6], initial_state=args[6])
        if s_ == 2048:
            want = scan_ref.selective_scan_ref(*args)
            check_scan(f"selective scan bf16 (1, {s_}, {C})", got, want,
                       torch.bfloat16)
            long_["plain_ms_s2048"] = device_ms(
                lambda: scan_ref.selective_scan_ref(*args), calls=1, reps=3)
        ms = device_ms(lambda: scan_ops.selective_scan(
            *args[:6], initial_state=args[6]), calls=3, reps=10)
        bms, by = scan_bound(args, got)
        long_[f"s{s_}"] = dict(ms=ms, bound_ms=bms, bound_by=by,
                               bytes=nbytes(*args) + nbytes(*got),
                               **plan_of(args))
        del args, got
    long_["shape"] = f"B=1, C={C}, N={N}, bf16"

    b_ms = {}
    for (b_, c_, n_, r_) in ((B, C, N, R), (1, C, N, R), (16, C, N, R),
                             (3, 1000, 8, 6)):
        for dt in (torch.bfloat16, F32):
            args = mamba1_decode_inputs(gen, b_, c_, n_, r_, K, dt)
            kw = dict(d_state=n_, dt_rank=r_)
            got = dec_ops.mamba1_decode_fused(*args, **kw)
            want = dec_ref.mamba1_decode_fused_ref(*args, **kw)
            check_close(f"mamba1 decode {dt} {(b_, c_, n_, r_)}", got, want,
                        TOL["decode_fused"][dt])
            if b_ in (1, 16) and dt == torch.bfloat16:
                b_ms[f"ms_b{b_}"] = device_ms(
                    lambda: dec_ops.mamba1_decode_fused(*args, **kw))
            if (b_, c_) == (B, C) and dt == torch.bfloat16:
                f_ = r_ + 2 * n_
                # conv, x_proj, dt_proj; per state: exp(A_log), dt*A,
                # exp, h*dA + (dt*x)*B (3), C.h (2)
                flops = b_ * (2.0 * K * c_ + 2.0 * c_ * f_ + 2.0 * r_ * c_
                              + 8.0 * c_ * n_)
                bms, by = bound(nbytes(*args) + nbytes(*got), flops, F32)
                rows.append(dict(
                    name="mamba1_decode_fused", route="cuda",
                    source="src/repro_torch/kernels/csrc/mamba1_decode.cu",
                    replaces="src/repro/kernels/decode_fused/kernel.py:138",
                    max_abs_err=max_err(got, want),
                    ms=device_ms(lambda: dec_ops.mamba1_decode_fused(
                        *args, **kw)),
                    plain_ms=device_ms(lambda: dec_ref.mamba1_decode_fused_ref(
                        *args, **kw)),
                    bound_ms=bms, bound_by=by, library_ms=None, at=cfg.name))
    rows[-1].update(b_ms)
    return rows, long_


def attention_cases():
    """(label, H, KVH, d, bucket, q_offset, valid_len) at B=4: zamba2-2.7b's
    shared attention, llama3-8b's GQA, gemma3-1b's global layers,
    qwen2.5-0.5b's d=64 GQA 7:1, phi-3-mini's d=96, falcon-h1-0.5b's
    attention half (GQA 2:1) and glm4-9b's 16 query heads per KV head; a
    flash chunk of 256 queries, and decode rows of the serving run's
    lengths."""
    offs = [0, 512, 1024, 1792]
    lens = [301, 701, 1001, 2048]
    return [("zamba2-2.7b", 32, 32, 80, 2048, offs, lens),
            ("llama3-8b", 32, 8, 128, 2048, offs, lens),
            ("gemma3-1b", 4, 1, 256, 2048, offs, lens),
            ("qwen2.5-0.5b", 14, 2, 64, 2048, offs, lens),
            ("phi-3-mini", 32, 32, 96, 2048, offs, lens),
            ("falcon-h1-0.5b", 8, 4, 128, 2048, offs, lens),
            ("glm4-9b", 32, 2, 128, 2048, offs, lens)]


B_ATTN, SQ_ATTN, MAX_SEQ_ATTN = 4, 256, 4096


def attention_inputs(gen, h, kvh, d, bucket, dt):
    """Flash queries [B, H, Sq, d], K and V as [B, KVH, bucket, d] views
    of a [B, max_seq, KV, d] cache (as the model passes them), and a
    decode query [B, H, d]."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    q = rn(B_ATTN, SQ_ATTN, h, d).transpose(1, 2)
    k, v = (rn(B_ATTN, MAX_SEQ_ATTN, kvh, d)[:, :bucket].transpose(1, 2)
            for _ in range(2))
    return q, k, v, rn(B_ATTN, h, d)


def phase_attention(gen):
    """Compare and time the flash and decode attention kernels, each query
    row held to its own limit (``row_ratio``).  The bound counts the live
    KV prefix and the unmasked products.  The library yardstick is
    ``F.scaled_dot_product_attention`` with an explicit mask; the port
    never calls it."""
    import torch.nn.functional as F
    from repro_torch.kernels.attn_decode import ops as dec_ops
    from repro_torch.kernels.attn_decode import ref as dec_ref
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref

    B, SQ = B_ATTN, SQ_ATTN
    dev = "cuda"
    rows = []

    def library(q, k, v, mask, gqa):
        kw = {"enable_gqa": True} if gqa else {}
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=mask, **kw)

    for label, h, kvh, d, bucket, offs, lens in attention_cases():
        for dt in (torch.bfloat16, torch.float32):
            tol = TOL["attention"][dt]
            q, k, v, qd = attention_inputs(gen, h, kvh, d, bucket, dt)
            off = torch.tensor(offs, dtype=torch.int32, device=dev)
            got = flash_ops.flash_attention(q, k, v, q_offset=off)
            want = flash_ref.attention_ref(q, k, v, q_offset=off)
            check_close(f"flash {label} {dt}", [got], [want], tol,
                        ratio=row_ratio)
            vl = torch.tensor(lens, dtype=torch.int32, device=dev)
            dgot = dec_ops.decode_attention(qd, k, v, valid_len=vl)
            dwant = dec_ref.decode_attention_ref(qd, k, v, valid_len=vl)
            check_close(f"decode attention {label} {dt}", [dgot], [dwant],
                        tol, ratio=row_ratio)
            if dt != torch.bfloat16:
                continue
            # flash: live prefix min(off + Sq, bucket) rows per batch row;
            # each query sees min(off + i + 1, bucket) keys, 4d ops each
            live = sum(min(o + SQ, bucket) for o in offs)
            seen = sum(min(o + i + 1, bucket) for o in offs
                       for i in range(SQ))
            esz = q.element_size()
            fb = (2 * B * SQ * h * d * esz + 2 * live * kvh * d * esz)
            bms, by = bound(fb, 4.0 * d * h * seen, dt)
            qpos = off.long()[:, None] + torch.arange(SQ, device=dev)
            mask = (torch.arange(bucket, device=dev)[None, None, :]
                    <= qpos[:, :, None])[:, None]
            rows.append(dict(
                name="flash_attention", route="cuda", at=label,
                source="src/repro_torch/kernels/csrc/flash.cu",
                replaces="src/repro/kernels/flash/kernel.py:124",
                blocks=flash_ops.flash_plan(B, h, kvh, SQ, bucket, d,
                                            dt).blocks,
                max_abs_err=max_err([got], [want]),
                worst_row_of_limit=row_ratio(got, want, tol),
                ms=device_ms(lambda: flash_ops.flash_attention(
                    q, k, v, q_offset=off)),
                plain_ms=device_ms(lambda: flash_ref.attention_ref(
                    q, k, v, q_offset=off)),
                bound_ms=bms, bound_by=by,
                library_ms=device_ms(library(q, k, v, mask, h != kvh))))
            db = (2 * B * h * d * esz + 2 * sum(lens) * kvh * d * esz)
            bms, by = bound(db, 4.0 * d * h * sum(lens), dt)
            dmask = (torch.arange(bucket, device=dev)[None, :]
                     < vl[:, None])[:, None, None, :]
            q4 = qd[:, :, None]
            rows.append(dict(
                name="decode_attention", route="cuda", at=label,
                source="src/repro_torch/kernels/csrc/attn_decode.cu",
                replaces="src/repro/kernels/attn_decode/kernel.py:82",
                blocks=decode_blocks(B, kvh, bucket),
                max_abs_err=max_err([dgot], [dwant]),
                worst_row_of_limit=row_ratio(dgot, dwant, tol),
                ms=device_ms(lambda: dec_ops.decode_attention(
                    qd, k, v, valid_len=vl)),
                plain_ms=device_ms(lambda: dec_ref.decode_attention_ref(
                    qd, k, v, valid_len=vl)),
                bound_ms=bms, bound_by=by,
                library_ms=device_ms(library(q4, k, v, dmask, h != kvh))))
    rows += local_decode(gen, library)
    # valid lengths on the 64-key tile edge and on the split edge, through
    # every split count the rule can pick here and a forced one
    h, kvh, d, bucket = 32, 32, 80, 2048
    _, split_len = dec_ops.split_layout(B, kvh, bucket)
    vl = torch.tensor([1, 64, split_len, split_len + 1], dtype=torch.int32,
                      device=dev)
    for dt in (torch.bfloat16, torch.float32):
        _, k, v, qd = attention_inputs(gen, h, kvh, d, bucket, dt)
        want = dec_ref.decode_attention_ref(qd, k, v, valid_len=vl)
        for sk in (None, 1, 5):
            got = dec_ops.decode_attention(qd, k, v, valid_len=vl,
                                           split_k=sk)
            check_close(f"decode attention edges {vl.tolist()} split {sk} "
                        f"{dt}", [got], [want], TOL["attention"][dt],
                        ratio=row_ratio)
    return rows


def decode_blocks(b: int, kvh: int, seq: int) -> int:
    """The decode kernel's grid: one block per (row, KV head, split)."""
    from repro_torch.kernels.attn_decode import ops as dec_ops
    return b * kvh * dec_ops.split_layout(b, kvh, seq)[0]


LOCAL_DECODE = dict(H=4, KVH=1, d=256, ring=512,
                    valid=[301, 512, 512, 512])      # gemma3-1b local layers


def local_decode(gen, library):
    """Decode attention over gemma3-1b's local layers' 512-slot ring
    caches (``models/attention.py``: ``Skv == window``, ``valid_len =
    min(pos + 1, 512)``), the shape of 1760 of its 2080 decode launches
    in phase 4, in bf16 and fp32, each query row held to its own limit;
    timed in bf16 beside SDPA with the valid-length mask."""
    from repro_torch.kernels.attn_decode import ops as dec_ops
    from repro_torch.kernels.attn_decode import ref as dec_ref

    h, kvh, d, ring, lens = (LOCAL_DECODE[k] for k in
                             ("H", "KVH", "d", "ring", "valid"))
    B = B_ATTN
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        def rn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)
        k, v = (rn(B, ring, kvh, d).transpose(1, 2) for _ in range(2))
        qd = rn(B, h, d)
        vl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = dec_ops.decode_attention(qd, k, v, valid_len=vl)
        want = dec_ref.decode_attention_ref(qd, k, v, valid_len=vl)
        tol = TOL["attention"][dt]
        check_close(f"decode attention gemma3-1b local ring {dt}", [got],
                    [want], tol, ratio=row_ratio)
        if dt != torch.bfloat16:
            continue
        esz = qd.element_size()
        bms, by = bound(2 * B * h * d * esz + 2 * sum(lens) * kvh * d * esz,
                        4.0 * d * h * sum(lens), dt)
        dmask = (torch.arange(ring, device="cuda")[None, :]
                 < vl[:, None])[:, None, None, :]
        rows.append(dict(
            name="decode_attention", route="cuda", at="gemma3-1b local",
            source="src/repro_torch/kernels/csrc/attn_decode.cu",
            replaces="src/repro/kernels/attn_decode/kernel.py:82",
            shape=f"B={B} H={h} KVH={kvh} d={d} ring={ring} valid={lens}",
            blocks=decode_blocks(B, kvh, ring),
            max_abs_err=max_err([got], [want]),
            worst_row_of_limit=row_ratio(got, want, tol),
            ms=device_ms(lambda: dec_ops.decode_attention(
                qd, k, v, valid_len=vl)),
            plain_ms=device_ms(lambda: dec_ref.decode_attention_ref(
                qd, k, v, valid_len=vl)),
            bound_ms=bms, bound_by=by,
            library_ms=device_ms(library(qd[:, :, None], k, v, dmask,
                                         True))))
    return rows


RING = dict(B=4, H=4, KVH=1, d=256, window=512)     # gemma3-1b


def ring_cases():
    """(label, ring_len, Sq, cursors) of the ring mode at gemma3-1b's
    shapes: a 256-query chunk against the full 512-slot ring at cursors
    before and after its wrap (the serving run's chunk); rings sliced by
    a bucket below the window (the serving run's first chunk, where no
    slot is written yet, and one with cursor + Sq <= ring_len); a chunk
    longer than the window."""
    return [("ring", 512, 256, [0, 300, 700, 1792]),
            ("sliced ring", 256, 256, [0, 0, 0, 0]),
            ("sliced ring, partly written", 384, 128, [0, 100, 200, 256]),
            ("chunk past the window", 512, 1024, [0, 300, 700, 1792])]


def phase_ring(gen):
    """Compare and time the flash kernel's ring mode: keys are the model's
    ``[ring | chunk]`` concatenation seen through ``transpose(1, 2)``,
    ``q_offset = kv_wrap``.  Each query row is held to its own limit.  The
    bound counts Q and O once and the K and V slots some query of the
    row sees (written, and inside the window of the chunk), and the
    unmasked products; the library yardstick is SDPA with the boolean
    mask of ``ring_kv_positions``."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref

    B, H, KVH, d, W = (RING[k] for k in ("B", "H", "KVH", "d", "window"))
    rows = []
    for label, ring_len, sq, wraps in ring_cases():
        for dt in (torch.bfloat16, torch.float32):
            def rn(*shape):
                return torch.randn(shape, generator=gen,
                                   device="cuda").to(dt)
            q = rn(B, sq, H, d).transpose(1, 2)
            k, v = (rn(B, ring_len + sq, KVH, d).transpose(1, 2)
                    for _ in range(2))
            wrap = torch.tensor(wraps, dtype=torch.int32, device="cuda")
            kw = dict(causal=True, window=W, q_offset=wrap, kv_wrap=wrap,
                      ring_len=ring_len)
            got = flash_ops.flash_attention(q, k, v, **kw)
            want = flash_ref.attention_ref(q, k, v, **kw)
            tol = TOL["attention"][dt]
            check_close(f"flash ring {label} {dt}", [got], [want], tol,
                        ratio=row_ratio)
            if dt != torch.bfloat16 and label != "ring":
                continue
            kpos = flash_ref.ring_kv_positions(wrap, W, ring_len,
                                               ring_len + sq).long()
            qpos = wrap.long()[:, None] + torch.arange(sq, device="cuda")
            mask = ((kpos[:, None, :] >= 0)
                    & (qpos[:, :, None] >= kpos[:, None, :])
                    & (qpos[:, :, None] - kpos[:, None, :] < W))
            live = int(mask.any(1).sum())          # K/V slots some query sees
            esz = q.element_size()
            bms, by = bound(2 * B * sq * H * d * esz + 2 * live * KVH * d * esz,
                            4.0 * d * H * float(mask.sum()), dt)
            rows.append(dict(
                name="flash_attention_ring", route="cuda",
                at=f"gemma3-1b {label}", dtype=str(dt)[6:],
                source="src/repro_torch/kernels/csrc/flash.cu",
                replaces="src/repro/kernels/flash/kernel.py:124",
                shape=f"B={B} H={H} KVH={KVH} d={d} window={W} "
                      f"ring_len={ring_len} Sq={sq} cursors={wraps}",
                blocks=flash_ops.flash_plan(B, H, KVH, sq, ring_len + sq, d,
                                            dt).blocks,
                max_abs_err=max_err([got], [want]),
                worst_row_of_limit=row_ratio(got, want, tol),
                ms=device_ms(lambda: flash_ops.flash_attention(q, k, v,
                                                               **kw)),
                plain_ms=device_ms(lambda: flash_ref.attention_ref(
                    q, k, v, **kw)),
                bound_ms=bms, bound_by=by,
                library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask[:, None], enable_gqa=True))))
    return rows


# the launch counters: name -> (wrapper, attribute); the ring mode's
# counter is the flash kernel's ``ring_launches``
def counters():
    from repro_torch.serving.graphs import LAUNCH_COUNTERS
    return {fn.__name__ + ("_ring" if attr == "ring_launches" else ""):
            (fn, attr) for fn, attr in LAUNCH_COUNTERS}


def reset_counters():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counters():
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def path_kernels(cfg):
    """The kernels a serving run of ``cfg`` launches, by its layer kinds;
    every other kernel must stay at 0."""
    kinds = set(cfg.layer_kinds)
    names = set()
    if kinds & {"mamba2", "mamba2+shared", "hybrid_par"}:
        names |= {"causal_conv1d", "ssd_chunked", "mamba2_decode_fused"}
    if "mamba1" in kinds:
        names |= {"causal_conv1d", "selective_scan", "mamba1_decode_fused"}
    if kinds & {"dense", "mamba2+shared", "hybrid_par"}:
        names |= {"flash_attention", "decode_attention"}
    if "local" in kinds:
        names |= {"flash_attention_ring", "decode_attention"}
    return names


def exact_launches(cfg, chunks: int, steps: int) -> dict:
    """Every kernel's exact launches in a serving run of ``chunks`` prefill
    chunks and ``steps`` decode token steps: per layer and chunk one flash
    launch (ring layers in ring mode), one conv1d and one SSD or scan
    launch; per layer and token step one decode attention or decode step
    launch.  A ``hybrid_par`` layer counts both halves: one flash, one
    conv1d and one SSD launch a chunk, one decode attention and one
    Mamba-2 decode step launch a token step."""
    kinds = cfg.layer_kinds
    n_par = kinds.count("hybrid_par")
    n_ring = kinds.count("local")
    n_plain = kinds.count("dense") + kinds.count("mamba2+shared") + n_par
    n_m2 = kinds.count("mamba2") + kinds.count("mamba2+shared") + n_par
    n_m1 = kinds.count("mamba1")
    return {"flash_attention": n_plain * chunks,
            "flash_attention_ring": n_ring * chunks,
            "decode_attention": (n_plain + n_ring) * steps,
            "causal_conv1d": (n_m2 + n_m1) * chunks,
            "ssd_chunked": n_m2 * chunks,
            "selective_scan": n_m1 * chunks,
            "mamba2_decode_fused": n_m2 * steps,
            "mamba1_decode_fused": n_m1 * steps}


@contextlib.contextmanager
def state_copies():
    """Count the state leaves ``models.lm._store_state`` copies into a new
    cache (each layer's call once, its nested calls inside it): a leaf a
    kernel wrote into its slot is not copied."""
    from repro_torch.models import lm as lm_mod
    real = lm_mod._store_state
    count, depth = [0], [0]

    def counted(dst, src, r):
        depth[0] += 1
        try:
            n = real(dst, src, r)
        finally:
            depth[0] -= 1
        if depth[0] == 0:
            count[0] += n
        return n
    with mock.patch.object(lm_mod, "_store_state", counted):
        yield count


def phase_serving(cfg, gen):
    """Serve 4 ragged requests at full width and depth."""
    import numpy as np
    from repro_torch.models.lm import init_lm_params, lm_prefill_chunk
    from repro_torch.serving.bucketing import clamped_bucket
    from repro_torch.serving.engine import Request, ServingEngine

    params = init_lm_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(0)
    lens = (300, 700, 1000, 2048)
    max_new = 32

    def engine():
        return ServingEngine(cfg, params, slots=4, max_seq=4096,
                             chunk_size=256, decode_block=8, device="cuda")

    # warm-up: one short request through both phases (cuBLAS handles, the
    # kernels' first launches); not part of the measured run
    warm = engine()
    warm.submit(Request(rid=-1, prompt=rng.integers(0, cfg.vocab_size, 16),
                        max_new=9))
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    eng = engine()
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n),
                    max_new=max_new) for i, n in enumerate(lens)]
    # token steps the engine's decode bursts run (every slot steps at once),
    # counted at the engine's burst call (a CUDA graph replay after the
    # first burst at each key)
    token_steps, bursts = [0], [0]
    real_decode = eng._decode_n

    def counted_decode(params_, cache, first, n, *a, **kw):
        token_steps[0] += n
        bursts[0] += 1
        return real_decode(params_, cache, first, n, *a, **kw)

    reset_counters()
    t0 = time.monotonic()
    eng._decode_n = counted_decode
    for r in reqs:
        eng.submit(r)
    decode_tok, decode_s = 0, 0.0
    while True:
        chunks = eng.stats["prefill_chunks"]
        toks = eng.stats["decode_tokens"]
        ts = time.monotonic()
        left = eng.step()
        torch.cuda.synchronize()
        if eng.stats["prefill_chunks"] == chunks:   # a decode-only step
            decode_tok += eng.stats["decode_tokens"] - toks
            decode_s += time.monotonic() - ts
        if not (left or eng.queue or eng._pending):
            break
    wall = time.monotonic() - t0
    served_peak = torch.cuda.max_memory_allocated()
    eng._decode_n = real_decode
    launches = read_counters()
    for r in reqs:
        if r.status != "ok" or len(r.out) != max_new:
            raise AssertionError(f"rid={r.rid}: status {r.status}, "
                                 f"{len(r.out)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"rid={r.rid}: token outside the vocab")
    on_path = path_kernels(cfg)
    for k, n in launches.items():
        if (n > 0) != (k in on_path):
            raise AssertionError(f"{k}: {n} launches on the serving path of "
                                 f"{cfg.name}; its kernels are "
                                 f"{sorted(on_path)}")
    want = exact_launches(cfg, eng.stats["prefill_chunks"], token_steps[0])
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{cfg.name}: launches {got}, "
                             f"expected {want} ({eng.stats['prefill_chunks']} "
                             f"chunks, {token_steps[0]} token steps)")
    # every burst ran through the graphs: the first at each key eagerly
    # (then captured), every later one as a replay
    runner = real_decode
    served_graphs = dict(bursts=bursts[0], captures=runner.captures,
                         replays=runner.replays,
                         keys=[list(k) for k in runner.keys],
                         capture_ms=list(runner.capture_ms.values()))
    if (runner.captures != len(runner.keys) or runner.replays == 0
            or runner.captures + runner.replays != bursts[0]):
        raise AssertionError(f"{cfg.name}: served bursts not replayed: "
                             f"{served_graphs}")
    steady = phase_steady_bursts(cfg, eng, gen)
    # one prefill chunk of 4 x 256 tokens, as the engine runs it
    pos = steady.pop("pos")
    chunk = torch.randint(0, cfg.vocab_size, (4, 256), generator=gen,
                          device="cuda")
    with state_copies() as copied:
        chunk_busy = device_busy(lambda: lm_prefill_chunk(
            cfg, eng.params, chunk, eng.cache,
            kv_bucket=clamped_bucket(max(pos) + 256, eng.kv_extent),
            rope_len=eng.rope_len)[0].cpu())
    chunk_busy["state_leaves_copied"] = copied[0]
    ttft = {r.rid: (r.first_t - r.submit_t) * 1e3 for r in reqs}
    return dict(ttft_ms=ttft, wall_s=wall,
                checkpoints=eng.stats["checkpoints"],
                ckpt_ms=eng.stats["ckpt_ms"],
                ckpt_share_of_wall=eng.stats["ckpt_ms"] / (wall * 1e3),
                checkpoint_bytes=eng.metrics.counter(
                    "repro_checkpoint_bytes_total").value,
                serve_decode_only_tokens_per_s=(
                    decode_tok / decode_s if decode_s else None),
                decode_only_tokens=decode_tok, served_graphs=served_graphs,
                **steady,
                profiled_prefill_chunk_b4_s256=chunk_busy,
                prefill_chunks=eng.stats["prefill_chunks"],
                decode_token_steps=token_steps[0],
                max_memory_allocated=served_peak), launches


def clone_cache(cache):
    from repro_torch.models.params import tree_map
    return {"segments": tree_map(torch.clone, cache["segments"]),
            "pos": cache["pos"].clone()}


def graph_pool_bytes(runner) -> int:
    """Bytes of the CUDA caching allocator's segments in ``runner``'s graph
    memory pool."""
    pool = tuple(runner._pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool)


def phase_steady_bursts(cfg, eng, gen):
    """Steady 8-token bursts with all 4 slots live on the served cache,
    under the KV bucket the engine would pick, both ways: eager
    ``decode_tokens`` with the engine's spare state set, then the engine's
    graph runner (``decode_n``), each taking its tokens and positions from
    the host and handing its tokens back, as the engine's step does.  The
    positions stay where the served run left them, so every burst runs at
    one key (it rewrites the same 8 KV rows; the states move on).  Burst
    ms (median of 3 after one more), tokens/s, a profiled burst each way
    (idle share, kernels, memcpys; the graph's no more than eager's; the
    fullest of three profiles), the
    idle share of the profiled kernel time against the unprofiled burst,
    the state leaves the eager burst copies (none: even bursts end in the
    cache's own leaves); then the graph bursts against eager bursts from
    cloned caches, without and with the sentinel: tokens, ``ok`` and every
    cache leaf bit for bit; the keys captured, each capture's ms, the
    spare state set's and the graph pool's bytes and the peak memory."""
    from repro_torch.models.lm import decode_tokens
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.bucketing import clamped_bucket
    runner, spare = eng._decode_n, eng._spare
    pos = [int(p) for p in eng.cache["pos"].tolist()]
    pos_h = torch.tensor(pos, dtype=torch.int32)
    first_h = torch.randint(0, cfg.vocab_size, (4, 1), dtype=torch.int32)
    bucket = clamped_bucket(max(pos) + 8, eng.kv_extent)
    kw = dict(kv_bucket=bucket, rope_len=eng.rope_len)

    def eager():
        toks, eng.cache = decode_tokens(
            cfg, eng.params, dict(eng.cache, pos=pos_h.to("cuda")),
            first_h.to("cuda"), 8, _spare_states=spare, **kw)
        toks.cpu()

    def graph():
        toks, eng.cache = runner(eng.params, dict(eng.cache, pos=pos_h),
                                 first_h, 8, spare=spare, **kw)
        toks.cpu()

    out = {"pos": pos}
    captures0 = runner.captures
    torch.cuda.reset_peak_memory_stats()
    for name, burst in (("eager", eager), ("graph", graph)):
        times = []
        for _ in range(4):
            ts = time.monotonic()
            burst()
            times.append(time.monotonic() - ts)
        burst_s = statistics.median(times[1:])
        if name == "eager":
            with state_copies() as copied:
                burst()
        out[f"steady_b4_burst8_{name}_ms"] = burst_s * 1e3
        out[f"steady_b4_{name}_tokens_per_s"] = 4 * 8 / burst_s
        # the tracer drops a few records of a long eager trace in some
        # runs (never adds any): the fullest of three profiles is kept
        busy = out[f"profiled_decode_burst8_b4_{name}"] = max(
            (device_busy(burst) for _ in range(3)),
            key=lambda p: (p["kernels"], p["memcpys"]))
        # the profiled kernel time over the unprofiled burst: the tracer
        # slows the host (most of all a graph launch of ~15k nodes)
        out[f"idle_share_vs_unprofiled_burst_{name}"] = (
            1 - busy["kernel_busy_ms"] / (burst_s * 1e3))
    out["eager_burst_state_leaves_copied"] = copied[0]
    if copied[0]:
        raise AssertionError(f"{cfg.name}: an 8-step burst copied "
                             f"{copied[0]} state leaves")
    prof = {k: out[f"profiled_decode_burst8_b4_{k}"]
            for k in ("eager", "graph")}
    for what in ("kernels", "memcpys"):
        if prof["graph"][what] > prof["eager"][what]:
            raise AssertionError(f"{cfg.name}: graph burst {what} "
                                 f"{prof['graph'][what]} > eager "
                                 f"{prof['eager'][what]}")
    # bit-identity: the sentinel key is captured first, so both checks
    # below are replays
    runner(eng.params, dict(eng.cache, pos=pos_h), first_h, 8,
           with_sentinel=True, spare=spare, **kw)
    for sentinel in (False, True):
        want = decode_tokens(cfg, eng.params,
                             clone_cache(dict(eng.cache,
                                              pos=pos_h.to("cuda"))),
                             first_h.to("cuda"), 8, with_sentinel=sentinel,
                             **kw)
        replays = runner.replays
        got = runner(eng.params, dict(eng.cache, pos=pos_h), first_h, 8,
                     with_sentinel=sentinel, spare=spare, **kw)
        eng.cache = got[1]
        if runner.replays != replays + 1:
            raise AssertionError(f"{cfg.name}: the checked burst was not "
                                 "a replay")
        pairs = list(zip(tree_leaves(got), tree_leaves(want)))
        if len(tree_leaves(got)) != len(tree_leaves(want)) or not all(
                a.shape == b.shape and torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"{cfg.name}: graph burst (sentinel "
                                 f"{sentinel}) differs from the eager burst")
        if sentinel and not bool(got[2].all()):
            raise AssertionError(f"{cfg.name}: sentinel flags a row")
    out["graph_vs_eager_bit_identical"] = True
    out["steady_keys_captured"] = runner.captures - captures0
    out["graph_keys"] = [list(k) for k in runner.keys]
    out["capture_ms_per_key"] = list(runner.capture_ms.values())
    out["steady_peak_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["spare_state_bytes"] = nbytes(*tree_leaves(spare))
    out["graph_pool_bytes"] = graph_pool_bytes(runner)
    return out


def phase_paths(cfg, gen, n_layers: int, compute_dtype: str = "bfloat16",
                prompt_len: int = 512):
    """Kernel path against plain path on the card: ``n_layers`` layers, one
    ``prompt_len``-token prompt in 256-token chunks (a ragged last chunk
    where it does not divide), on a cache of ``2 * prompt_len`` rows, then
    8 teacher-forced decode steps, in ``compute_dtype`` (the caches too).
    Logits agree within 5% of max
    |logit| in bf16 (each bf16 rounding is worth 2^-8 of its value, and
    the two paths round at different points) and 1e-4 in fp32 (sums in
    another order)."""
    from repro_torch.kernels.attn_decode import ref as attn_dec_ref
    from repro_torch.kernels.conv1d import ref as conv_ref
    from repro_torch.kernels.decode_fused import ref as dec_ref
    from repro_torch.kernels.flash import ref as flash_ref
    from repro_torch.kernels.scan1 import ref as scan_ref
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.models import attention as attn
    from repro_torch.models import mamba1 as m1
    from repro_torch.models import mamba2 as m2
    from repro_torch.models.lm import (init_lm_cache, init_lm_params,
                                       lm_decode_step, prepare_params)
    from repro_torch.serving.prefill import chunked_prefill

    cfg8 = dataclasses.replace(cfg, n_layers=n_layers,
                               compute_dtype=compute_dtype)
    cache_dtype = getattr(torch, compute_dtype)
    params = prepare_params(cfg8, init_lm_params(cfg8, gen, device="cuda"))
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen,
                           device="cuda")

    def run(forced):
        cache = init_lm_cache(cfg8, 1, 2 * prompt_len, dtype=cache_dtype,
                              device="cuda")
        lg, cache = chunked_prefill(cfg8, params, prompt, cache,
                                    chunk_size=256)
        out = [lg[:, 0, :cfg.vocab_size].float()]
        for i in range(8):
            tok = (forced[i] if forced is not None
                   else out[-1].argmax(-1, keepdim=True).to(torch.int32))
            lg, cache = lm_decode_step(cfg8, params, tok, cache)
            out.append(lg[:, 0, :cfg.vocab_size].float())
        toks = [o.argmax(-1, keepdim=True).to(torch.int32) for o in out]
        return torch.cat(out), toks

    kern, toks = run(None)

    def plain_ssd(x, dt_raw, dt_bias, A_log, Bm, Cm, D, *, chunk,
                  initial_state, out_state=None):
        dt, A = ssd_ref.preprocess_dt_A(dt_raw, dt_bias, A_log)
        return ssd_ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=chunk,
                                       initial_state=initial_state,
                                       out_state=out_state)

    def plain_conv(x, w, b, *, initial_state=None, activation="silu",
                   lengths=None, out_state=None):
        return conv_ref.causal_conv1d_ref(x, w, b, initial_state, activation,
                                          lengths=lengths,
                                          out_state=out_state)

    def plain_flash(q, k, v, *, causal=True, window=None, q_offset=None,
                    kv_wrap=None, ring_len=None):
        return flash_ref.attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=0 if q_offset is None
                                       else q_offset, kv_wrap=kv_wrap,
                                       ring_len=ring_len)

    def plain_scan(x, dt, A, Bm, Cm, D, *, initial_state=None,
                   out_state=None):
        return scan_ref.selective_scan_ref(x, dt, A, Bm, Cm, D, initial_state,
                                           out_state=out_state)

    reset_counters()
    with mock.patch.object(m2, "causal_conv1d", plain_conv), \
            mock.patch.object(m2, "ssd_chunked_raw", plain_ssd), \
            mock.patch.object(m2, "mamba2_decode_fused",
                              dec_ref.mamba2_decode_fused_ref), \
            mock.patch.object(m1, "causal_conv1d", plain_conv), \
            mock.patch.object(m1, "selective_scan", plain_scan), \
            mock.patch.object(m1, "mamba1_decode_fused",
                              dec_ref.mamba1_decode_fused_ref), \
            mock.patch.object(attn, "flash_attention", plain_flash), \
            mock.patch.object(attn, "decode_attention",
                              attn_dec_ref.decode_attention_ref):
        plain, _ = run(toks)
    launched = {k: n for k, n in read_counters().items() if n}
    if launched:
        raise AssertionError(f"the plain path launched kernels: {launched}")
    if not (torch.isfinite(kern).all() and torch.isfinite(plain).all()):
        raise AssertionError("non-finite logits")
    err = float((kern - plain).abs().max())
    tol = (0.05 if compute_dtype == "bfloat16" else 1e-4) * float(
        plain.abs().max())
    if err > tol:
        raise AssertionError(f"logits differ by {err} > {tol}")
    top2 = plain.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    agree = kern.argmax(-1) == plain.argmax(-1)
    checked = margin > 2 * err
    if not bool(agree[checked].all()):
        raise AssertionError("greedy tokens disagree above the margin")
    return dict(max_abs_logit_err=err, tol=tol,
                max_abs_logit=float(plain.abs().max()),
                steps_checked=int(checked.sum()), steps=int(agree.numel()),
                steps_agree=int(agree.sum()))


def phase_long_prefill(cfg, gen, names, seq: int = 16384, chunk: int = 256,
                       decode: int = 0, burst: int = 8):
    """One ``seq``-token prompt at B=1 through ``lm_prefill`` at ``cfg``'s
    full width and depth in bf16, random weights from ``gen``: its wall
    time (host clock to a synchronise, after one warm-up call), its
    kernel time and the share of it of each kernel in ``names`` (one
    profiled call, whose launches must be exactly one per layer and
    kernel, as one chunk's), and its last logits against the same prompt
    in ``chunk``-token chunks through ``lm_prefill_chunk`` under the
    serving buckets, both on the kernel path, within phase 5's bf16
    limit (5% of max |logit|): two splits of the sequence carry the
    state through every layer differently.  With ``decode`` > 0, then
    ``decode`` greedy tokens at that context through the serving layer's
    graph burst (``make_decode_tokens``, ``burst`` steps a call, the
    spare state set): the first burst at the key runs eagerly and is
    captured, untimed; the next ``decode / burst`` are replays, timed
    together (host clock to a synchronise): ms per token step."""
    from repro_torch.models.lm import (cache_kv_extent, init_lm_cache,
                                       init_lm_params, init_spare_states,
                                       lm_prefill, lm_prefill_chunk,
                                       prepare_params)
    from repro_torch.serving.bucketing import clamped_bucket
    from repro_torch.serving.graphs import make_decode_tokens

    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    params = prepare_params(cfg, init_lm_params(cfg, gen, device="cuda"))
    prompt = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                           device="cuda")
    # KV rows for the prompt and the decoded tokens
    rows = seq + (decode + burst if decode else 0)

    def cache():
        return init_lm_cache(cfg, 1, rows, dtype=torch.bfloat16,
                             device="cuda")

    def one_shot():
        return lm_prefill(cfg, params, prompt, cache())

    one_shot()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    whole, full = one_shot()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    first = whole[:, 0, :cfg.vocab_size].argmax(-1, keepdim=True).to(
        torch.int32)
    whole = whole[:, 0, :cfg.vocab_size].float()
    reset_counters()
    busy = device_busy(one_shot, names=names)
    launched = {k: n for k, n in read_counters().items() if n}
    want = {k: n for k, n in exact_launches(cfg, 1, 0).items() if n}
    if launched != want:
        raise AssertionError(f"one prefill launched {launched}, expected "
                             f"{want}")
    c = cache()
    extent = cache_kv_extent(c)
    t0 = time.monotonic()
    for i in range(0, seq, chunk):
        lg, c = lm_prefill_chunk(cfg, params, prompt[:, i:i + chunk], c,
                                 kv_bucket=clamped_bucket(i + chunk, extent))
    torch.cuda.synchronize()
    chunked_wall = time.monotonic() - t0
    del c
    lg = lg[:, 0, :cfg.vocab_size].float()
    if not (torch.isfinite(whole).all() and torch.isfinite(lg).all()):
        raise AssertionError("non-finite logits")
    err = float((whole - lg).abs().max())
    tol = 0.05 * float(lg.abs().max())
    if err > tol:
        raise AssertionError(f"one-shot and chunked logits differ by {err} "
                             f"> {tol}")
    out = dict(wall_ms=wall * 1e3, kernel_busy_ms=busy["kernel_busy_ms"],
               kernels=busy["kernels"], by_kernel=busy["by_name"],
               launches=launched, chunked_wall_ms=chunked_wall * 1e3,
               chunks=seq // chunk, max_abs_logit_err=err, tol=tol,
               argmax_agree=bool((whole.argmax(-1) == lg.argmax(-1)).all()))
    if not decode:
        return out
    runner = make_decode_tokens(cfg)
    spare = init_spare_states(full)
    extent = cache_kv_extent(full)

    def step(tok, cache_):
        pos = int(cache_["pos"].max())
        return runner(params, cache_, tok, burst, spare=spare,
                      kv_bucket=clamped_bucket(pos + burst, extent))

    toks, full = step(first, full)          # eager, then captured
    torch.cuda.synchronize()
    out_toks = []
    replays = runner.replays
    t0 = time.monotonic()
    for _ in range(decode // burst):
        toks, full = step(toks[:, -1:], full)
        out_toks.append(toks.clone())     # the graph's buffer: rewritten
    torch.cuda.synchronize()
    dec_s = time.monotonic() - t0
    toks = torch.cat(out_toks, 1)
    if runner.replays - replays != decode // burst:
        raise AssertionError("the long-context decode bursts were not "
                             "replays")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("a decoded token outside the vocab")
    out.update(decode_tokens=int(toks.numel()), decode_burst=burst,
               decode_ms_per_token_step=dec_s * 1e3 / toks.shape[1],
               decode_kv_bucket=runner.keys[-1][2] if runner.keys else None,
               decode_captures=runner.captures)
    return out


# ------------------------------------------------- phase 7: engine control

def control_requests(cfg, spec, seed):
    """Requests from ``(rid, prompt_len, max_new, priority)`` tuples, their
    prompts drawn from ``seed``: every run of a phase-7 traffic gets the
    same prompts."""
    import numpy as np
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    prompts = {rid: rng.integers(0, cfg.vocab_size, n)
               for rid, n, _, _ in spec}
    return lambda: [Request(rid=rid, prompt=prompts[rid], max_new=m,
                            priority=p) for rid, _, m, p in spec]


def serve_control(cfg, params, first, later=(), **kw):
    """One phase-7 run: ``ServingEngine(slots=4, max_seq=4096,
    chunk_size=256, decode_block=8)`` under ``strict_tiers`` with the
    engine's defaults (sentinel, a checkpoint every 8 iterations) unless
    ``kw`` says otherwise; ``first`` is submitted, and ``later`` once every
    request of ``first`` is live.  Each burst is timed (synchronized) and
    marked when it was the first at its key (an eager run and a capture).
    Returns (engine, its graph runner, the bursts' (ms, first), wall s,
    the iteration count when all of ``first`` were live); a
    ``SimulatedCrash`` escapes with the engine on ``.engine``."""
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, params, slots=4, max_seq=4096, chunk_size=256,
                        decode_block=8, device="cuda",
                        sched_policy="strict_tiers", **kw)
    runner, times = eng._decode_n, []
    eng._runner = runner

    def timed(*a, **k):
        caps = runner.captures
        t0 = time.perf_counter()
        out = runner(*a, **k)
        torch.cuda.synchronize()
        times.append(((time.perf_counter() - t0) * 1e3,
                      runner.captures > caps))
        return out
    eng._decode_n = timed
    t0 = time.monotonic()
    for r in first:
        eng.submit(r)
    all_live = None
    try:
        while True:
            left = eng.step()
            if all_live is None and sum(
                    r is not None for r in eng.live) == len(first):
                all_live = eng.stats["iters"]
                for r in later:
                    eng.submit(r)
            if not (left or eng.queue or eng._open_pending()):
                break
    except Exception as e:
        e.engine = eng
        raise
    torch.cuda.synchronize()
    return eng, runner, times, time.monotonic() - t0, all_live


def control_summary(eng, runner, times, wall, bucket):
    """What each phase-7 run prints."""
    steady = sorted(ms for ms, first in times if not first)
    st = eng.stats
    return dict(
        wall_s=wall, iters=st["iters"], prefill_chunks=st["prefill_chunks"],
        bursts=len(times), preemptions=st["preemptions"],
        restores=st["restores"], divergences=st["divergences"],
        replays=st["replays"], failures=st["failures"],
        checkpoints=st["checkpoints"], ckpt_ms=st["ckpt_ms"],
        ckpt_share_of_wall=st["ckpt_ms"] / (wall * 1e3),
        ckpt_within_5pct_budget=st["ckpt_ms"] < 0.05 * wall * 1e3,
        checkpoint_bytes=eng.metrics.counter(
            "repro_checkpoint_bytes_total").value,
        captures=runner.captures, replays_of_graphs=runner.replays,
        keys=[list(k) for k in runner.keys],
        capture_bursts_ms=[ms for ms, first in times if first],
        steady_burst_ms_per_step=(
            statistics.median(steady) / 8 if steady else None),
        telemetry_decode_estimate_ms=eng.telemetry.estimate("decode",
                                                            bucket))


def slot_transfer(eng, reps: int = 3) -> dict:
    """Offload slot 0 of the engine's cache to the host and restore it in
    place, ``reps`` times (the first also allocates the pinned buffers):
    MB, and ms of each (synchronized), the last ``reps - 1`` medians, and
    of each the ms spent in the host's crc32 (``cache._payload_crc``)."""
    from repro_torch.serving import cache as cache_mod
    real_crc, crc_s = cache_mod._payload_crc, [0.0]

    def timed_crc(a):
        t0 = time.perf_counter()
        try:
            return real_crc(a)
        finally:
            crc_s[0] += time.perf_counter() - t0
    off, back, off_crc, back_crc = [], [], [], []
    with mock.patch.object(cache_mod, "_payload_crc", timed_crc):
        for _ in range(reps):
            torch.cuda.synchronize()
            crc_s[0] = 0.0
            t0 = time.perf_counter()
            blob = cache_mod.offload_slot(eng._host_pos_cache(), 0)
            t1 = time.perf_counter()
            off_crc.append(crc_s[0] * 1e3)
            crc_s[0] = 0.0
            cache_mod.restore_slot(eng.cache, blob, 0)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            back_crc.append(crc_s[0] * 1e3)
            off.append((t1 - t0) * 1e3)
            back.append((t2 - t1) * 1e3)
    return dict(slot_mb=cache_mod.blob_nbytes(blob) / 1e6, offload_ms=off,
                restore_ms=back, offload_crc_ms=off_crc,
                restore_crc_ms=back_crc,
                offload_ms_warm=statistics.median(off[1:]),
                restore_ms_warm=statistics.median(back[1:]))


def check_preemption(name, u, p, bucket):
    """Run P against run U (phase 7 (a), (c)): every class-0 stream bit for
    bit, at least one preemption and every victim restored, every request
    ok, no graph key beyond U's and every burst at one rung."""
    eng_u, run_u = u[0], u[1]
    eng_p, run_p = p[0], p[1]
    out_u = {r.rid: r.out for r in eng_u.finished}
    bad = [r.rid for r in eng_p.finished if r.status != "ok"]
    if bad or len(eng_p.finished) != len(eng_u.finished) + 2:
        raise AssertionError(f"{name}: run P requests not ok: {bad}")
    for r in eng_p.finished:
        if r.priority == 0 and r.out != out_u[r.rid]:
            raise AssertionError(f"{name}: rid={r.rid} resumed stream "
                                 "differs from the uninterrupted run")
    st = eng_p.stats
    if st["preemptions"] < 1 or st["restores"] != st["preemptions"]:
        raise AssertionError(f"{name}: {st['preemptions']} preemptions, "
                             f"{st['restores']} restores")
    if not set(run_p.keys) <= set(run_u.keys) or \
            run_p.captures != run_u.captures or \
            run_p.captures != len(run_p.keys):
        raise AssertionError(f"{name}: graph keys {run_p.keys} "
                             f"({run_p.captures} captures) against "
                             f"{run_u.keys} ({run_u.captures})")
    if {k[2] for k in run_u.keys + run_p.keys} != {bucket}:
        raise AssertionError(f"{name}: bursts off the {bucket} rung: "
                             f"{run_u.keys + run_p.keys}")


def first_preempted(eng):
    """The rid of the request the engine preempted first."""
    when = {}
    for span in eng.telemetry.finished_spans:
        ts = [e["t"] for e in span["events"] if e["kind"] == "preempt"]
        if ts:
            when[span["rid"]] = min(ts)
    return min(when, key=when.get)


def phase_control(gen):
    """Phase 7: the engine's control layer on the card (module docstring)."""
    import shutil
    from repro_torch.configs import gemma3_1b, zamba2_2p7b
    from repro_torch.models.lm import init_lm_params
    from repro_torch.serving.fault_inject import FaultPlan, SimulatedCrash
    from repro_torch.serving.faults import CacheCorruption
    from repro_torch.serving.store import CheckpointStore
    out = {}

    def release(*runs):
        """Free the runs' caches, templates and graphs."""
        for run in runs:
            eng, runner = run[0], run[1]
            runner._bursts.clear()
            runner._pool = None
            eng.cache = eng._spare = eng._chunked_prefill = None
            eng._decode_n = None
        torch.cuda.empty_cache()

    # (a), (b): zamba2-2.7b, every burst at the 2048 rung
    cfg = zamba2_2p7b
    params = init_lm_params(cfg, gen, device="cuda")
    first = control_requests(cfg, [(i, n, 48, 0) for i, n in
                                   enumerate((1100, 1300, 1500, 1700))], 7)
    later = control_requests(cfg, [(4, 1200, 16, 1), (5, 1600, 16, 1)], 8)
    u = serve_control(cfg, params, first())
    out["a_run_U"] = dict(control_summary(*u[:4], 2048),
                          one_slot=slot_transfer(u[0]))
    with state_copies() as copied:
        p = serve_control(cfg, params, first(), later())
    check_preemption(cfg.name, u, p, 2048)
    if copied[0]:
        raise AssertionError(f"{cfg.name}: run P copied {copied[0]} state "
                             "leaves")
    out["a_run_P"] = dict(control_summary(*p[:4], 2048),
                          state_leaves_copied=copied[0],
                          class0_bit_identical_to_U=True)
    victim = first_preempted(p[0])
    out_u = {r.rid: r.out for r in u[0].finished}
    out_p = {r.rid: r.out for r in p[0].finished}
    release(p)
    # (b) a NaN poked into slot 1 once all four are live (each has its
    # first checkpoint), then a corrupt preemption blob
    n = serve_control(cfg, params, first(),
                      fault_plan=FaultPlan.from_spec(
                          f"nan_decode@iter={u[4]}:slot=1"))
    got = {r.rid: (r.status, r.out) for r in n[0].finished}
    if n[0].stats["divergences"] != 1 or n[0].stats["replays"] != 1 or \
            got != {rid: ("ok", o) for rid, o in out_u.items()}:
        raise AssertionError(f"{cfg.name}: NaN replay: {n[0].stats}")
    out["b_nan_replay"] = control_summary(*n[:4], 2048)
    release(n, u)
    c = serve_control(cfg, params, first(), later(), checkpoint_every=0,
                      fault_plan=FaultPlan.from_spec(
                          f"corrupt_blob@rid=r{victim}", seed=5))
    for r in c[0].finished:
        want = (("failed", CacheCorruption) if r.rid == victim
                else ("ok", type(None)))
        if (r.status, type(r.error)) != want or \
                (r.status == "ok" and r.out != out_p[r.rid]):
            raise AssertionError(f"{cfg.name}: corrupt blob of rid="
                                 f"{victim}: rid={r.rid} {r.status} "
                                 f"{r.error}")
    out["b_corrupt_blob"] = dict(control_summary(*c[:4], 2048),
                                 victim=victim,
                                 error=str(next(r.error for r in c[0].finished
                                                if r.rid == victim)))
    release(c)
    del params
    torch.cuda.empty_cache()

    # (c) gemma3-1b: 600-900-token prompts past the 512-slot rings, every
    # burst at the 1024 rung; preemption across the wrap, then a kill
    cfg = gemma3_1b
    params = init_lm_params(cfg, gen, device="cuda")
    first = control_requests(cfg, [(i, n, 48, 0) for i, n in
                                   enumerate((600, 700, 800, 900))], 9)
    later = control_requests(cfg, [(4, 650, 16, 1), (5, 850, 16, 1)], 10)
    u = serve_control(cfg, params, first())
    out["c_run_U"] = dict(control_summary(*u[:4], 1024),
                          one_slot=slot_transfer(u[0]))
    p = serve_control(cfg, params, first(), later())
    check_preemption(cfg.name, u, p, 1024)
    out["c_run_P"] = control_summary(*p[:4], 1024)
    out_u = {r.rid: r.out for r in u[0].finished}
    release(p, u)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "repro_torch", "control_store")
    shutil.rmtree(root, ignore_errors=True)
    kill_at = u[4] + 2
    try:
        serve_control(cfg, params, first(), store=CheckpointStore(root),
                      fault_plan=FaultPlan.from_spec(f"kill@iter={kill_at}"))
        raise AssertionError(f"{cfg.name}: the kill at iteration {kill_at} "
                             "did not fire")
    except SimulatedCrash as e:
        crashed = e.engine
    done_before = {r.rid: r.out for r in crashed.finished}
    release((crashed, crashed._runner))
    r2 = serve_control(cfg, params, [], store=CheckpointStore(root))
    got = dict(done_before)
    got.update({r.rid: r.out for r in r2[0].finished})
    if got != out_u or any(r.status != "ok" for r in r2[0].finished):
        raise AssertionError(f"{cfg.name}: streams after the kill differ")
    out["c_kill_and_resume"] = dict(control_summary(*r2[:4], 1024),
                                    kill_at_iter=kill_at,
                                    recovery=r2[0].recovery,
                                    bit_identical_to_U=True)
    release(r2)
    shutil.rmtree(root, ignore_errors=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    from repro_torch.configs import (falcon_h1_05b, gemma3_1b, glm4_9b,
                                     hymba_15b, llama3_8b, mamba2_2p7b,
                                     mamba_130m, smollm_135m, zamba2_2p7b)
    from repro_torch.configs.paper_models import PHI3_MINI, QWEN25_05B
    from repro_torch.kernels import build

    card = card_line()
    print(f"phase 1 card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 1 reference comparisons with allow_tf32 = False "
          f"(matmul, cudnn); torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    build.library()
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for cfg in (mamba2_2p7b, zamba2_2p7b, falcon_h1_05b):
        for r in phase_kernels(cfg, gen):
            rows.append(dict(r, at=cfg.name))
    rows += phase_attention(gen)
    m1_rows, long_scan = phase_mamba1_kernels(mamba_130m, gen)
    rows += m1_rows
    ring_rows = phase_ring(gen)
    rows += ring_rows
    for r in rows:
        print(f"phase 3 kernel at {r['at']}: " + json.dumps(r), flush=True)
    print("phase 3 long-context selective scan at mamba-130m's width: "
          + json.dumps(long_scan), flush=True)
    # the kernels line: zamba2-2.7b's shapes, the path that runs the five
    # Mamba-2 and attention kernels, mamba-130m's for the Mamba-1 two, and
    # gemma3-1b's serving chunk (bf16) for the ring mode
    rows = [r for r in rows if r["at"] == zamba2_2p7b.name
            or (r["at"] == mamba_130m.name and r["name"] != "causal_conv1d")]
    rows.append(dict(ring_rows[0], at=gemma3_1b.name))

    launches = {}
    for cfg in (mamba2_2p7b, zamba2_2p7b, mamba_130m, gemma3_1b,
                falcon_h1_05b):
        t0 = time.perf_counter()
        serving, launches[cfg.name] = phase_serving(cfg, gen)
        torch.cuda.empty_cache()
        print(f"phase 4 serving {cfg.name} ({cfg.n_layers} layers, slots 4, "
              f"prompts 300/700/1000/2048, 32 new; "
              f"{time.perf_counter() - t0:.1f} s): " + json.dumps(serving)
              + " launches " + json.dumps(launches[cfg.name]), flush=True)

    for cfg, n, cd, plen in ((mamba2_2p7b, 8, "bfloat16", 512),
                             (zamba2_2p7b, 12, "bfloat16", 512),
                             (llama3_8b, 4, "bfloat16", 512),
                             (mamba_130m, mamba_130m.n_layers, "bfloat16",
                              512),
                             (mamba_130m, mamba_130m.n_layers, "float32",
                              512),
                             (gemma3_1b, gemma3_1b.n_layers, "bfloat16",
                              1300),
                             (gemma3_1b, gemma3_1b.n_layers, "float32",
                              1300),
                             (QWEN25_05B, 4, "bfloat16", 512),
                             (QWEN25_05B, 4, "float32", 512),
                             (PHI3_MINI, 4, "bfloat16", 512),
                             (PHI3_MINI, 4, "float32", 512),
                             (falcon_h1_05b, falcon_h1_05b.n_layers,
                              "bfloat16", 512),
                             (falcon_h1_05b, falcon_h1_05b.n_layers,
                              "float32", 512),
                             (hymba_15b, hymba_15b.n_layers, "bfloat16",
                              512),
                             (hymba_15b, hymba_15b.n_layers, "float32", 512),
                             (smollm_135m, smollm_135m.n_layers, "bfloat16",
                              512),
                             (glm4_9b, 4, "bfloat16", 512),
                             (glm4_9b, 4, "float32", 512)):
        paths = phase_paths(cfg, gen, n, cd, plen)
        torch.cuda.empty_cache()
        print(f"phase 5 kernel path vs plain path, {cfg.name} at {n} "
              f"layers, {cd}, {plen}-token prompt: " + json.dumps(paths),
              flush=True)

    for cfg, names, decode in (
            (mamba_130m, ("scan1_kernel",), 0),
            # cuBLAS's Hopper products run as "nvjet" or "gemm" kernels
            (falcon_h1_05b, ("flash_wgmma_kernel", "ssd_tc_kernel",
                             "conv1d_kernel", "nvjet", "gemm"), 32)):
        t0 = time.perf_counter()
        long_prefill = phase_long_prefill(cfg, gen, names, decode=decode)
        torch.cuda.empty_cache()
        then = (f", then {decode} tokens through the graph burst"
                if decode else "")
        print(f"phase 6 long-context prefill, {cfg.name} "
              f"({cfg.n_layers} layers), one 16384-token prompt, B=1, "
              f"bf16, one-shot against 64 chunks of 256{then} "
              f"({time.perf_counter() - t0:.1f} s): "
              + json.dumps(long_prefill), flush=True)

    t0 = time.perf_counter()
    control = phase_control(gen)
    torch.cuda.empty_cache()
    print(f"phase 7 engine control on the card, strict tiers, slots 4, "
          f"max_seq 4096, chunks of 256, bursts of 8 "
          f"({time.perf_counter() - t0:.1f} s): " + json.dumps(control),
          flush=True)

    for r in rows:
        r["launches"] = launches[r["at"]][r["name"]]
        # the exponentials are operations on the special-function units
        if r["bound_by"] == "exponentials":
            r["bound_by"] = "operations"
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
