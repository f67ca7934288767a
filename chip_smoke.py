"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (each prints its lines and is fatal on failure):
  1. the card's name and power limit (``nvidia-smi``), and its draw while
     idle before any work (the median of five reads, ``H100_SXM.idle_w``);
     no CUDA -> exit 1;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. each kernel against its plain PyTorch version on the card, in bf16
     and fp32 with non-zero initial states, with its device time, the
     plain version's, a library call's where one exists, and its bound:
     conv1d at the channel counts of mamba2-2.7b, zamba2-2.7b and
     mamba-130m, also with valid lengths 0, 1, 2, K-1, 200 and S across
     rows (the new state held bit for bit) and timed once with L2
     flushed before each call;
     the Mamba-2 kernels at mamba2-2.7b's, zamba2-2.7b's,
     falcon-h1-0.5b's and the paper's zamba2-1.2b's (64 heads, d_state
     64), mamba2-780m's (48 heads) and mamba2-130m's (24) shapes, conv1d
     at theirs (C = 4224, 3328, 1792; SSD also on a 16-chunk sequence, and the
     decode step again, with dt, A and the states drawn at the model's
     scales; each (token, head) row of SSD's y held to a limit of its
     own), the attention kernels at zamba2-2.7b's (d=80), llama3-8b's
     (d=128, GQA 4:1), qwen2.5-0.5b's (d=64, GQA 7:1), phi-3-mini's
     (d=96), falcon-h1-0.5b's (d=128, GQA 2:1), glm4-9b's (d=128, 16
     query heads per KV head), zamba2-1.2b's (32 heads of 128, no GQA),
     qwen2.5-1.5b's (12 on 2 of 128) and llama3.2-1b's (32 on 8 of 64)
     shapes and a decode whose valid lengths fall
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
     (valid 301/512/512/512); the flash kernel non-causal at
     hubert-xlarge's encoder shape (B=4, 16 heads of 80, 1500 frames)
     beside SDPA's non-causal call, and both attention kernels at
     qwen3-moe-235b-a22b's (16 query heads a KV head) and
     llama4-maverick's (5) groups; each attention row gives its grid
     (``blocks``);
  4. full-width, full-depth serving through ``ServingEngine`` (4 ragged
     requests, 32 new tokens each), random weights from a seed:
     mamba2-2.7b (64 layers), zamba2-2.7b (54 layers), mamba-130m
     (24 Mamba-1 layers), gemma3-1b (26 layers: 22 ring layers, 4
     global), falcon-h1-0.5b (18 ``hybrid_par`` layers: attention
     and Mamba-2 side by side), then qwen3-moe-235b-a22b cut to 8 of its
     94 ``moe`` layers with bf16 params (42.3 GB; each layer is 2.49 B
     parameters), then the paper's fig1, fig7 and fig8 models:
     qwen2.5-0.5b (24 layers), mamba2-780m (48), mamba2-130m (24) and
     zamba2-1.2b (38: 19 shared-block positions), each row of phase 3 at
     them printed again with its launches; the launch counters are
     reset just before each run and
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
     writes its slot); for qwen3-moe also the decode step's weight-read
     bounds (every expert, as gshard reads them, and the routed ones
     only) beside the graph burst's ms a step, and eager 8-step bursts
     of the gshard and the ragged dispatch on the served cache, the
     ragged tokens equal to gshard's up to a near tie and their
     teacher-forced logits within phase 5's bf16 limit
     (``phase_moe_decode``); on zamba2-1.2b's served cache a 64-token
     burst sampled at temperature 0.8 (``phase_sampling``: one seed
     twice, bit for bit, tokens below the vocab, the sentinel clear,
     exact launches, no host sync) and its ms a step beside the greedy
     eager burst's; then ``launch.serve`` on reduced zamba2-1.2b at the
     default device (``phase_launcher``);
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
     KV head) at 4 layers in bf16 and fp32, qwen3-moe-235b-a22b at 4
     layers in bf16 and 2 in fp32 and llama4-maverick at one unit (2
     layers) in bf16 only (its fp32 copy does not fit), params in the
     compute dtype; the paper's mamba2-130m, mamba2-780m and zamba2-1.2b
     at full depth, qwen2.5-1.5b and llama3.2-1b at 4 layers, in bf16
     and fp32; the plain run must launch no kernel; for a MoE model
     every routed choice that differs between the paths must be a near
     tie of the router's logits (the share of such choices is printed),
     and in bf16 the limit holds on the logits rows whose own token kept
     every choice;
  6. mamba-130m, then falcon-h1-0.5b, at full width and depth prefill one
     16384-token prompt at B=1 in bf16 through ``lm_prefill``: wall time,
     kernel time and the shares of it of the scan (mamba-130m) or of
     flash, SSD and conv1d (falcon-h1-0.5b), exact launches, and its last
     logits against the same prompt in 64 chunks of 256 through
     ``lm_prefill_chunk`` within phase 5's bf16 limit, and the same call
     in a phase-8 trace window (the paper's long-context breakdown by
     operator class); falcon-h1-0.5b then decodes 32 tokens at that
     context through the graph burst (ms per token step);
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
  8. operator classes (``serving/profiler.py``), run right after each
     model's phase 4 on its engine and params (``phase_profile``): trace
     windows over one eager 4 x 256 prefill chunk, one eager 8-step burst
     and one replay of that burst's CUDA graph, each printing its device
     ms and share by class (gemm, ssm, norm, arith, memory, other), its
     unattributed ms, ``degraded``, its kernel count, and the same
     program's modeled ms by class on ``H100_SXM`` (the static walk on
     ``meta``, ``core/roofline.op_class_times``); each window is held to
     (a) attributed plus unattributed ms equal to the window's kernel,
     memcpy and memset time read from its own trace as ``device_busy``
     reads one, within 1%, (b) unattributed under 2% and not degraded,
     (c) ``ssm`` at least the hand-written SSM kernels' time by name and
     ``other`` at least the attention kernels'; then phase 4's requests
     again with a coarse profiler: (d) ``profile_snapshot()``'s
     dispatches equal the engine's and each key's shares sum to 1, (e)
     the profiler's overhead under 3% of the decode wall, (f) streams and
     launches equal phase 4's (profiler off);
  9. the encoder and the frontends at full width and depth: hubert-xlarge
     (48 ``encoder`` layers) through ``make_encode_step`` on 4 x 1500
     frames of 512-d features in bf16 and fp32, exactly 48 flash
     launches a forward, all non-causal, logits held to the plain path's,
     wall and kernel ms (``phase_encoder``); llava-next-mistral-7b (32
     layers, bf16 params) with 576 patch features before a 512-token
     prompt: first logits kernel path against plain path, decoding from
     position 1088, then 32 tokens through ``greedy_generate`` with exact
     launches (``phase_vision``); each phase prints its seconds;
 10. training (``phase_backward_kernels``, ``phase_train_paths``,
     ``phase_train_full``): (a) the backward kernels against their plain
     backwards at ``BWD_CHECKS`` (zamba2-2.7b's SSD, conv1d at C=5248 and
     the shared block's flash, 32 heads of 80; smollm-135m's flash, 9
     query heads on 3, d=64; mamba-130m's selective scan, C=1536, N=16,
     and conv1d, C=1536; gemma3-1b's flash, 4 query heads on 1, d=256,
     in its 512-key window over S=1300 and causal; hubert-xlarge's
     non-causal flash, 16 heads of 80, over S=500), bf16 and fp32, within
     1e-4 (fp32) or 3% (bf16) of each gradient's max |g|, two calls bit
     for bit, then at the training shapes (``BWD_ROWS``: B=4 x S=2048;
     B=8 for smollm's flash and mamba-130m's; hubert's B=4 x S=1500) in
     bf16 held the same way and timed beside the plain versions, autograd
     of the library calls (SDPA causal, with the window as a boolean
     mask, non-causal; F.conv1d; none for SSD and the scan) and the
     bounds, each with its plan's route, share of the bound and ratio to
     the library call; (b) a training loss and gradient through the
     kernels against autograd through the plain versions, on the
     synthetic stream's first batch: zamba2-2.7b at
     one unit (6 layers) and smollm-135m at 4 layers in fp32 and bf16,
     zamba2-2.7b at its 54 layers in bf16 (the shared block's 9
     positions), gemma3-1b at one unit (S=1024, past its window),
     hubert-xlarge at 2 layers (S=500),
     mamba-130m at 4 and llava-next-mistral-7b at 2 (576 patch features
     before 576 tokens) in bf16, and qwen3-moe-235b-a22b at 1 layer in
     fp32 (its routers' choices of both paths compared), with exact
     launches (each unit's forward kernels twice under remat, each
     backward kernel once, the flash backward's by mode); (c)
     zamba2-2.7b at full width and depth through ``Trainer`` (fp32
     masters, bf16 compute, ``OptConfig()``, B=4 x S=2048), 8 steps with
     a checkpoint at step 4, and a fresh ``Trainer`` restored there
     replaying steps 5-8 within rtol 1e-5; (d) smollm-135m (B=8),
     gemma3-1b (26 layers, B=4), hubert-xlarge (48 layers, B=4 x S=1500
     frames), mamba-130m (24 layers, B=8) and qwen3-moe-235b-a22b (1 of
     94 layers at full width, B=2 x S=1024) for 8 steps; each prints the
     losses, the median step ms, tokens/s, the model-FLOPs share of 989
     TFLOP/s, peak memory and a traced step's backward-kernel time
     against its forward kernels', every kernel of each backward route
     found in the trace by a name that sums into its own row;
then a ``kernels`` JSON line (the five Mamba-2 and attention kernels at
zamba2-2.7b's shapes, the two Mamba-1 kernels at mamba-130m's and the
flash kernel's ring mode at gemma3-1b's, each with the launches of its
own config's serving run; the three backward kernels at zamba2-2.7b's
training shape with the launches of its 8 training steps; the selective
scan's backward at mamba-130m's, the flash backward in its window and
causal at d=256 at gemma3-1b's and non-causal at hubert-xlarge's, each
with the launches of its model's 8 training steps), the card line, and
the result line last.
Imports nothing of JAX nor of the reference package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
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
# the paper's models whose kernel instances phase 3 runs beside the
# earlier configs' (rows labelled by model)
PAPER_MODELS = ("zamba2-1.2b", "mamba2-780m", "mamba2-130m", "qwen2.5-0.5b",
                "qwen2.5-1.5b", "llama3.2-1b")
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


def idle_power_w(reads: int = 5) -> float:
    """The card's power draw (W) while idle: the median of ``reads``
    ``nvidia-smi`` reads 0.2 s apart."""
    draws = []
    for _ in range(reads):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.draw",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60).stdout
        draws.append(float(out.split()[0]))
        time.sleep(0.2)
    return statistics.median(draws)


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


# launches that open every trace of ``device_busy``: unprimed, the tracer
# lost the kernel records of up to 29 of a trace's first launches in one
# run of this script (more the longer the process had run), eager and
# graph alike (``scripts/tracer_start_drops.py``)
TRACER_PRIMER = 256


def device_busy(fn, names=()) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and read the trace: wall
    time, the union of kernel intervals on the card, kernel launches, and
    the device-side memory copies (``copy_`` of one tensor into another
    of its type, as a cache leaf is stored, runs as a memcpy, not a
    kernel) with their summed time and their count by direction; for each
    of ``names``, the summed time of the kernels whose name holds it and
    its share of all kernel time, and then the names of every kernel
    traced.  Where the idle time lies: the device
    span (first device operation's start to the last one's end) and the
    idle share inside it (the gaps between operations), the first device
    operation's and the first kernel's offsets, both on the card's clock,
    from the end of a one-element fill launched right before ``fn`` (the
    card's and the host's clocks are not one clock), and the host time in
    ``cudaGraphLaunch``.  The tracer loses the device records of the
    first launches of a trace (none early in the process, dozens late
    in it; the launches' own host records stay), so
    ``TRACER_PRIMER`` small launches, each waited for, come first, and a
    trace that lost the marker's record is refused: the count of kernels
    is then exact, not a lower bound.  Only the device operations of the
    calls ``fn`` made are read.  The trace is
    kept in ``build/repro_torch/`` (listed in .gitignore)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    marker = torch.zeros(1, device="cuda")
    primer = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACER_PRIMER):
            primer.add_(1.0)
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
    if not marks:
        raise AssertionError("device_busy: the tracer lost the marker's "
                             "record, so the trace's first launches are "
                             "missing; raise TRACER_PRIMER")
    dev0 = max(e["ts"] + e["dur"] for e in marks)
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
    kernel_names = sorted({e.get("name", "") for e in kernels})
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
                    (device_ops[0][0] - dev0) / 1e3 if device_ops else None),
                first_kernel_ms=(spans[0][0] - dev0) / 1e3
                if spans else None,
                graph_launch_ms=graph_launch_us / 1e3,
                **({"by_name": by_name, "kernel_names": kernel_names}
                   if names else {}))


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
    attention half (GQA 2:1), glm4-9b's and qwen3-moe-235b-a22b's 16
    query heads per KV head and llama4-maverick's 5, zamba2-1.2b's shared
    attention (32 heads of 128, no GQA), qwen2.5-1.5b's (12 on 2 of 128)
    and llama3.2-1b's (32 on 8 of 64); a flash chunk of 256 queries, and
    decode rows of the serving run's lengths."""
    offs = [0, 512, 1024, 1792]
    lens = [301, 701, 1001, 2048]
    return [("zamba2-2.7b", 32, 32, 80, 2048, offs, lens),
            ("llama3-8b", 32, 8, 128, 2048, offs, lens),
            ("gemma3-1b", 4, 1, 256, 2048, offs, lens),
            ("qwen2.5-0.5b", 14, 2, 64, 2048, offs, lens),
            ("phi-3-mini", 32, 32, 96, 2048, offs, lens),
            ("falcon-h1-0.5b", 8, 4, 128, 2048, offs, lens),
            ("glm4-9b", 32, 2, 128, 2048, offs, lens),
            ("qwen3-moe-235b-a22b", 64, 4, 128, 2048, offs, lens),
            ("llama4-maverick-400b-a17b", 40, 8, 128, 2048, offs, lens),
            ("zamba2-1.2b", 32, 32, 128, 2048, offs, lens),
            ("qwen2.5-1.5b", 12, 2, 128, 2048, offs, lens),
            ("llama3.2-1b", 32, 8, 64, 2048, offs, lens)]


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
    if kinds & {"dense", "moe", "dense_moe", "mamba2+shared",
                 "hybrid_par"}:
        names |= {"flash_attention", "decode_attention"}
    if "encoder" in kinds:
        names |= {"flash_attention"}
    if "local" in kinds:
        names |= {"flash_attention_ring", "decode_attention"}
    return names


def exact_launches(cfg, chunks: int, steps: int) -> dict:
    """Every kernel's exact launches in a serving run of ``chunks`` prefill
    chunks and ``steps`` decode token steps: per layer and chunk one flash
    launch (ring layers in ring mode), one conv1d and one SSD or scan
    launch; per layer and token step one decode attention or decode step
    launch.  ``moe`` and ``dense_moe`` layers count as ``dense`` ones (the
    experts run outside the kernels).  A ``hybrid_par`` layer counts both
    halves: one flash, one conv1d and one SSD launch a chunk, one decode
    attention and one Mamba-2 decode step launch a token step.  An
    ``encoder`` layer counts one (non-causal) flash launch per forward,
    counted here as a chunk."""
    kinds = cfg.layer_kinds
    n_par = kinds.count("hybrid_par")
    n_ring = kinds.count("local")
    n_enc = kinds.count("encoder")
    n_plain = (kinds.count("dense") + kinds.count("moe")
               + kinds.count("dense_moe") + kinds.count("mamba2+shared")
               + n_par)
    n_m2 = kinds.count("mamba2") + kinds.count("mamba2+shared") + n_par
    n_m1 = kinds.count("mamba1")
    return {"flash_attention": (n_plain + n_enc) * chunks,
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


def phase_serving(cfg, gen, param_dtype=None):
    """Serve 4 ragged requests at ``cfg``'s width and depth, params in
    ``param_dtype`` (None: the config's).  Returns (the results, the
    launches, what phase 8 reuses: the engine, its params, the requests
    and the steady bursts' positions)."""
    import numpy as np
    from repro_torch.models.lm import init_lm_params, lm_prefill_chunk
    from repro_torch.serving.bucketing import clamped_bucket
    from repro_torch.serving.engine import Request, ServingEngine

    params = init_lm_params(cfg, gen, dtype=param_dtype, device="cuda")
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
    reuse = dict(eng=eng, params=params, reqs=reqs, pos=pos)
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
                max_memory_allocated=served_peak), launches, reuse


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
    (idle share, kernels, memcpys; the graph's no more than eager's), the
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
        busy = out[f"profiled_decode_burst8_b4_{name}"] = device_busy(burst)
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


def phase_sampling(cfg, eng, n: int = 64, temperature: float = 0.8,
                   seed: int = 0):
    """A sampled ``n``-token burst (``decode_tokens`` at ``temperature``,
    a generator on the card seeded with ``seed``) on clones of the served
    cache, all 4 slots live where phase 4 left them: twice from one seed,
    tokens bit for bit, every token below the vocab, the sentinel clear,
    exactly one decode-step or decode-attention launch a layer and step,
    and no host sync inside the burst (``torch.cuda.set_sync_debug_mode``
    raises on one); its ms a token step (median of 3 after one more)
    beside the greedy eager burst's from the same cache."""
    from repro_torch.models.lm import decode_tokens
    from repro_torch.serving.bucketing import clamped_bucket
    pos = [int(p) for p in eng.cache["pos"].tolist()]
    bucket = clamped_bucket(max(pos) + n, eng.kv_extent)
    first = torch.zeros((4, 1), dtype=torch.int32, device="cuda")

    def burst(temperature_, gen=None, checked=False):
        cache = clone_cache(eng.cache)
        torch.cuda.synchronize()
        if checked:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = decode_tokens(cfg, eng.params, cache, first, n,
                                kv_bucket=bucket, rope_len=eng.rope_len,
                                with_sentinel=True,
                                temperature=temperature_, generator=gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return out

    def seeded():
        return torch.Generator(device="cuda").manual_seed(seed)

    reset_counters()
    toks, _, ok = burst(temperature, seeded(), checked=True)
    launches = {k: v for k, v in read_counters().items() if v}
    want = {k: v for k, v in exact_launches(cfg, 0, n).items() if v}
    if launches != want:
        raise AssertionError(f"{cfg.name}: a sampled burst launched "
                             f"{launches}, expected {want}")
    again, _, ok2 = burst(temperature, seeded())
    if not torch.equal(toks, again):
        raise AssertionError(f"{cfg.name}: one seed gave two bursts")
    if not (bool(ok.all()) and bool(ok2.all())):
        raise AssertionError(f"{cfg.name}: the sentinel flags a sampled row")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: a sampled token outside the "
                             "vocab")
    greedy = burst(0.0)[0]
    out = dict(batch=4, tokens=n, temperature=temperature, kv_bucket=bucket,
               same_seed_identical=True, sentinel_ok=True,
               distinct_tokens=int(toks.unique().numel()),
               tokens_equal_to_greedy=float((toks == greedy).float().mean()),
               launches=launches)
    for name, run in (("sampled", lambda: burst(temperature, seeded())),
                      ("greedy_eager", lambda: burst(0.0))):
        times = []
        for _ in range(4):
            ts = time.monotonic()
            run()
            times.append(time.monotonic() - ts)
        out[f"{name}_ms_per_token_step"] = (
            statistics.median(times[1:]) * 1e3 / n)
    return out


def phase_launcher(arch: str):
    """``repro_torch.launch.serve.main`` at the default device (the card)
    on ``arch`` reduced: every request ``ok`` with ``--max-new`` tokens,
    and the launches of the kernels of its layer kinds, none else."""
    from repro_torch.configs import reduced
    from repro_torch.core.registry import get
    from repro_torch.launch import serve
    reset_counters()
    t0 = time.monotonic()
    done = serve.main(["--arch", arch, "--requests", "8", "--slots", "4",
                       "--max-new", "16"])
    wall = time.monotonic() - t0
    launches = {k: v for k, v in read_counters().items() if v}
    if len(done) != 8 or any(r.status != "ok" or len(r.out) != 16
                             for r in done):
        raise AssertionError(f"launch.serve {arch}: "
                             f"{[(r.rid, r.status, len(r.out)) for r in done]}")
    on_path = path_kernels(reduced(get(arch)))
    if set(launches) != on_path:
        raise AssertionError(f"launch.serve {arch}: launched {launches}, "
                             f"its kernels are {sorted(on_path)}")
    return dict(requests=len(done), tokens=sum(len(r.out) for r in done),
                wall_s=wall, launches=launches)


def plain_attention():
    """The attention module's kernels swapped for their plain versions."""
    from repro_torch.kernels.attn_decode import ref as attn_dec_ref
    from repro_torch.kernels.flash import ref as flash_ref
    from repro_torch.models import attention as attn

    def plain_flash(q, k, v, *, causal=True, window=None, q_offset=None,
                    kv_wrap=None, ring_len=None):
        return flash_ref.attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=0 if q_offset is None
                                       else q_offset, kv_wrap=kv_wrap,
                                       ring_len=ring_len)
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(attn, "flash_attention",
                                          plain_flash))
    stack.enter_context(mock.patch.object(attn, "decode_attention",
                                          attn_dec_ref.decode_attention_ref))
    return stack


def hold_paths(name, kern, plain, compute_dtype):
    """Phase 5's rule on two logits tensors [..., V] (rows of the kernel
    and the plain path): within 5% of max |logit| in bf16 (each bf16
    rounding is worth 2^-8 of its value, and the two paths round at
    different points) and 1e-4 in fp32 (sums in another order), and the
    greedy tokens (argmax) equal wherever the plain top-2 margin exceeds
    twice the difference."""
    if not (torch.isfinite(kern).all() and torch.isfinite(plain).all()):
        raise AssertionError(f"{name}: non-finite logits")
    err = float((kern - plain).abs().max())
    tol = (0.05 if compute_dtype == "bfloat16" else 1e-4) * float(
        plain.abs().max())
    if err > tol:
        raise AssertionError(f"{name}: logits differ by {err} > {tol}")
    top2 = plain.topk(2, dim=-1).values
    checked = (top2[..., 0] - top2[..., 1]) > 2 * err
    agree = kern.argmax(-1) == plain.argmax(-1)
    if not bool(agree[checked].all()):
        raise AssertionError(f"{name}: argmax disagrees above the margin")
    return dict(max_abs_logit_err=err, tol=tol,
                max_abs_logit=float(plain.abs().max()),
                rows_checked=int(checked.sum()), rows=int(agree.numel()),
                rows_agree=int(agree.sum()))


# the share of routed choices that may differ between phase 5's kernel
# and plain paths: in fp32 the paths differ only by the order of their
# sums (0 read at qwen3-moe); in bf16 by where they round, which flips
# near ties of random routers (0.0220 read at qwen3-moe, 4 layers, and
# 0.0154 at llama4, one unit, on an H100 80GB HBM3 at 700 W)
ROUTE_DIFF_LIMIT = {"bfloat16": 0.05, "float32": 0.01}


def route_diff(kern_routes, plain_routes, n_moe: int, last_row: int):
    """The routers' choices of the two runs of ``phase_paths``, call by
    call (each (indices [tokens, k], logits [tokens, E])): the share of
    choices that differ (a choice of one run missing from the same
    token's choices in the other), how many of those are not near ties
    (the plain run's gap between its k-th and (k+1)-th logit more than
    twice the largest difference between the two runs' logits of that
    token), and for each logits row (the last prompt token's, then each
    decode step's) whether its own token kept every choice at every MoE
    layer.  ``last_row`` is the last prompt token's row in the last
    chunk."""
    if len(kern_routes) != len(plain_routes):
        raise AssertionError("the runs made different router calls")
    differ = total = not_tie = 0
    bad = []
    for (a, la), (b, lb) in zip(kern_routes, plain_routes):
        k = a.shape[-1]
        miss = ~(a[:, :, None] == b[:, None, :]).any(-1)
        top = lb.topk(k + 1, dim=-1).values
        gap = top[:, k - 1] - top[:, k]
        noise = (la - lb).abs().amax(-1)
        differ += int(miss.sum())
        total += miss.numel()
        not_tie += int((miss.any(-1) & (gap > 2 * noise)).sum())
        bad.append(miss.any(-1))
    steps = 8
    prefill = len(bad) - steps * n_moe
    rows = [bad[prefill - n_moe:prefill]]
    rows += [bad[prefill + i * n_moe:prefill + (i + 1) * n_moe]
             for i in range(steps)]
    clean = [not any(bool(c[last_row if i == 0 else 0]) for c in calls)
             for i, calls in enumerate(rows)]
    return differ / total, total, not_tie, clean


@contextlib.contextmanager
def recording_routes(routes: list):
    """Each MoE router call's choices ([tokens, k]) and logits ([tokens,
    E]) appended to ``routes``."""
    from repro_torch.models import moe as moe_mod
    real = moe_mod._router

    def router(p, x, m):
        gates, idx = real(p, x, m)
        logits = torch.matmul(x.float(), p["router"].float())
        routes.append((idx.reshape(-1, idx.shape[-1]).detach(),
                       logits.reshape(-1, logits.shape[-1]).detach()))
        return gates, idx
    with mock.patch.object(moe_mod, "_router", router):
        yield



def phase_paths(cfg, gen, n_layers: int, compute_dtype: str = "bfloat16",
                prompt_len: int = 512, param_dtype=None):
    """Kernel path against plain path on the card: ``n_layers`` layers, one
    ``prompt_len``-token prompt in 256-token chunks (a ragged last chunk
    where it does not divide), on a cache of ``2 * prompt_len`` rows, then
    8 teacher-forced decode steps, in ``compute_dtype`` (the caches too),
    params in ``param_dtype`` (None: the config's).
    Logits agree within 5% of max
    |logit| in bf16 (each bf16 rounding is worth 2^-8 of its value, and
    the two paths round at different points) and 1e-4 in fp32 (sums in
    another order).  A MoE model's router may flip a near-tie choice
    between the paths in bf16 (top 1 replaces a token's whole
    feed-forward): every routed choice that differs must be a near tie
    (the plain run's gap between its k-th and (k+1)-th router logit
    within twice the two runs' largest router-logit difference for that
    token, as the greedy tokens are held above twice the logits'
    difference), and the share of differing choices stays within
    ``ROUTE_DIFF_LIMIT`` (``route_diff``).  In bf16 the logits limit
    holds on the rows whose own token kept every choice, at least half
    of the rows; in fp32 on every row."""
    from repro_torch.kernels.conv1d import ref as conv_ref
    from repro_torch.kernels.decode_fused import ref as dec_ref
    from repro_torch.kernels.scan1 import ref as scan_ref
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.models import mamba1 as m1
    from repro_torch.models import mamba2 as m2
    from repro_torch.models.lm import (init_lm_cache, init_lm_params,
                                       lm_decode_step, prepare_params)
    from repro_torch.serving.prefill import chunked_prefill

    cfg8 = dataclasses.replace(cfg, n_layers=n_layers,
                               compute_dtype=compute_dtype)
    cache_dtype = getattr(torch, compute_dtype)
    params = prepare_params(cfg8, init_lm_params(
        cfg8, gen, dtype=param_dtype and getattr(torch, param_dtype),
        device="cuda"))
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=gen,
                           device="cuda")
    routes = {"kern": [], "plain": []}

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

    with recording_routes(routes["kern"]):
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
            plain_attention(), recording_routes(routes["plain"]):
        plain, _ = run(toks)
    launched = {k: n for k, n in read_counters().items() if n}
    if launched:
        raise AssertionError(f"the plain path launched kernels: {launched}")
    out = {}
    rows = torch.ones(kern.shape[0], dtype=torch.bool, device=kern.device)
    if cfg.moe is not None:
        n_moe = cfg8.layer_kinds.count("moe")
        share, choices, not_tie, clean = route_diff(
            routes["kern"], routes["plain"], n_moe,
            (prompt_len - 1) % 256)
        out.update(routed_choices=choices, route_diff_share=share,
                   route_diff_tokens_not_near_tie=not_tie,
                   rows_with_a_route_diff=clean.count(False))
        if not_tie:
            raise AssertionError(f"{not_tie} tokens' routed choices differ "
                                 "between the paths at more than a near "
                                 f"tie ({share:.4f} of the choices "
                                 "differ)")
        limit = ROUTE_DIFF_LIMIT[compute_dtype]
        out.update(route_diff_limit=limit)
        if share > limit:
            raise AssertionError(f"{share:.4f} of the routed choices differ "
                                 f"between the paths, over {limit}")
        if compute_dtype == "bfloat16":
            rows = torch.tensor(clean, device=kern.device)
        if 2 * int(rows.sum()) < rows.numel():
            raise AssertionError(f"{rows.numel() - int(rows.sum())} of "
                                 f"{rows.numel()} logits rows' tokens have "
                                 "a route diff, over half")
    return dict(hold_paths(cfg.name, kern[rows], plain[rows], compute_dtype),
                **out)


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
    from repro_torch.core.op_analysis import analyze, meta_like
    from repro_torch.models.lm import (cache_kv_extent, init_lm_cache,
                                       init_lm_params, init_spare_states,
                                       lm_prefill, lm_prefill_chunk,
                                       prepare_params)
    from repro_torch.serving.bucketing import clamped_bucket
    from repro_torch.serving.graphs import make_decode_tokens
    from repro_torch.serving.profiler import Profiler

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
    # phase 8's window over the same call: the long-context breakdown
    profile = profiled_window(
        "prefill_16k", Profiler(mode="trace", trace_dir=PROFILE_DIR),
        one_shot, analyze(lm_prefill, cfg, meta_like(params),
                          prompt.to("meta"),
                          init_lm_cache(cfg, 1, rows, dtype=torch.bfloat16,
                                        device="meta")))
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
               argmax_agree=bool((whole.argmax(-1) == lg.argmax(-1)).all()),
               phase8_profile=profile)
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


# ------------------------------------ MoE decode: bounds and both dispatches

def moe_step_bounds(cfg, b: int = 4) -> dict:
    """The bytes one decode step of ``cfg`` must read at batch ``b`` in
    bf16 and their time at 3.35 TB/s: every weight but the embedding
    table (``b`` rows of it), with every expert of every ``moe`` layer
    (the gshard path's products read them all) or only the routed ones,
    at most ``min(E, b * k)`` a layer."""
    from repro_torch.core.memmodel import param_count
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    n_moe = cfg.layer_kinds.count("moe")
    weights = param_count(cfg) - cfg.vocab_size * d + b * d
    if cfg.tie_embeddings:
        weights += cfg.vocab_size * d        # the tied head reads it all
    unrouted = n_moe * (m.n_experts - min(m.n_experts,
                                          b * m.experts_per_token))
    routed = weights - unrouted * 3 * d * f
    return dict(all_experts_gb=2 * weights / 1e9,
                all_experts_bound_ms=2 * weights / HBM_BYTES_PER_S * 1e3,
                routed_gb=2 * routed / 1e9,
                routed_bound_ms=2 * routed / HBM_BYTES_PER_S * 1e3)


def phase_moe_decode(cfg, gen, eng, pos):
    """A MoE model's steady decode against its weight-read bounds, and the
    ragged dispatch beside gshard on phase 4's served cache: eager 8-step
    bursts at B=4 under the engine's KV bucket from one cache state (ms,
    median of 3 after one more, and the kernel time of a profiled one).
    Decode drops no choice here (4 tokens a
    step, a capacity of at least 8), so both paths compute one function:
    in an 8-step gshard burst every MoE layer's input is also fed to the
    ragged path, and each output is held within 2e-2 of that call's max
    |y| (one bf16 rounding of each product; the same router on the same
    input, so the same routes).  Free-running bursts of both from clones
    of the cache: whether their tokens are equal, and the first step
    where they part (a bf16 rounding apart, the hidden states drift and
    a router can flip a near tie, which changes a token's experts)."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.lm import decode_tokens
    from repro_torch.serving.bucketing import clamped_bucket
    m = cfg.moe
    if moe_mod._capacity(4, m) < 4:
        raise AssertionError("decode at B=4 could drop a choice")
    ragged = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, impl="ragged"))
    pos_d = torch.tensor(pos, dtype=torch.int32, device="cuda")
    first = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen,
                          device="cuda", dtype=torch.int32)
    kw = dict(kv_bucket=clamped_bucket(max(pos) + 8, eng.kv_extent),
              rope_len=eng.rope_len)
    out = dict(moe_step_bounds(cfg))
    toks = {}
    for name, c in (("gshard", cfg), ("ragged", ragged)):
        def burst(cache=None):
            return decode_tokens(c, eng.params,
                                 cache or dict(eng.cache, pos=pos_d),
                                 first, 8, **kw)[0].cpu()
        times = []
        for _ in range(4):
            ts = time.monotonic()
            burst()
            times.append(time.monotonic() - ts)
        ms = statistics.median(times[1:]) * 1e3
        out[f"{name}_eager_burst8_ms"] = ms
        out[f"{name}_eager_ms_per_token_step"] = ms / 8
        busy = device_busy(burst)
        out[f"{name}_eager_burst8_kernel_ms"] = busy["kernel_busy_ms"]
        out[f"{name}_eager_burst8_kernels"] = busy["kernels"]
        toks[name] = burst(clone_cache(dict(eng.cache, pos=pos_d)))
    # layer by layer: each gshard call's input through the ragged path too
    real, ratios = moe_mod.moe_gshard, []

    def both(p, x, m_, n_groups, act="silu"):
        y = real(p, x, m_, n_groups, act)
        r = moe_mod.moe_ragged(p, x, m_, act)
        ratios.append(float((r.float() - y.float()).abs().max())
                      / float(y.float().abs().max()))
        return y
    with mock.patch.object(moe_mod, "moe_gshard", both):
        decode_tokens(cfg, eng.params, clone_cache(dict(eng.cache,
                                                        pos=pos_d)),
                      first, 8, **kw)[0].cpu()
    if len(ratios) != 8 * cfg.layer_kinds.count("moe") or \
            max(ratios) > 2e-2:
        raise AssertionError(f"ragged against gshard per layer: "
                             f"{len(ratios)} calls, worst {max(ratios)}")
    same = toks["gshard"] == toks["ragged"]
    parted = [int(row.tolist().index(False)) if not bool(row.all()) else None
              for row in same]
    out.update(layer_calls_compared=len(ratios),
               worst_layer_err_of_max_y=max(ratios),
               ragged_tokens_equal_gshard=bool(same.all()),
               first_differing_step_per_row=parted)
    return out


# ------------------------------------------- phase 9: encoder and frontends

def encoder_flash(gen):
    """Phase 3's row of the flash kernel at hubert-xlarge's non-causal
    encoder shape (B=4, 16 heads of 80 on 16 KV heads, 1500 frames):
    each query row against the plain version in bf16 and fp32, then
    bf16 times beside the bound (q, k, v read and o written once; every
    query meets every key, 4d operations each) and SDPA, non-causal; the
    row's share of its bound (``of_bound``) and its ratio to SDPA
    (``over_library``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref
    b, h, s, d = 4, 16, 1500, 80
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((b, s, h, d), generator=gen,
                               device="cuda").to(dt).transpose(1, 2)
                   for _ in range(3))
        got = flash_ops.flash_attention(q, k, v, causal=False)
        want = flash_ref.attention_ref(q, k, v, causal=False)
        tol = TOL["attention"][dt]
        check_close(f"flash hubert-xlarge non-causal {dt}", [got], [want],
                    tol, ratio=row_ratio)
    bms, by = bound(4 * nbytes(q), 4.0 * d * h * s * s * b, dt)
    row = dict(
        name="flash_attention", route="cuda", at="hubert-xlarge",
        source="src/repro_torch/kernels/csrc/flash.cu",
        replaces="src/repro/kernels/flash/kernel.py:124", causal=False,
        blocks=flash_ops.flash_plan(b, h, h, s, s, d, dt).blocks,
        max_abs_err=max_err([got], [want]),
        worst_row_of_limit=row_ratio(got, want, tol),
        ms=device_ms(lambda: flash_ops.flash_attention(q, k, v,
                                                       causal=False)),
        # the offsets on the card: a host tensor cannot be captured
        plain_ms=device_ms(lambda: flash_ref.attention_ref(
            q, k, v, causal=False, q_offset=torch.zeros(
                (b,), dtype=torch.int32, device="cuda"))),
        bound_ms=bms, bound_by=by,
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v)))
    row["of_bound"] = bms / row["ms"]
    row["over_library"] = row["ms"] / row["library_ms"]
    return row


def phase_encoder(cfg, gen, b: int = 4, frames: int = 1500):
    """hubert-xlarge at full width and depth through ``make_encode_step``:
    ``b`` x ``frames`` frames of features (30 s of audio at 50 frames/s),
    fp32 params cast once, in bf16 and in fp32.  Each forward launches the
    flash kernel exactly once a layer, every launch non-causal, and no
    other kernel; its logits are held to the plain path's (phase 5's
    rule); wall ms (median of 3 after one more) and, in bf16, the
    profiled kernel time and the flash kernel's share."""
    from repro_torch.models import attention as attn
    from repro_torch.models.lm import init_lm_params, prepare_params
    from repro_torch.serving.engine import make_encode_step
    raw = init_lm_params(cfg, gen, device="cuda")
    feats = torch.randn((b, frames, cfg.frontend_feature_dim), generator=gen,
                        device="cuda")
    out = {}
    for cd in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, compute_dtype=cd)
        params = prepare_params(c, raw)
        step = make_encode_step(c, device="cuda")

        def forward():
            return step(params, {"features": feats})
        causal, real = [], attn.flash_attention

        def spy(q, k, v, **kw):
            causal.append(kw.get("causal", True))
            return real(q, k, v, **kw)
        times = []
        for _ in range(4):
            ts = time.monotonic()
            forward()
            torch.cuda.synchronize()
            times.append(time.monotonic() - ts)
        reset_counters()
        with mock.patch.object(attn, "flash_attention", spy):
            kern = forward()[..., :cfg.vocab_size].float()
        torch.cuda.synchronize()
        launches = {k: n for k, n in read_counters().items() if n}
        if launches != {"flash_attention": cfg.n_layers} or \
                causal != [False] * cfg.n_layers:
            raise AssertionError(f"{cfg.name}: launches {launches}, causal "
                                 f"flags {sorted(set(causal))}")
        reset_counters()
        with plain_attention():
            plain = forward()[..., :cfg.vocab_size].float()
        if any(read_counters().values()):
            raise AssertionError("the plain path launched a kernel")
        res = dict(wall_ms=statistics.median(times[1:]) * 1e3,
                   flash_launches=launches["flash_attention"],
                   all_non_causal=True,
                   **hold_paths(f"{cfg.name} {cd}", kern, plain, cd))
        if cd == "bfloat16":
            res["profiled_forward"] = device_busy(
                lambda: forward().cpu(), names=("flash_wgmma_kernel",))
        out[cd] = res
        del params, kern, plain
        torch.cuda.empty_cache()
    return out


def phase_vision(cfg, gen, patches: int = 576, prompt: int = 512,
                 new: int = 32):
    """llava-next-mistral-7b at full width and depth, bf16 params: one
    request of ``patches`` projected patch features before a
    ``prompt``-token prompt.  The first logits (``lm_prefill`` with
    ``features=``) kernel path against plain path (phase 5's bf16 rule),
    then ``greedy_generate`` of ``new`` tokens: decoding starts at
    position ``patches + prompt``, and the run launches exactly one flash
    a layer and one decode attention a layer and token step."""
    from repro_torch.models.lm import (init_lm_cache, init_lm_params,
                                       lm_prefill, prepare_params)
    from repro_torch.serving.engine import greedy_generate
    raw = init_lm_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    params = prepare_params(cfg, raw)
    feats = torch.randn((1, patches, cfg.frontend_feature_dim),
                        generator=gen, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, prompt), generator=gen,
                         device="cuda")
    max_seq = patches + prompt + new

    def first():
        cache = init_lm_cache(cfg, 1, max_seq, device="cuda")
        lg, cache = lm_prefill(cfg, params, toks, cache, features=feats)
        return lg[:, 0, :cfg.vocab_size].float(), cache
    kern, cache = first()
    if cache["pos"].tolist() != [patches + prompt]:
        raise AssertionError(f"decode would start at {cache['pos']}")
    with plain_attention():
        plain, _ = first()
    out = dict(first_logits=hold_paths(cfg.name, kern, plain, "bfloat16"),
               decode_starts_at=patches + prompt)
    del cache
    greedy_generate(cfg, raw, {"tokens": toks}, max_seq, 2, features=feats,
                    device="cuda")
    torch.cuda.synchronize()
    reset_counters()
    ts = time.monotonic()
    gen_toks, cache = greedy_generate(cfg, raw, {"tokens": toks}, max_seq,
                                      new, features=feats, device="cuda")
    torch.cuda.synchronize()
    wall = time.monotonic() - ts
    launches = {k: n for k, n in read_counters().items() if n}
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * (new - 1)}
    if launches != want:
        raise AssertionError(f"{cfg.name}: launches {launches}, expected "
                             f"{want}")
    if cache["pos"].tolist() != [patches + prompt + new - 1]:
        raise AssertionError(f"{cfg.name}: pos {cache['pos'].tolist()}")
    out.update(greedy_generate_wall_ms=wall * 1e3, tokens=gen_toks.shape[1],
               launches=launches)
    return out


# --------------------------------------------- phase 8: operator classes

PROFILE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "repro_torch", "profile")
# the hand-written kernels by their function names in a trace
SSM_KERNELS = ("conv1d_kernel", "m1_decode_kernel", "m2_decode_kernel",
               "scan1_kernel", "ssd_kernel", "ssd_tc_kernel")
ATTN_KERNELS = ("flash_wgmma_kernel", "flash_f32_kernel",
                "decode_bf16_kernel", "decode_f32_kernel")


def kernel_short_name(name: str):
    """A hand-written kernel's function name in a trace's kernel name
    (``void (anonymous namespace)::ssd_tc_kernel<...>(...)``), else
    None."""
    import re
    m = re.search(r"\b([a-z0-9_]+_kernel)[<(]", name)
    return m.group(1) if m and m.group(1) in SSM_KERNELS + ATTN_KERNELS \
        else None


def window_device_ops(path):
    """As ``device_busy`` reads a trace: the device operations (kernels,
    memcpys, memsets) of the CUDA API calls made inside the profiler's
    window annotation, matched by correlation id."""
    from repro_torch.serving.profiler import WINDOW
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    win = next(e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation")
    lo, hi = win["ts"], win["ts"] + win["dur"]
    ids = {e.get("args", {}).get("correlation") for e in events
           if str(e.get("cat", "")).startswith("cuda_")
           and lo <= e["ts"] <= hi} - {None}
    return [e for e in events if "dur" in e
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and e.get("args", {}).get("correlation") in ids]


def profiled_window(name, prof, fn, static):
    """Run ``fn`` once in a trace window of ``prof`` and hold its
    attribution to checks (a)-(c) against its own trace, read as
    ``device_busy`` reads one: (a) attributed plus unattributed ms equal
    the window's summed kernel, memcpy and memset time within 1%; (b) the
    unattributed time under 2% of it and the window not degraded; (c)
    ``ssm`` at least the hand-written SSM kernels' time by name, and
    ``other`` at least the flash and decode attention kernels'.  Returns
    the class ms and shares, ``unattributed_ms``, ``degraded``, the
    kernel count and the same program's modeled ms by class on
    ``H100_SXM`` (``static``: its walk on ``meta``)."""
    from repro_torch.core.config import H100_SXM
    from repro_torch.core.roofline import op_class_times
    with prof.window(name) as ft:
        fn()
        torch.cuda.synchronize()
    ops = window_device_ops(prof.last_trace)
    os.remove(prof.last_trace)
    total = sum(e["dur"] for e in ops) / 1e3
    got = sum(ft.ms.values()) + ft.unattributed_ms
    by = {}
    for e in ops:
        k = kernel_short_name(e.get("name", "")) if e["cat"] == "kernel" \
            else None
        if k:
            by[k] = by.get(k, 0.0) + e["dur"] / 1e3
    ssm_named = sum(v for k, v in by.items() if k in SSM_KERNELS)
    attn_named = sum(v for k, v in by.items() if k in ATTN_KERNELS)
    if abs(got - total) > 0.01 * total:
        raise AssertionError(f"{name}: attributed {got} ms against the "
                             f"trace's {total} ms")
    if ft.unattributed_ms >= 0.02 * total or ft.degraded:
        # the lengths of the learned sequences, to tell a dropped record
        # from another program
        learned = {g: len(s) for g, s in prof._graphs.items()}
        raise AssertionError(f"{name}: {ft.unattributed_ms} ms "
                             f"unattributed of {total}, degraded "
                             f"{ft.degraded}; operations in the window "
                             f"{len(ops)}, learned graphs {learned}")
    if ft.ms.get("ssm", 0.0) < ssm_named * (1 - 1e-9) or \
            ft.ms.get("other", 0.0) < attn_named * (1 - 1e-9):
        raise AssertionError(f"{name}: ssm {ft.ms.get('ssm')} ms < SSM "
                             f"kernels {ssm_named} or other "
                             f"{ft.ms.get('other')} < attention kernels "
                             f"{attn_named}")
    modeled = {k: v * 1e3 for k, v in sorted(
        op_class_times(static, H100_SXM).items())}
    return dict(class_ms=dict(sorted(ft.ms.items())), shares=ft.shares(),
                unattributed_ms=ft.unattributed_ms, degraded=ft.degraded,
                device_ms=total, kernels=len(ops), wall_ms=ft.wall_ms,
                hand_written_ms=dict(sorted(by.items())),
                modeled_h100_ms=modeled,
                modeled_h100_total_ms=sum(modeled.values()))


def phase_profile(cfg, gen, eng, params, reqs, pos, launches):
    """Phase 8 at ``cfg``'s full width and depth, on phase 4's engine: trace
    windows (``serving/profiler.py``) over one eager 4 x 256 prefill chunk,
    one eager 8-step burst and one replay of that burst's CUDA graph
    (learned at its first call by a runner of its own), each held to
    :func:`profiled_window`'s checks; then phase 4's requests again on a
    fresh engine with a coarse profiler: (d) ``profile_snapshot()`` counts
    as many ``decode`` and ``prefill`` dispatches as the engine ran, each
    key's shares sum to 1; (e) ``overhead_ms`` under 3% of the decode
    wall; (f) the streams and every kernel's launches equal phase 4's (its
    profiler off)."""
    from repro_torch.core.op_analysis import analyze, meta_like
    from repro_torch.models.lm import (decode_tokens, init_spare_states,
                                       lm_prefill_chunk)
    from repro_torch.serving.bucketing import clamped_bucket
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.graphs import make_decode_tokens
    from repro_torch.serving.profiler import Profiler

    prof = Profiler(mode="trace", trace_dir=PROFILE_DIR)
    out = {}
    chunk = torch.randint(0, cfg.vocab_size, (4, 256), generator=gen,
                          device="cuda")
    ckw = dict(kv_bucket=clamped_bucket(max(pos) + 256, eng.kv_extent),
               rope_len=eng.rope_len)
    meta_params, meta_cache = meta_like(eng.params), meta_like(eng.cache)
    out["eager_prefill_chunk_b4_s256"] = profiled_window(
        "prefill", prof,
        lambda: lm_prefill_chunk(cfg, eng.params, chunk, eng.cache,
                                 **ckw)[0].cpu(),
        analyze(lm_prefill_chunk, cfg, meta_params,
                torch.zeros((4, 256), dtype=torch.long, device="meta"),
                meta_cache, **ckw))
    pos_d = torch.tensor(pos, dtype=torch.int32, device="cuda")
    first = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen,
                          device="cuda", dtype=torch.int32)
    bkw = dict(kv_bucket=clamped_bucket(max(pos) + 8, eng.kv_extent),
               rope_len=eng.rope_len)
    burst_static = analyze(
        decode_tokens, cfg, meta_params, dict(meta_cache), first.to("meta"),
        8, _spare_states=init_spare_states(meta_cache), **bkw)

    def eager():
        toks, eng.cache = decode_tokens(
            cfg, eng.params, dict(eng.cache, pos=pos_d), first, 8,
            _spare_states=eng._spare, **bkw)
        toks.cpu()
    out["eager_burst8_b4"] = profiled_window("decode", prof, eager,
                                             burst_static)
    runner = make_decode_tokens(cfg, prof)

    def graph():
        toks, eng.cache = runner(eng.params, dict(eng.cache, pos=pos_d),
                                 first, 8, spare=eng._spare, **bkw)
        toks.cpu()
    graph()                       # learned and captured, outside a window
    replays = runner.replays
    out["graph_replay_burst8_b4"] = profiled_window("decode", prof, graph,
                                                    burst_static)
    if runner.replays != replays + 1:
        raise AssertionError(f"{cfg.name}: the profiled burst was not a "
                             "replay")
    del runner
    torch.cuda.empty_cache()

    coarse = Profiler(mode="coarse")
    ceng = ServingEngine(cfg, params, slots=4, max_seq=4096, chunk_size=256,
                         decode_block=8, device="cuda", profiler=coarse)
    creqs = [Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
             for r in reqs]
    bursts = [0]
    real = ceng._decode_n

    def counted(*a, **kw):
        bursts[0] += 1
        return real(*a, **kw)
    ceng._decode_n = counted
    reset_counters()
    for r in creqs:
        ceng.submit(r)
    ceng.run()
    torch.cuda.synchronize()
    got_launches = read_counters()
    ceng._decode_n = real
    t0 = time.perf_counter()
    snap = ceng.profile_snapshot()
    walk_s = time.perf_counter() - t0
    streams = [list(r.out) for r in creqs]
    if streams != [list(r.out) for r in reqs]:
        raise AssertionError(f"{cfg.name}: streams with a coarse profiler "
                             "differ from phase 4's")
    if got_launches != launches:
        raise AssertionError(f"{cfg.name}: launches {got_launches} with a "
                             f"coarse profiler, phase 4 {launches}")
    c = snap["coarse"]
    want = {"decode": bursts[0], "prefill": ceng.stats["prefill_chunks"]}
    if {k: c[k]["dispatches"] for k in want} != want:
        raise AssertionError(f"{cfg.name}: snapshot dispatches "
                             f"{ {k: c[k]['dispatches'] for k in c} }, "
                             f"engine {want}")
    for k in want:
        if abs(sum(c[k]["shares"].values()) - 1.0) > 1e-9:
            raise AssertionError(f"{cfg.name}: {k} shares {c[k]['shares']}")
    if snap["overhead_ms"] >= 0.03 * c["decode"]["wall_ms"]:
        raise AssertionError(f"{cfg.name}: profiler overhead "
                             f"{snap['overhead_ms']} ms of "
                             f"{c['decode']['wall_ms']} ms decode wall")
    out["coarse_snapshot"] = dict(
        dispatches=want, decode_wall_ms=c["decode"]["wall_ms"],
        prefill_wall_ms=c["prefill"]["wall_ms"],
        decode_shares=c["decode"]["shares"],
        prefill_shares=c["prefill"]["shares"],
        overhead_ms=snap["overhead_ms"],
        overhead_share_of_decode_wall=(snap["overhead_ms"]
                                       / c["decode"]["wall_ms"]),
        registration_walks_s=walk_s, streams_equal_phase4=True,
        launches_equal_phase4=True)
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


# ------------------------------------------------------------ phase 10

# the backward kernels' limits: fp32 within 1e-4 of each gradient's max
# |g| (sums in another order), bf16 within 3% (each output one bf16
# rounding, the inputs the same bf16 values on both sides)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def bwd_counters():
    """The backward kernels' launch counters, by row name."""
    from repro_torch.kernels.conv1d import ops as conv_ops
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.scan1 import ops as scan_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return {"flash_bwd": flash_ops.flash_attention_bwd_cuda,
            "ssd_bwd": ssd_ops.ssd_chunked_bwd_cuda,
            "conv1d_bwd": conv_ops.causal_conv1d_bwd_cuda,
            "scan1_bwd": scan_ops.selective_scan_bwd_cuda}


FLASH_BWD_MODES = ("causal", "window", "noncausal")


def reset_train_counters():
    reset_counters()
    for fn in bwd_counters().values():
        fn.launches = 0
    modes = bwd_counters()["flash_bwd"].mode_launches
    for m in FLASH_BWD_MODES:
        modes[m] = 0


def read_train_counters():
    """The forward kernels' launches (those above 0), every backward
    kernel's, and the flash backward's by mode (``flash_bwd.window``,
    ...)."""
    out = {k: v for k, v in read_counters().items() if v}
    out.update({k: fn.launches for k, fn in bwd_counters().items()})
    modes = bwd_counters()["flash_bwd"].mode_launches
    out.update({f"flash_bwd.{m}": modes[m] for m in FLASH_BWD_MODES})
    return out


def event_ms(fn, reps: int = 5) -> float:
    """Device time of one ``fn()`` between CUDA events, after one warm-up
    call; median over ``reps`` (for calls a CUDA graph cannot hold, such
    as an autograd backward)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def hold_bwd(name, dt, got, again, want) -> float:
    """Each gradient within ``BWD_TOL`` of its own max |g|, and a second
    call bit for bit; returns the largest ratio to the limit."""
    worst = 0.0
    for i, (a, a2, b) in enumerate(zip(got, again, want)):
        if a.shape != b.shape:
            raise AssertionError(f"{name} {dt} output {i}: {a.shape} != "
                                 f"{b.shape}")
        if not torch.equal(a, a2):
            raise AssertionError(f"{name} {dt} output {i}: two calls differ")
        r = whole_ratio(a, b, BWD_TOL[dt], floor=torch.finfo(
            torch.float32).tiny)
        if not r <= 1.0:
            raise AssertionError(f"{name} {dt} output {i}: error {r} x its "
                                 f"limit ({BWD_TOL[dt]} of max |g|)")
        worst = max(worst, r)
    return worst


def bwd_cases(gen, dt, b: int, s: int, names=None):
    """The backward kernels' calls and plain versions, B=``b``, S=``s``, in
    ``dt``: name -> (kernel call, plain call, inputs, work, library call
    or None), only the ``names`` given (None: all).  zamba2-2.7b's SSD,
    conv1d and the shared block's flash (32 heads of 80), smollm-135m's
    flash (9 query heads on 3, d=64); mamba-130m's selective scan (C =
    1536, N = 16; ``scan1_bwd_tiles`` with the final state's gradient)
    and conv1d (C = 1536); gemma3-1b's flash (4 query heads
    on 1, d = 256) in its sliding window of 512 and causal; hubert-
    xlarge's non-causal flash (16 heads of 80).  The work is the FLOPs
    the function needs, or ("exponentials", n) for the scan: flash's five
    products (S, dP, dV, dK, dQ), 10 d a (query, key) pair the masks
    leave; SSD's per chunk and head C B^T, dy x^T, and the three products
    with them over the causal half, and the four with the states (B
    dh'^T, x^T dh', dy h, dy^T C); conv1d's 6 K + 7 an element; the
    scan's one exponential a (step, channel, state)."""
    from repro_torch.configs import (gemma3_1b, hubert_xlarge, mamba_130m,
                                     smollm_135m, zamba2_2p7b)
    from repro_torch.kernels.conv1d import ops as conv_ops
    from repro_torch.kernels.conv1d import ref as conv_ref
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref
    from repro_torch.kernels.scan1 import ops as scan_ops
    from repro_torch.kernels.scan1 import ref as scan_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref
    import torch.nn.functional as F

    def rn(*shape, dtype=dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def want(name):
        return names is None or name in names

    z, sm, m1 = zamba2_2p7b, smollm_135m, mamba_130m
    sc = z.ssm
    H, P, N, G, K, Q = (sc.n_ssm_heads(z.d_model), sc.headdim, sc.d_state,
                        sc.n_groups, sc.conv_kernel, sc.chunk)
    cases = {}
    if want("ssd_bwd"):
        (x, dts, A, Bm, Cm, D), _ = ssd_ref.model_scale_inputs(gen, b, s, H,
                                                               P, N, dt)
        dy = rn(b, s, H, P)
        _, _, st = ssd_ops.ssd_chunked_cuda(x, dts, A, Bm, Cm, D, chunk=Q,
                                            chunk_states=True)
        qh, nc = Q * (Q + 1) // 2, s // Q
        ssd_in = (x, dts, A, Bm, Cm, D, dy, st)
        cases["ssd_bwd"] = (
            lambda: ssd_ops.ssd_chunked_bwd_cuda(*ssd_in, chunk=Q),
            lambda: ssd_ref.ssd_chunked_bwd_ref(*ssd_in, chunk=Q), ssd_in,
            2.0 * b * H * nc * (qh * (3 * N + 2 * P) + 4 * Q * P * N), None)

    for name, C, k_ in (
            ("conv1d_bwd", sc.d_inner(z.d_model) + 2 * G * N, K),
            ("conv1d_bwd_mamba130m", m1.ssm.d_inner(m1.d_model),
             m1.ssm.conv_kernel)):
        if not want(name):
            continue
        xc, dyc = rn(b, s, C), rn(b, s, C)
        w, bias = 0.5 * rn(C, k_, dtype=torch.float32), 0.1 * rn(
            C, dtype=torch.float32)
        conv_in = (xc, w, bias, dyc)
        xl = xc.detach().transpose(1, 2).contiguous().requires_grad_()
        wl = w[:, None, :].detach().requires_grad_()
        bl = bias.detach().requires_grad_()
        yl = F.silu(F.conv1d(xl, wl.to(dt), bl.to(dt), padding=k_ - 1,
                             groups=C)[..., :s])
        dyl = dyc.transpose(1, 2).contiguous()
        cases[name] = (
            lambda conv_in=conv_in: conv_ops.causal_conv1d_bwd_cuda(*conv_in),
            lambda conv_in=conv_in: conv_ref.causal_conv1d_bwd_ref(*conv_in),
            conv_in, (6.0 * k_ + 7.0) * b * s * C,
            lambda yl=yl, ins=(xl, wl, bl), dyl=dyl: torch.autograd.grad(
                yl, ins, dyl, retain_graph=True))

    for name, with_final in (("scan1_bwd", False), ("scan1_bwd_tiles", True)):
        if not want(name):
            continue
        C, N1 = m1.ssm.d_inner(m1.d_model), m1.ssm.d_state
        (x, dts, A, Bm, Cm, D), _ = scan_ref.model_scale_inputs(gen, b, s, C,
                                                                N1, dt)
        scan_in = (x, dts, A, Bm, Cm, D, rn(b, s, C))
        if with_final:
            scan_in += (rn(b, C, N1, dtype=torch.float32),)
        cases[name] = (
            lambda scan_in=scan_in:
                scan_ops.selective_scan_bwd_cuda(*scan_in),
            lambda scan_in=scan_in:
                scan_ref.selective_scan_bwd_ref(*scan_in), scan_in,
            ("exponentials", b * s * C * N1), None)

    g3 = gemma3_1b.attn
    for name, a, causal, window in (
            ("flash_bwd", z.shared_attn, True, None),
            ("flash_bwd_smollm", sm.attn, True, None),
            ("flash_bwd_window", g3, True, g3.sliding_window),
            ("flash_bwd_d256", g3, True, None),
            ("flash_bwd_noncausal", hubert_xlarge.attn, False, None)):
        if not want(name):
            continue
        q = rn(b, a.n_heads, s, a.head_dim)
        k, v = (rn(b, a.n_kv_heads, s, a.head_dim) for _ in range(2))
        o, lse = flash_ops.flash_attention_cuda(q, k, v, causal=causal,
                                                window=window, lse=True)
        do = rn(b, a.n_heads, s, a.head_dim)
        fin = (q, k, v, o, do, lse)
        masks = dict(causal=causal, window=window)
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        g = a.n_heads // a.n_kv_heads
        mask = (None if window is None else flash_ref.full_mask(
            s, s, causal, window, "cuda"))
        ol = F.scaled_dot_product_attention(
            ql, kl.repeat_interleave(g, 1), vl.repeat_interleave(g, 1),
            attn_mask=mask, is_causal=causal and mask is None)
        pairs = (s * s if not causal else
                 sum(min(i + 1, window or s) for i in range(s)))
        cases[name] = (
            lambda fin=fin, masks=masks:
                flash_ops.flash_attention_bwd_cuda(*fin, **masks),
            lambda fin=fin, masks=masks:
                flash_ref.flash_bwd_ref(*fin, **masks), fin,
            10.0 * a.head_dim * b * a.n_heads * pairs,
            lambda ol=ol, do=do, ins=(ql, kl, vl): torch.autograd.grad(
                ol, ins, do, retain_graph=True))
    return cases


def bwd_route(key, ins):
    """The route a backward kernel's plan takes for the inputs of
    ``bwd_cases`` (wgmma, mma or cuda_cores; conv1d and the scan have
    one)."""
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    if key.startswith("flash_bwd"):
        q, k = ins[0], ins[1]
        return flash_ops.flash_bwd_plan(q.shape[0], q.shape[1], k.shape[1],
                                        q.shape[2], q.shape[3],
                                        q.dtype).route
    if key == "ssd_bwd":
        x, bm = ins[0], ins[3]
        b, s, h, p = x.shape
        chunk = s // ins[7].shape[2]
        return ssd_ops.ssd_bwd_plan(b, s, h, chunk, p, bm.shape[2],
                                    bm.shape[3], x.dtype).route
    return "cuda_cores"


# each backward row's source and the TPU kernel whose gradient it is
BWD_SOURCES = {
    "flash_bwd": ("flash_bwd.cu", "src/repro/kernels/flash/kernel.py:124"),
    "ssd_bwd": ("ssd_bwd.cu", "src/repro/kernels/ssd/kernel.py:68"),
    "conv1d_bwd": ("conv1d_bwd.cu", "src/repro/kernels/conv1d/kernel.py:37"),
    "scan1_bwd": ("scan1_bwd.cu", "src/repro/kernels/scan1/kernel.py:52")}
# the checks in both types: (name, B, S); B=4, S=512, but gemma3-1b's
# window (512) over S=1300, so that the band's edges fall inside the
# sequence and inside tiles, hubert-xlarge's non-causal flash at S=500,
# off a tile, so keys past S fall in its last tiles, and the scan's
# backward also over S=700 (three 256-step tiles, the last ragged) with
# the final state's gradient
BWD_CHECKS = (("ssd_bwd", 4, 512), ("conv1d_bwd", 4, 512),
              ("conv1d_bwd_mamba130m", 4, 512), ("scan1_bwd", 4, 512),
              ("scan1_bwd_tiles", 2, 700),
              ("flash_bwd", 4, 512), ("flash_bwd_smollm", 4, 512),
              ("flash_bwd_window", 2, 1300), ("flash_bwd_d256", 4, 512),
              ("flash_bwd_noncausal", 4, 500))
# the rows timed at the training shapes: (name, B, S)
BWD_ROWS = (("ssd_bwd", 4, 2048), ("conv1d_bwd", 4, 2048),
            ("flash_bwd", 4, 2048), ("flash_bwd_smollm", 8, 2048),
            ("scan1_bwd", 8, 2048), ("conv1d_bwd_mamba130m", 8, 2048),
            ("flash_bwd_window", 4, 2048), ("flash_bwd_d256", 4, 2048),
            ("flash_bwd_noncausal", 4, 1500))


def bwd_key(name: str) -> str:
    """A row's kernel: flash_bwd, ssd_bwd, conv1d_bwd or scan1_bwd."""
    return next(k for k in BWD_SOURCES if name.startswith(k))


def phase_backward_kernels(gen):
    """(a) Each backward kernel against its plain backward at ``BWD_CHECKS``
    in bf16 and fp32, repeated bit for bit; then in bf16 at the training
    shapes (``BWD_ROWS``: zamba2-2.7b's B=4, S=2048; smollm-135m's flash,
    mamba-130m's scan and conv1d at B=8; gemma3-1b's flash at B=4 in its
    window and causal at d = 256; hubert-xlarge's non-causal flash at
    B=4, S=1500) held the same way and timed: ms, the plain version's,
    autograd of the library call's (SDPA: causal, with the window as a
    boolean mask, non-causal; F.conv1d with groups=C then SiLU; none for
    SSD and the scan) and the bound; each row also says the plan's
    route, its share of the bound and its ratio to the library call.
    Returns the kernels line's rows (without launches) and the checks."""
    checks = {}
    for dt in (torch.bfloat16, torch.float32):
        for name, b, s in BWD_CHECKS:
            kern, plain, *_rest = bwd_cases(gen, dt, b, s, (name,))[name]
            got, again, want = kern(), kern(), plain()
            checks[f"{name} {dt}"] = dict(
                max_abs_err=max_err(got, want),
                of_limit=hold_bwd(name, dt, got, again, want))
            del got, again, want, kern, plain, _rest
        torch.cuda.empty_cache()
    rows = {}
    for name, b, s in BWD_ROWS:
        kern, plain, ins, work, lib = bwd_cases(gen, torch.bfloat16, b, s,
                                                (name,))[name]
        got, again, want = kern(), kern(), plain()
        of_limit = hold_bwd(name, torch.bfloat16, got, again, want)
        del again
        moved = nbytes(*ins) + nbytes(*got)
        if isinstance(work, tuple):   # the scan: its exponentials
            t_bytes = moved / HBM_BYTES_PER_S * 1e3
            t_exp = work[1] / EX2_PER_S * 1e3
            bms, by = max((t_bytes, "bytes"), (t_exp, "operations"))
        else:
            bms, by = bound(moved, work, torch.bfloat16)
        key = bwd_key(name)
        lib_ms = None if lib is None else event_ms(lib, 5)
        row = dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{BWD_SOURCES[key][0]}",
            replaces=BWD_SOURCES[key][1], shape=f"B={b}, S={s}",
            kernel_route=bwd_route(key, ins),
            max_abs_err=max_err(got, want), of_limit=of_limit,
            ms=device_ms(kern, 2, 5),
            plain_ms=event_ms(plain, 3), bound_ms=bms, bound_by=by,
            library_ms=lib_ms)
        row["of_bound"] = bms / row["ms"]
        row["over_library"] = (None if lib_ms is None
                               else row["ms"] / lib_ms)
        rows[name] = row
        del got, want, kern, plain, ins, lib
        torch.cuda.empty_cache()
    return rows, checks


def plain_training():
    """The training path's kernels swapped for their plain versions, which
    autograd differentiates (no kernel launches)."""
    from repro_torch.kernels.conv1d import ref as conv_ref
    from repro_torch.kernels.flash import ref as flash_ref
    from repro_torch.kernels.scan1 import ref as scan_ref
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.models import attention as attn
    from repro_torch.models import mamba1 as m1
    from repro_torch.models import mamba2 as m2

    def ssd(x, dt_raw, dt_bias, A_log, Bm, Cm, D, *, chunk, initial_state,
            out_state=None):
        dt, A = ssd_ref.preprocess_dt_A(dt_raw, dt_bias, A_log)
        return ssd_ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=chunk)

    def conv(x, w, b, *, initial_state=None, activation="silu", lengths=None,
             out_state=None):
        return conv_ref.causal_conv1d_ref(x, w, b)

    def flash(q, k, v, *, causal=True, window=None, **_):
        return flash_ref.attention_ref(q, k, v, causal=causal, window=window)

    def scan(x, dt, A, Bm, Cm, D, *, initial_state=None, out_state=None):
        return scan_ref.selective_scan_ref(x, dt, A, Bm, Cm, D)

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(m2, "ssd_chunked_raw", ssd))
    stack.enter_context(mock.patch.object(m2, "causal_conv1d", conv))
    stack.enter_context(mock.patch.object(m1, "causal_conv1d", conv))
    stack.enter_context(mock.patch.object(m1, "selective_scan", scan))
    stack.enter_context(mock.patch.object(attn, "flash_attention", flash))
    return stack


# the layer kinds with an attention sublayer, and the flash backward's mode
# each trains in
ATTN_MODES = {"dense": "causal", "mamba2+shared": "causal", "moe": "causal",
              "dense_moe": "causal", "local": "window",
              "encoder": "noncausal"}


def train_launches(cfg) -> dict:
    """Exact launches of one training step of ``cfg`` under remat: each
    unit's forward kernels twice (the forward, then its recomputation in
    the backward), each backward kernel once, per layer; the flash
    backward's by mode too (a ``local`` layer's window, an ``encoder``'s
    non-causal)."""
    fwd = {"causal_conv1d": 0, "ssd_chunked": 0, "flash_attention": 0,
           "selective_scan": 0}
    modes = dict.fromkeys(FLASH_BWD_MODES, 0)
    for kind in cfg.layer_kinds:
        if kind in ("mamba2", "mamba2+shared"):
            fwd["causal_conv1d"] += 1
            fwd["ssd_chunked"] += 1
        if kind == "mamba1":
            fwd["causal_conv1d"] += 1
            fwd["selective_scan"] += 1
        if kind in ATTN_MODES:
            fwd["flash_attention"] += 1
            modes[ATTN_MODES[kind]] += 1
    out = {k: 2 * n for k, n in fwd.items() if n}
    for k, bk in (("causal_conv1d", "conv1d_bwd"), ("ssd_chunked", "ssd_bwd"),
                  ("flash_attention", "flash_bwd"),
                  ("selective_scan", "scan1_bwd")):
        out[bk] = fwd[k]
    out.update({f"flash_bwd.{m}": n for m, n in modes.items()})
    return out


# a MoE model's gradients where the two paths routed some choice apart
# (a near tie of the router flips with the attention's rounding): each
# leaf's cosine at least this, as the CPU tests' bf16 rule
MOE_FLIP_COSINE = 0.98


def phase_train_paths(cfg, gen, n_layers: int, compute_dtype: str,
                      b: int = 2, s: int = 512, step: bool = True) -> dict:
    """(b) One ``make_train_step`` loss and gradient of ``cfg`` cut to
    ``n_layers`` (fp32 masters, ``compute_dtype``), B=``b``, S=``s``
    (``synthetic_for``'s first batch: the needle tokens, frame features,
    or patch features before tokens), through the kernels against
    autograd through the plain versions on the card, from the same
    params and inputs.  fp32:
    loss within 1e-4 relative, each leaf's gradient within 1e-3 of its
    max |g|; bf16: loss within 2%, the global gradient norm within 5%,
    each leaf's cosine >= 0.99 (at full depth: the shared block's and
    the embedding's, the leaves used more than once).  A MoE model's
    routers' choices are recorded in both runs: where any differs (a near
    tie flipped by the attention's rounding), each leaf's cosine must be
    at least ``MOE_FLIP_COSINE`` instead, and the share that differs is
    printed.  The kernel run launches exactly ``train_launches``; the
    plain run none.  Then, with ``step``, the step itself (AdamW) through
    the kernels: finite loss and grad norm (qwen3-moe's step runs in (d)
    instead: its fp32 masters, moments and gradients at once outgrow the
    card)."""
    from repro_torch.data.synthetic import synthetic_for
    from repro_torch.models.lm import init_lm_params
    from repro_torch.models.params import tree_leaves, tree_unflatten
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_loss_fn, make_train_step
    cfg_n = dataclasses.replace(cfg, n_layers=n_layers,
                                compute_dtype=compute_dtype)
    params = init_lm_params(cfg_n, gen, device="cuda")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in synthetic_for(cfg, s, b).batch(0).items()}
    loss_fn = make_loss_fn(cfg_n)
    routes = {"kern": [], "plain": []}

    def grads(which):
        live = [t.detach().requires_grad_() for t in tree_leaves(params)]
        with recording_routes(routes[which]):
            loss = loss_fn(tree_unflatten(params, live), batch)
            got = torch.autograd.grad(loss, live, allow_unused=True)
        return loss.detach(), [torch.zeros_like(t) if g is None else g
                               for t, g in zip(live, got)]

    reset_train_counters()
    loss_k, g_k = grads("kern")
    torch.cuda.synchronize()
    launched = read_train_counters()
    want = train_launches(cfg_n)
    if launched != want:
        raise AssertionError(f"{cfg.name}: launches {launched} != {want}")
    reset_train_counters()
    with plain_training():
        loss_p, g_p = grads("plain")
    torch.cuda.synchronize()
    plain_launched = {k: v for k, v in read_train_counters().items() if v}
    if plain_launched:
        raise AssertionError(f"the plain path launched {plain_launched}")
    lk, lp = float(loss_k), float(loss_p)
    gn_k = float(torch.sqrt(sum(g.float().square().sum() for g in g_k)))
    gn_p = float(torch.sqrt(sum(g.float().square().sum() for g in g_p)))
    worst, worst_cos = 0.0, 1.0
    for a, p in zip(g_k, g_p):
        a, p = a.float(), p.float()
        top = float(p.abs().max())
        worst = max(worst, float((a - p).abs().max()) / max(top, 1e-30))
        den = float(a.norm() * p.norm())
        worst_cos = min(worst_cos, float((a * p).sum()) / den if den else 1.0)
    out = dict(loss=lk, plain_loss=lp, grad_norm=gn_k, plain_grad_norm=gn_p,
               worst_leaf_err_of_max=worst, worst_leaf_cosine=worst_cos,
               launches=launched, leaves=len(g_k))
    flipped = 0
    if cfg.moe is not None:
        if len(routes["kern"]) != len(routes["plain"]):
            raise AssertionError(f"{cfg.name}: the paths made different "
                                 "router calls")
        total = 0
        for (a, _), (p, _) in zip(routes["kern"], routes["plain"]):
            miss = ~(a[:, :, None] == p[:, None, :]).any(-1)
            flipped += int(miss.sum())
            total += miss.numel()
        out.update(routed_choices=total, choices_differ=flipped,
                   choices_differ_share=flipped / total)
    del routes
    # the leaves used more than once: the shared block (at each
    # mamba2+shared position) and a tied embedding (lookup and head)
    at = {id(t): i for i, t in enumerate(tree_leaves(params))}
    multi = {"embed": [params["embed"]]} if "embed" in params else {}
    if "shared" in params:
        multi["shared"] = tree_leaves(params["shared"])
    for key, leaves in multi.items():
        i = [at[id(t)] for t in leaves]
        a = torch.cat([g_k[j].float().ravel() for j in i])
        p = torch.cat([g_p[j].float().ravel() for j in i])
        den = float(a.norm() * p.norm())
        out[f"{key}_grad_cosine"] = float((a * p).sum()) / den if den else 1.0
        out[f"{key}_grad_norm_ratio"] = (float(a.norm() / p.norm())
                                         if float(p.norm()) else 1.0)
    if not (math.isfinite(lk) and math.isfinite(gn_k)):
        raise AssertionError(f"{cfg.name}: non-finite loss or grad norm")
    # the cosines held: every leaf's at the cut depths; at full depth
    # (54 bf16 layers) those of the leaves used more than once (the
    # shared block at its 9 positions, the embedding), whose sums the
    # case is there to show
    cosines = ([worst_cos] if n_layers < cfg.n_layers else
               [v for k, v in out.items() if k.endswith("_grad_cosine")])
    if flipped:
        if worst_cos < MOE_FLIP_COSINE or abs(lk - lp) > 0.02 * abs(lp):
            raise AssertionError(f"{cfg.name} {compute_dtype}: "
                                 f"{flipped} routed choices differ; loss "
                                 f"{lk} vs {lp}, worst leaf cosine "
                                 f"{worst_cos}")
    elif compute_dtype == "float32":
        if abs(lk - lp) > 1e-4 * abs(lp) or worst > 1e-3:
            raise AssertionError(f"{cfg.name} fp32: loss {lk} vs {lp}, "
                                 f"worst leaf {worst} of its max")
    elif (abs(lk - lp) > 0.02 * abs(lp) or abs(gn_k - gn_p) > 0.05 * gn_p
          or min(cosines) < 0.99):
        raise AssertionError(f"{cfg.name} bf16: loss {lk} vs {lp}, grad "
                             f"norm {gn_k} vs {gn_p}, cosines {cosines}")
    del g_k, g_p
    if not step:
        return out
    opt = OptConfig()
    _, _, m = make_train_step(cfg_n, opt)(params, init_opt_state(params, opt),
                                          batch)
    if not (math.isfinite(float(m["loss"]))
            and math.isfinite(float(m["grad_norm"]))):
        raise AssertionError(f"{cfg.name}: the step's loss or norm is not "
                             "finite")
    return out


def model_flops(cfg, b: int, s: int) -> float:
    """A training step's model FLOPs: 6 N per token, N counting each
    weight once per application (the shared block at every
    ``mamba2+shared`` position; a MoE layer's routed experts only,
    ``active_param_count``), plus attention's products over the (query,
    key) pairs its masks leave (the causal half, a ``local`` layer's
    window, an encoder's every pair), 12 d a pair and head (forward and
    backward)."""
    from repro_torch.core.memmodel import active_param_count
    n_shared = cfg.layer_kinds.count("mamba2+shared")
    n = active_param_count(cfg)
    if n_shared:   # param_count holds the shared block once
        a, d = cfg.shared_attn, cfg.d_model
        q, kv = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
        n += (n_shared - 1) * (d * (q + 2 * kv) + q * d
                               + 3 * d * cfg.shared_attn_d_ff)
    attn = 0.0
    for kind in cfg.layer_kinds:
        if kind not in ATTN_MODES:
            continue
        a = cfg.shared_attn if kind == "mamba2+shared" else cfg.attn
        mode = ATTN_MODES[kind]
        if mode == "noncausal":
            pairs = s * s
        elif mode == "window" and a.sliding_window:
            w = a.sliding_window
            pairs = min(w, s) * (min(w, s) + 1) / 2 + max(0, s - w) * w
        else:
            pairs = s * (s + 1) / 2
        attn += 12.0 * a.head_dim * a.n_heads * b * pairs
    return 6.0 * n * b * s + attn


FWD_KERNELS = ("flash_wgmma_kernel", "ssd_tc_kernel", "conv1d_kernel",
               "scan1_kernel")
BWD_KERNELS = ("flash_bwd", "ssd_bwd", "conv1d_bwd", "scan1_bwd")


def bwd_route_kernels(cfg) -> dict:
    """The CUDA kernels of each backward row's bf16 route in a training
    step of ``cfg``: flash's wgmma kernels at head dims 64 to 128 and its
    CUDA-core ones at 256, SSD's tensor-core passes, conv1d's one, the
    scan's three."""
    from repro_torch.kernels.flash import ops as flash_ops
    heads = {cfg.shared_attn.head_dim if kind == "mamba2+shared"
             else cfg.attn.head_dim
             for kind in cfg.layer_kinds if kind in ATTN_MODES}
    flash = set()
    for d in heads:
        flash |= ({"flash_bwd_stats", "flash_bwd_dkdv_wgmma",
                   "flash_bwd_dq_wgmma"}
                  if d in flash_ops.BWD_WGMMA_HEAD_DIMS else
                  {"flash_bwd_rowdot", "flash_bwd_dkdv", "flash_bwd_dq"})
    return {"flash_bwd": sorted(flash),
            "ssd_bwd": ["ssd_bwd_local", "ssd_bwd_state", "ssd_bwd_chunk",
                        "ssd_bwd_finish_tc"],
            "conv1d_bwd": ["conv1d_bwd"],
            "scan1_bwd": ["scan1_bwd_states", "scan1_bwd_kernel",
                          "scan1_bwd_finish"]}


def check_trace_names(cfg, names, launched) -> list:
    """Each traced kernel's name holds at most one of FWD_KERNELS and
    BWD_KERNELS (so ``by_name`` sums it into one row), and every kernel of
    each launched backward's route was traced.  Returns the backward
    kernels' names."""
    for kname in names:
        held = [n for n in FWD_KERNELS + BWD_KERNELS if n in kname]
        if len(held) > 1:
            raise AssertionError(f"{cfg.name}: traced kernel {kname} holds "
                                 f"{held}, summed into more than one row")
    for row, kerns in bwd_route_kernels(cfg).items():
        if not launched.get(row):
            continue
        for k in kerns:
            if not any(k in kname for kname in names):
                raise AssertionError(f"{cfg.name}: {row}'s kernel {k} is "
                                     "not in the traced step")
    return [k for k in names if any(n in k for n in BWD_KERNELS)]


def phase_train_full(cfg, gen, b: int, s: int, steps: int = 8,
                     restart_at=None) -> dict:
    """(c), (d) ``cfg`` at full width and depth through ``Trainer``: fp32
    masters, bf16 compute, ``OptConfig()``, ``steps`` steps of B=``b`` x
    S=``s`` of the synthetic needle stream.  With ``restart_at`` the run
    checkpoints at that step (``ckpt_every`` 0: the one checkpoint is the
    end of a run of ``restart_at`` steps, in a temporary directory under
    ``build/``), goes on to ``steps``, and a fresh ``Trainer`` restored
    from it replays the rest: its losses equal the first run's within
    rtol 1e-5 (the reference's rule).  Every loss and gradient norm is
    finite and the params change.  Prints the median step ms (host clock
    around each step, which ends in reading the loss), tokens/s, the
    model-FLOPs share of 989 TFLOP/s, peak memory (the most any step
    allocated) beside the params and moments at rest, the launches of the
    run, and one more step traced: the backward kernels' time against the
    forward kernels', each backward route's kernels found in the trace by
    name (``check_trace_names``).  The first step's batch is evaluated
    (no gradient) before the first step and after the last: its loss
    must fall (each step's own loss moves with its batch more than with
    8 steps at the warmup's learning rate, at most 2.4e-5)."""
    import shutil
    import tempfile
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    here = os.path.dirname(os.path.abspath(__file__))
    tmp_root = os.path.join(here, "build", "repro_torch")
    os.makedirs(tmp_root, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="train_ckpt_", dir=tmp_root)
    first = restart_at or steps
    metrics = []

    def recording(trainer):
        step = trainer._step_fn

        def fn(params, opt_state, batch):
            torch.cuda.reset_peak_memory_stats()
            out = step(params, opt_state, batch)
            metrics.append(dict({k: float(v) for k, v in out[2].items()},
                                peak=torch.cuda.max_memory_allocated()))
            return out
        trainer._step_fn = fn

    gc.collect()
    torch.cuda.empty_cache()
    # what earlier phases still hold (1.17 GB read before zamba2-2.7b's
    # run on an H100 80GB HBM3): its 48 GB peak needs the rest of the card
    held = torch.cuda.memory_allocated()
    if held > 8 << 30:
        raise AssertionError(f"{cfg.name}: {held} B of device memory still "
                             "held before training at full size")
    from repro_torch.train.train_step import make_loss_fn
    loss_fn = make_loss_fn(cfg)

    def batch_loss(trainer, batch) -> float:
        with torch.no_grad():
            return float(loss_fn(trainer.params, batch))
    try:
        t1 = Trainer(cfg, OptConfig(), TrainerConfig(
            steps=first, ckpt_every=0, log_every=10 ** 9,
            ckpt_dir=ckpt_dir if restart_at else None),
            seq_len=s, global_batch=b)
        at_rest = torch.cuda.memory_allocated()
        batch0 = {k: torch.as_tensor(v, device="cuda")
                  for k, v in t1.batch_fn(0).items()}
        loss0_before = batch_loss(t1, batch0)
        recording(t1)
        probe = [t.detach().float().sum() for t in tree_leaves(t1.params)]
        reset_train_counters()
        t1.run(log=lambda *_: None)
        if restart_at:
            t1.ckpt = None
            t1.tcfg = dataclasses.replace(t1.tcfg, steps=steps)
            t1.run(log=lambda *_: None)
        torch.cuda.synchronize()
        launched = read_train_counters()
        want = {k: steps * n for k, n in train_launches(cfg).items()}
        if launched != want:
            raise AssertionError(f"{cfg.name}: {steps} steps launched "
                                 f"{launched}, not {want}")
        loss0_after = batch_loss(t1, batch0)
        del batch0
        peak = max(m["peak"] for m in metrics)
        changed = sum(int(bool(t.detach().float().sum() != p0))
                      for t, p0 in zip(tree_leaves(t1.params), probe))
        losses = list(t1.state.losses)
        times = list(t1.state.step_times)
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in t1.batch_fn(steps).items()}
        names = FWD_KERNELS + BWD_KERNELS
        busy = device_busy(lambda: t1._step_fn(t1.params, t1.opt_state,
                                               batch), names)
        bwd_names = check_trace_names(cfg, busy["kernel_names"], launched)
        del t1, probe, batch
        torch.cuda.empty_cache()
        replay = None
        if restart_at:
            t2 = Trainer(cfg, OptConfig(), TrainerConfig(
                steps=steps, ckpt_every=0, log_every=10 ** 9,
                ckpt_dir=ckpt_dir), seq_len=s, global_batch=b)
            if not t2.maybe_restore() or t2.state.step != restart_at:
                raise AssertionError(f"{cfg.name}: no checkpoint at step "
                                     f"{restart_at}")
            t2.ckpt = None
            t2.run(log=lambda *_: None)
            replay = list(t2.state.losses)
            del t2
            torch.cuda.empty_cache()
            want = losses[restart_at:]
            if len(replay) != len(want) or any(
                    abs(x - y) > 1e-5 * abs(y) for x, y in zip(replay, want)):
                raise AssertionError(f"{cfg.name}: the restored run's losses "
                                     f"{replay} != {want}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in metrics):
        raise AssertionError(f"{cfg.name}: non-finite loss or grad norm")
    if not changed:
        raise AssertionError(f"{cfg.name}: no param changed")
    if not loss0_after < loss0_before:
        raise AssertionError(f"{cfg.name}: the first batch's loss did not "
                             f"fall over {steps} steps: {loss0_before} -> "
                             f"{loss0_after}")
    med = statistics.median(times)
    fwd_ms = sum(busy["by_name"][n]["kernel_ms"] for n in FWD_KERNELS)
    bwd_ms = sum(busy["by_name"][n]["kernel_ms"] for n in BWD_KERNELS)
    return dict(
        batch=b, seq=s, steps=steps, losses=losses,
        first_batch_loss=[loss0_before, loss0_after], replayed=replay,
        grad_norms=[m["grad_norm"] for m in metrics[:steps]],
        step_ms=[t * 1e3 for t in times], median_step_ms=med * 1e3,
        tokens_per_s=b * s / med,
        model_flops_per_step=model_flops(cfg, b, s),
        model_flops_share=model_flops(cfg, b, s) / med / 989e12,
        peak_memory_allocated=peak, held_before_bytes=held,
        params_and_moments_bytes=at_rest - held,
        params_changed=changed,
        launches=launched, traced_step=dict(
            wall_ms=busy["wall_ms"], kernel_busy_ms=busy["kernel_busy_ms"],
            kernels=busy["kernels"], idle_share=busy["idle_share"],
            by_name=busy["by_name"], backward_kernels=bwd_names,
            backward_kernel_ms=bwd_ms,
            forward_kernel_ms=fwd_ms,
            backward_over_forward=bwd_ms / fwd_ms if fwd_ms else None))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    from repro_torch.configs import (falcon_h1_05b, gemma3_1b, glm4_9b,
                                     hubert_xlarge, hymba_15b, llama3_8b,
                                     llama4_maverick, llava_next,
                                     mamba2_2p7b, mamba_130m,
                                     qwen3_moe_235b, smollm_135m,
                                     zamba2_2p7b)
    from repro_torch.configs.paper_models import (LLAMA32_1B, MAMBA2_130M,
                                                  MAMBA2_780M, PHI3_MINI,
                                                  QWEN25_05B, QWEN25_15B,
                                                  ZAMBA2_12B)
    from repro_torch.kernels import build

    card = card_line()
    print(f"phase 1 card: {card}", flush=True)
    print(f"phase 1 idle power draw: {idle_power_w()} W", flush=True)
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
    # the paper's models: SSD and the decode step at zamba2-1.2b's d_state
    # 64 (64 heads), at 48 and 24 heads; conv1d at C = 4224, 3328, 1792
    for cfg in (mamba2_2p7b, zamba2_2p7b, falcon_h1_05b, ZAMBA2_12B,
                MAMBA2_780M, MAMBA2_130M):
        for r in phase_kernels(cfg, gen):
            rows.append(dict(r, at=cfg.name))
    rows += phase_attention(gen)
    m1_rows, long_scan = phase_mamba1_kernels(mamba_130m, gen)
    rows += m1_rows
    ring_rows = phase_ring(gen)
    rows += ring_rows
    rows.append(encoder_flash(gen))
    for r in rows:
        print(f"phase 3 kernel at {r['at']}: " + json.dumps(r), flush=True)
    print("phase 3 long-context selective scan at mamba-130m's width: "
          + json.dumps(long_scan), flush=True)
    # the kernels line: zamba2-2.7b's shapes, the path that runs the five
    # Mamba-2 and attention kernels, mamba-130m's for the Mamba-1 two, and
    # gemma3-1b's serving chunk (bf16) for the ring mode
    paper_rows = [r for r in rows if r["at"] in PAPER_MODELS]
    rows = [r for r in rows if r["at"] == zamba2_2p7b.name
            or (r["at"] == mamba_130m.name and r["name"] != "causal_conv1d")]
    rows.append(dict(ring_rows[0], at=gemma3_1b.name))

    # qwen3-moe-235b-a22b: 8 of its 94 layers (2.49 B parameters a layer;
    # all 94 need about 470 GB in bf16), params stored in bf16 (42.3 GB)
    qwen3_8 = dataclasses.replace(qwen3_moe_235b, n_layers=8)
    launches = {}
    for cfg, pdt, cut in ((mamba2_2p7b, None, ""), (zamba2_2p7b, None, ""),
                          (mamba_130m, None, ""), (gemma3_1b, None, ""),
                          (falcon_h1_05b, None, ""),
                          (qwen3_8, torch.bfloat16,
                           f" of {qwen3_moe_235b.n_layers}, bf16 params"),
                          # the paper's fig1, fig7 and fig8 models
                          (QWEN25_05B, None, ""), (MAMBA2_780M, None, ""),
                          (MAMBA2_130M, None, ""), (ZAMBA2_12B, None, "")):
        t0 = time.perf_counter()
        serving, launches[cfg.name], reuse = phase_serving(cfg, gen, pdt)
        torch.cuda.empty_cache()
        print(f"phase 4 serving {cfg.name} ({cfg.n_layers} layers{cut}, "
              f"slots 4, prompts 300/700/1000/2048, 32 new; "
              f"{time.perf_counter() - t0:.1f} s): " + json.dumps(serving)
              + " launches " + json.dumps(launches[cfg.name]), flush=True)
        # phase 8 on the same engine and params, before they are freed
        t0 = time.perf_counter()
        prof = phase_profile(cfg, gen, launches=launches[cfg.name], **reuse)
        torch.cuda.empty_cache()
        print(f"phase 8 operator classes, {cfg.name} ({cfg.n_layers} "
              f"layers; {time.perf_counter() - t0:.1f} s):", flush=True)
        for window, res in prof.items():
            print(f"phase 8 {cfg.name} {window}: " + json.dumps(res),
                  flush=True)
        if cfg.moe is not None:
            t0 = time.perf_counter()
            moe_dec = phase_moe_decode(cfg, gen, reuse["eng"], reuse["pos"])
            moe_dec["graph_ms_per_token_step"] = (
                serving["steady_b4_burst8_graph_ms"] / 8)
            print(f"phase 4 MoE decode, {cfg.name} ({cfg.n_layers} "
                  f"layers{cut}), B=4, gshard against ragged "
                  f"({time.perf_counter() - t0:.1f} s): "
                  + json.dumps(moe_dec), flush=True)
        if cfg is ZAMBA2_12B:
            t0 = time.perf_counter()
            sampled = phase_sampling(cfg, reuse["eng"])
            print(f"phase 4 sampled burst, {cfg.name}, B=4, "
                  f"{sampled['tokens']} tokens, T={sampled['temperature']}, "
                  f"against the greedy eager burst "
                  f"({time.perf_counter() - t0:.1f} s): "
                  + json.dumps(sampled), flush=True)
        del reuse
        torch.cuda.empty_cache()
    for r in paper_rows:
        r["launches"] = launches.get(r["at"], {}).get(r["name"])
        print(f"phase 3 kernel at the paper's {r['at']}, launches from its "
              f"phase 4 run (null: phase 5 only): " + json.dumps(r),
              flush=True)
    t0 = time.perf_counter()
    launched = phase_launcher(ZAMBA2_12B.name)
    print(f"phase 4 launch.serve --arch {ZAMBA2_12B.name} (reduced), 8 "
          f"requests of 32 tokens, 16 new, at the default device "
          f"({time.perf_counter() - t0:.1f} s): " + json.dumps(launched),
          flush=True)

    for cfg, n, cd, plen, *pdt in ((mamba2_2p7b, 8, "bfloat16", 512),
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
                             (glm4_9b, 4, "float32", 512),
                             # the paper's models: the Mamba-2 ones and
                             # zamba2-1.2b at full depth, the dense ones
                             # at full width
                             (MAMBA2_130M, MAMBA2_130M.n_layers, "bfloat16",
                              512),
                             (MAMBA2_130M, MAMBA2_130M.n_layers, "float32",
                              512),
                             (MAMBA2_780M, MAMBA2_780M.n_layers, "bfloat16",
                              512),
                             (MAMBA2_780M, MAMBA2_780M.n_layers, "float32",
                              512),
                             (ZAMBA2_12B, ZAMBA2_12B.n_layers, "bfloat16",
                              512),
                             (ZAMBA2_12B, ZAMBA2_12B.n_layers, "float32",
                              512),
                             (QWEN25_15B, 4, "bfloat16", 512),
                             (QWEN25_15B, 4, "float32", 512),
                             (LLAMA32_1B, 4, "bfloat16", 512),
                             (LLAMA32_1B, 4, "float32", 512),
                             # params in the compute dtype: 4 layers of
                             # 2.49 B parameters, 19.9 GB in bf16, 39.8 GB
                             # in fp32
                             (qwen3_moe_235b, 4, "bfloat16", 512,
                              "bfloat16"),
                             (qwen3_moe_235b, 4, "float32", 512, "float32"),
                             # one unit (dense_moe + moe) in bf16, 37.1 GB;
                             # its fp32 copy (74 GB) does not fit
                             (llama4_maverick, 2, "bfloat16", 512,
                              "bfloat16")):
        t0 = time.perf_counter()
        paths = phase_paths(cfg, gen, n, cd, plen, *pdt)
        torch.cuda.empty_cache()
        note = (f", {pdt[0]} params" if pdt else "") + (
            " (bf16 only: the fp32 copy does not fit)"
            if cfg is llama4_maverick else "")
        print(f"phase 5 kernel path vs plain path, {cfg.name} at {n} "
              f"layers, {cd}, {plen}-token prompt{note} "
              f"({time.perf_counter() - t0:.1f} s): " + json.dumps(paths),
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

    t0 = time.perf_counter()
    enc = phase_encoder(hubert_xlarge, gen)
    torch.cuda.empty_cache()
    print(f"phase 9 encoder, {hubert_xlarge.name} ({hubert_xlarge.n_layers} "
          f"layers), make_encode_step on 4 x 1500 frames of 512-d features, "
          f"kernel path vs plain path ({time.perf_counter() - t0:.1f} s): "
          + json.dumps(enc), flush=True)
    t0 = time.perf_counter()
    vis = phase_vision(llava_next, gen)
    torch.cuda.empty_cache()
    print(f"phase 9 vision frontend, {llava_next.name} ({llava_next.n_layers} "
          f"layers, bf16 params), 576 patch features + 512-token prompt, "
          f"32 new through greedy_generate ({time.perf_counter() - t0:.1f} "
          f"s): " + json.dumps(vis), flush=True)

    # earlier phases' engines hold device tensors in reference cycles
    # (closures over themselves); collect them before the full-size
    # training needs the card
    before = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 10 device memory allocated at the start: {before} B, "
          f"{torch.cuda.memory_allocated()} B after collecting garbage",
          flush=True)
    t0 = time.perf_counter()
    bwd_rows, bwd_checks = phase_backward_kernels(gen)
    torch.cuda.empty_cache()
    print(f"phase 10 backward kernels against their plain backwards at "
          f"zamba2-2.7b's SSD, conv1d and flash, smollm-135m's flash, "
          f"mamba-130m's scan and conv1d, gemma3-1b's flash (window 512 "
          f"and causal, d=256) and hubert-xlarge's (non-causal) at "
          f"BWD_CHECKS' shapes, bf16 and fp32, each twice bit for bit "
          f"({time.perf_counter() - t0:.1f} s): " + json.dumps(bwd_checks),
          flush=True)
    for name, r in bwd_rows.items():
        lib = ("" if r["over_library"] is None
               else f", {r['over_library']:.3f}x the library call")
        print(f"phase 10 kernel {name} ({r['shape']}, bf16), route "
              f"{r['kernel_route']}, {100 * r['of_bound']:.2f}% of its "
              f"bound{lib}: " + json.dumps(r), flush=True)
    for cfg, n, cd, b, s in ((zamba2_2p7b, 6, "float32", 2, 512),
                             (zamba2_2p7b, 6, "bfloat16", 2, 512),
                             (smollm_135m, 4, "float32", 2, 512),
                             (smollm_135m, 4, "bfloat16", 2, 512),
                             # all 9 shared-block positions
                             (zamba2_2p7b, zamba2_2p7b.n_layers, "bfloat16",
                              1, 512),
                             # one unit: 5 local layers and a global one,
                             # S past the 512-key window
                             (gemma3_1b, 6, "bfloat16", 2, 1024),
                             # S off the tiles
                             (hubert_xlarge, 2, "bfloat16", 2, 500),
                             (mamba_130m, 4, "bfloat16", 2, 512),
                             # one layer at full width: 3.73 B parameters
                             # (its AdamW step runs in (d))
                             (qwen3_moe_235b, 1, "float32", 2, 512),
                             # 576 patch features, then 576 tokens
                             (llava_next, 2, "bfloat16", 2, 1152)):
        t0 = time.perf_counter()
        res = phase_train_paths(cfg, gen, n, cd, b, s,
                                step=cfg is not qwen3_moe_235b)
        torch.cuda.empty_cache()
        print(f"phase 10 train step, kernel path vs plain path, {cfg.name} "
              f"at {n} layers, {cd}, B={b}, S={s} "
              f"({time.perf_counter() - t0:.1f} s): " + json.dumps(res),
              flush=True)
    train = {}
    # qwen3-moe-235b-a22b at 1 of its 94 layers: 3.73 B parameters, fp32
    # masters and moments 44.8 GB; B x S cut to 2 x 1024 so that its
    # gshard buffers and 151936-word logits fit beside them
    qwen3_1 = dataclasses.replace(qwen3_moe_235b, n_layers=1)
    for cfg, b, s, restart in ((zamba2_2p7b, 4, 2048, 4),
                               (smollm_135m, 8, 2048, None),
                               (gemma3_1b, 4, 2048, None),
                               (hubert_xlarge, 4, 1500, None),
                               (mamba_130m, 8, 2048, None),
                               (qwen3_1, 2, 1024, None)):
        t0 = time.perf_counter()
        train[cfg.name] = phase_train_full(cfg, gen, b, s, 8, restart)
        torch.cuda.empty_cache()
        again = (f", restored at step {restart} and replayed"
                 if restart else "")
        cut = (f" of {qwen3_moe_235b.n_layers}"
               if cfg.n_layers < qwen3_moe_235b.n_layers and cfg.moe else "")
        print(f"phase 10 training {cfg.name} ({cfg.n_layers}{cut} layers, "
              f"full width), fp32 masters, bf16 compute, OptConfig(), "
              f"B={b} x S={s}, 8 steps{again} "
              f"({time.perf_counter() - t0:.1f} s): "
              + json.dumps(train[cfg.name]), flush=True)

    for r in rows:
        r["launches"] = launches[r["at"]][r["name"]]
        # the exponentials are operations on the special-function units
        if r["bound_by"] == "exponentials":
            r["bound_by"] = "operations"
    for name in ("flash_bwd", "ssd_bwd", "conv1d_bwd"):
        rows.append(dict(bwd_rows[name], launches=train[
            zamba2_2p7b.name]["launches"][name]))
    # the new backward rows, each with its own model's 8 training steps
    for name, cfg, key in (
            ("scan1_bwd", mamba_130m, "scan1_bwd"),
            ("flash_bwd_window", gemma3_1b, "flash_bwd.window"),
            ("flash_bwd_d256", gemma3_1b, "flash_bwd.causal"),
            ("flash_bwd_noncausal", hubert_xlarge, "flash_bwd.noncausal")):
        rows.append(dict(bwd_rows[name],
                         launches=train[cfg.name]["launches"][key]))
    print(f"chip_smoke: every phase in {time.perf_counter() - t_start:.1f} "
          f"s", flush=True)
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
