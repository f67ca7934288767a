"""The measured profiler (``serving/profiler.py``) beside the reference's,
on the CPU.

The reference's ``tests/test_profiler.py`` cases that need no HLO, ported:
the trace parser on a synthetic ``torch.profiler`` Chrome trace (kernels
tied to their launches by ``correlation``, scopes and aten ops around the
launch, the runtime and driver launch paths, memcpys as ``memory``, host
events and calls outside the window ignored, the window's eager sequence
a graph learns, graph replays attributed by position against a learned
sequence, a record the tracer dropped on either side skipped and its
time unattributed, a mismatch or an unlearned graph degraded, an empty
or garbled file giving no events), off mode as a
no-op, an invalid mode rejected, coarse apportioning with a fake clock,
``observe`` and ``overhead_ms``, ``FamilyTimes`` merge; ``FamilyTimes``'s
``as_dict`` and ``shares`` equal the reference's on the same inputs; the
snapshot has the reference's keys, version and modes.  A trace window on
this host (no card) degrades to the static weights, as the reference's
does without a device trace.  The engine on a reduced mamba2 with a
coarse profiler: statuses, streams and ``stats`` equal the reference
engine's, and ``profile_snapshot()``'s dispatch counts equal the reference
engine's on the same requests (fp32 caches on both sides).
"""
import json

import pytest
import torch

from repro.serving import profiler as jprof
from repro_torch.core.op_analysis import CostSummary, KernelCost, analyze
from repro_torch.serving import profiler as tprof
from repro_torch.serving.profiler import (PROFILE_MODES,
                                          PROFILE_SCHEMA_VERSION, REPLAY,
                                          WINDOW, FamilyTimes, Profiler,
                                          align, parse_trace,
                                          read_trace_file,
                                          static_family_weights)
from tests.test_torch_faults import (engines, fp32_caches,  # noqa: F401
                                     matrix_reqs, outcome, submit_both)

HOST = {"pid": 7, "tid": 7}
DEV = {"pid": 0, "tid": 3}


def _x(cat, name, ts, dur, corr=None, **where):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         **(where or HOST)}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _kernel(name, ts, dur, corr, cat="kernel"):
    return _x(cat, name, ts, dur, corr, **DEV)


def _trace():
    """Host calls inside a window: a product (driver launch inside
    ``aten::mm``), an add in a norm scope, a hand-written kernel in
    ``conv1d`` and one in ``attn_core`` (runtime launches, no aten op), a
    cache store memcpy, a mul in a norm scope and a ``copy_``, a replay
    of graph g0 (its memcpy node as a kernel), one of a graph never
    learned and one with no tag; a fill before the window; a host
    thread's Python event."""
    ev = [
        _x("cuda_runtime", "cudaLaunchKernel", 10, 2, corr=1),
        _kernel("fill_kernel", 20, 5, 1),
        _x("user_annotation", WINDOW, 100, 5000),
        _x("cpu_op", "aten::mm", 110, 40),
        _x("cuda_driver", "cuLaunchKernelEx", 120, 5, corr=2),
        _kernel("nvjet_gemm", 130, 1000, 2),
        _x("user_annotation", "norm", 200, 100),
        _x("cpu_op", "aten::add", 210, 30),
        _x("cuda_runtime", "cudaLaunchKernel", 220, 5, corr=3),
        _kernel("elementwise_add", 240, 250, 3),
        _x("user_annotation", "conv1d", 400, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 410, 5, corr=4),
        _kernel("conv1d_kernel", 420, 500, 4),
        _x("user_annotation", "attn_core", 500, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 510, 5, corr=5),
        _kernel("flash_wgmma_kernel", 520, 400, 5),
        _x("cuda_runtime", "cudaMemcpyAsync", 600, 5, corr=6),
        _kernel("Memcpy DtoD (Device -> Device)", 610, 100, 6,
                cat="gpu_memcpy"),
        _x("user_annotation", "norm", 710, 100),
        _x("cpu_op", "aten::mul", 715, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 720, 5, corr=7),
        _kernel("elementwise_mul", 730, 20, 7),
        _x("cpu_op", "aten::copy_", 850, 50),
        _x("cuda_runtime", "cudaMemcpyAsync", 860, 5, corr=8),
        _kernel("Memcpy DtoD (Device -> Device)", 870, 10, 8,
                cat="gpu_memcpy"),
        # its replay: one correlation id, the memcpy node as a kernel
        _x("user_annotation", REPLAY + "g0", 1100, 50),
        _x("cuda_runtime", "cudaGraphLaunch", 1110, 5, corr=9),
        _kernel("elementwise_mul", 1120, 40, 9),
        _kernel("memcpy32_post", 1170, 30, 9),
        # a replay of a graph never learned, and one with no tag
        _x("user_annotation", REPLAY + "g9", 1300, 50),
        _x("cuda_runtime", "cudaGraphLaunch", 1310, 5, corr=10),
        _kernel("elementwise_mul", 1320, 60, 10),
        _x("cuda_runtime", "cudaGraphLaunch", 1400, 5, corr=11),
        _kernel("elementwise_mul", 1410, 70, 11),
        # host-side events of another thread and a non-duration record
        _x("python_function", "PyCall", 0, 99999, pid=7, tid=8),
        {"ph": "M", "name": "process_name", **DEV},
    ]
    return ev


G0 = [("elementwise_mul", "norm"), ("memcpy", "memory")]


def test_parse_trace_attributes_launches_scopes_and_replays():
    res, eager = parse_trace(_trace(), graphs={"g0": G0},
                             weights={"gemm": 0.75, "arith": 0.25})
    ms = res.ms
    assert ms["gemm"] == pytest.approx(1.0 + 0.06 * 0.75)
    # eager call's mul in the norm scope, then its replay's by position
    assert ms["norm"] == pytest.approx(0.25 + 0.02 + 0.04)
    assert ms["ssm"] == pytest.approx(0.5)
    assert ms["other"] == pytest.approx(0.4)
    assert ms["memory"] == pytest.approx(0.1 + 0.01 + 0.03)
    assert ms["arith"] == pytest.approx(0.06 * 0.25)
    # the window's eager sequence, what a graph's first call teaches
    assert eager == [("nvjet_gemm", "gemm"), ("elementwise_add", "norm"),
                     ("conv1d_kernel", "ssm"), ("flash_wgmma_kernel", "other"),
                     ("memcpy", "memory")] + G0
    # the unlearned replay is apportioned (degraded); the untagged one is
    # unattributed; the fill before the window and the host thread unread
    assert res.degraded
    assert res.unattributed_ms == pytest.approx(0.07)
    assert res.events == 9
    total = sum(ms.values()) + res.unattributed_ms
    assert total == pytest.approx((1000 + 250 + 500 + 400 + 100 + 20 + 10
                                   + 40 + 30 + 60 + 70) / 1e3)


def test_parse_trace_replay_mismatch_degrades():
    seq = {"g0": [("elementwise_mul", "norm"), ("other_kernel", "memory")]}
    res, _ = parse_trace(_trace(), graphs=seq)
    assert res.degraded
    # no weights: the mismatched and unlearned replays stay unattributed
    assert res.unattributed_ms == pytest.approx((40 + 30 + 60 + 70) / 1e3)


def test_align_skips_records_either_side_dropped():
    seq = [(f"k{i % 7}", f"f{i}") for i in range(400)]
    names = [n for n, _ in seq]
    fams, unmatched = align(seq, names)
    assert unmatched == 0 and fams == [f for _, f in seq]
    # the learned trace lost record 100: the replay's keeps its family
    fams, unmatched = align(seq[:100] + seq[101:], names)
    assert unmatched == 1 and fams[100] is None
    assert fams[:100] + fams[101:] == [f for _, f in seq[:100] + seq[101:]]
    # the replay's trace lost record 200
    fams, unmatched = align(seq, names[:200] + names[201:])
    assert unmatched == 1
    assert fams == [f for _, f in seq[:200] + seq[201:]]
    # a replay of another program
    assert align(seq, [f"x{i}" for i in range(400)])[1] >= 400


def test_read_trace_empty_or_garbled(tmp_path):
    assert read_trace_file(str(tmp_path / "missing.json")) == []
    bad = tmp_path / "bad.json"
    bad.write_bytes(b"not json")
    assert read_trace_file(str(bad)) == []
    res, eager = parse_trace(read_trace_file(str(bad)))
    assert res.events == 0 and res.ms == {} and eager == []
    good = tmp_path / "t.json"
    good.write_text(json.dumps({"traceEvents": _trace()}))
    assert parse_trace(read_trace_file(str(good)),
                       graphs={"g0": G0})[0].events == 9


# ------------------------------------------------------------- modes

def _cost():
    return CostSummary(kernels=[
        KernelCost("mm", "mm", "gemm", "mlp", flops=4e12, bytes=1e9),
        KernelCost("add", "add", "arith", "", flops=1e6, bytes=1e10)])


def test_off_mode_is_a_no_op():
    prof = Profiler()
    assert prof.mode == "off" and not prof.enabled
    with prof.window("k") as ft:
        pass
    assert ft.ms == {} and ft.mode == "off"
    prof.observe("k", 5.0)
    with prof.learn() as gid:
        pass
    assert gid is None
    snap = prof.snapshot()
    assert snap["coarse"] == {} and snap["windows"] == {}
    assert snap["version"] == PROFILE_SCHEMA_VERSION


def test_invalid_mode_rejected():
    with pytest.raises(ValueError, match="expected one of"):
        Profiler(mode="verbose")
    assert PROFILE_MODES == jprof.PROFILE_MODES
    assert PROFILE_SCHEMA_VERSION == jprof.PROFILE_SCHEMA_VERSION


def test_coarse_mode_apportions_by_static_weights():
    clock = iter([0.0, 0.010, 0.010, 0.010])    # 10ms window
    prof = Profiler(mode="coarse", clock=lambda: next(clock))
    prof.register("k", _cost())
    assert prof.registered("k")
    with prof.window("k") as ft:
        pass
    assert ft.wall_ms == pytest.approx(10.0)
    assert ft.mode == "coarse"
    assert sum(ft.shares().values()) == pytest.approx(1.0)
    weights = static_family_weights(_cost())
    assert weights == {"arith": pytest.approx(0.1 / 4.1),
                       "gemm": pytest.approx(4.0 / 4.1)}
    for fam, w in weights.items():
        assert ft.ms[fam] == pytest.approx(10.0 * w)
    clock2 = iter([0.0, 0.004, 0.004, 0.004])
    prof2 = Profiler(mode="coarse", clock=lambda: next(clock2))
    with prof2.window("unknown") as ft2:
        pass
    assert ft2.shares() == {}
    assert ft2.unattributed_ms == pytest.approx(4.0)


def test_observe_accumulates_and_tracks_overhead():
    prof = Profiler(mode="coarse")
    prof.register("decode", _cost())
    for _ in range(10):
        prof.observe("decode", 2.0)
    rec = prof.snapshot()["coarse"]["decode"]
    assert rec["dispatches"] == 10
    assert rec["wall_ms"] == pytest.approx(20.0)
    assert sum(rec["shares"].values()) == pytest.approx(1.0)
    assert 0.0 <= prof.overhead_ms < 0.03 * 20.0


def test_trace_window_on_a_host_without_a_card_degrades():
    """On the CPU the trace holds no device operation: the window degrades
    (flagged) to the static apportioning, so shares exist and sum to 1."""
    prof = Profiler(mode="trace")
    a = torch.ones((64, 64))
    prof.register("k", analyze(torch.mm, a, a))
    with prof.window("k") as ft:
        torch.tanh(a @ a)
    assert ft.degraded and ft.events == 0
    assert ft.shares() == {"gemm": pytest.approx(1.0)}
    snap = prof.snapshot()
    assert snap["windows"]["k"]["mode"] == "trace"


def test_family_times_merge_and_dict_equal_reference():
    def pair(mod):
        a = mod.FamilyTimes(key="k", ms={"gemm": 1.0}, events=2,
                            wall_ms=2.0)
        b = mod.FamilyTimes(key="k", ms={"gemm": 1.0, "arith": 2.0},
                            unattributed_ms=0.5, events=3, wall_ms=3.0,
                            degraded=True, mode="trace")
        a.merge(b)
        return a
    got, want = pair(tprof), pair(jprof)
    assert got.ms == {"gemm": 2.0, "arith": 2.0}
    assert got.events == 5 and got.wall_ms == 5.0
    assert got.unattributed_ms == 0.5 and got.degraded
    assert got.as_dict() == want.as_dict()
    assert got.shares() == want.shares()
    assert FamilyTimes().as_dict() == jprof.FamilyTimes().as_dict()


def test_snapshot_schema_equals_reference():
    got = Profiler(mode="coarse")
    want = jprof.Profiler(mode="coarse")
    for p in (got, want):
        p.observe("decode", 3.0)
    gs, ws = got.snapshot(), want.snapshot()
    assert set(gs) == set(ws)
    assert gs["version"] == ws["version"] and gs["mode"] == ws["mode"]
    assert set(gs["coarse"]["decode"]) == set(ws["coarse"]["decode"])
    assert gs["coarse"]["decode"]["dispatches"] == \
        ws["coarse"]["decode"]["dispatches"]


def test_engine_coarse_snapshot_counts_equal_reference(fp32_caches):
    jeng, teng = engines("mamba2")
    jeng.profiler = jprof.Profiler(mode="coarse")
    teng.profiler = Profiler(mode="coarse")
    submit_both(jeng, teng, matrix_reqs("mamba2", n_req=2))
    jeng.run(max_iters=200)
    teng.run(max_iters=200)
    assert outcome(teng) == outcome(jeng)
    got, want = teng.profile_snapshot(), jeng.profile_snapshot()
    assert {k: v["dispatches"] for k, v in got["coarse"].items()} == \
        {k: v["dispatches"] for k, v in want["coarse"].items()}
    assert got["coarse"]["decode"]["dispatches"] > 0
    for key in ("decode", "prefill"):
        assert sum(got["coarse"][key]["shares"].values()) == \
            pytest.approx(1.0)
    assert "ssm" in got["coarse"]["decode"]["shares"]
