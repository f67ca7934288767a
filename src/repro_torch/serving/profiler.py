"""Measured operator-level profiling: device time by kernel family.

The port of the reference's ``serving/profiler.py``, on ``torch.profiler``
in place of ``jax.profiler``.  The paper's headline numbers are measured
(selective-scan kernels take more than 55% of edge-inference latency);
:func:`repro_torch.serving.telemetry.operator_costs` gives the static
FLOP/byte walk, and this module its measured counterpart.  The mode is an
argument (default ``"off"``); the port reads no environment variable.

* **trace**: :meth:`Profiler.window` wraps a group of dispatches in
  ``torch.profiler.profile(activities=[CPU, CUDA])``, exports its Chrome
  trace and attributes every device operation (kernel, memcpy, memset)
  of the calls made inside the window to a family (:func:`parse_trace`).
  While the window records, every operator scope
  (:mod:`repro_torch.core.scope`) also opens a ``record_function``.

  - *Eager dispatches*: each device operation carries the ``correlation``
    id of the host call that launched it (``cuda_runtime`` or
    ``cuda_driver``: cuBLAS launches through the driver, the hand-written
    kernels through the runtime from their ``ctypes`` library).  The
    scopes and the innermost aten op open around that call on its host
    thread give the family (:func:`repro_torch.core.classify.classify`):
    a hand-written kernel has no aten op around it and takes its scope's
    family (SSD, conv1d, the decode steps and the scan ``ssm``; flash and
    decode attention in ``attn_core`` ``other``); a memcpy with no aten
    op (a cache store) is ``memory``.  The same kernel name can belong to
    two families (an elementwise add in a norm and in a residual), so
    nothing is classed by kernel name.
  - *CUDA graph replays* (the decode burst, ``serving/graphs.py``) give
    every kernel the one correlation id of ``cudaGraphLaunch``, and no
    host op encloses them.  The graph runner calls :meth:`Profiler.learn`
    around the eager first call at each new key, which it runs before
    capturing: a trace of that call alone gives the key's sequence of
    device operations and the family of each (the counterpart of the
    reference's ``family_map`` of a compiled program).  A replay, run
    inside :meth:`Profiler.replay`, is attributed position by position
    against that sequence after checking that the names match in order
    (a memcpy node of a graph runs as a kernel named ``memcpy*``, an eager
    one as a memcpy: both are ``memcpy``).  The tracer can drop a few
    records of a long call, so the match (:func:`align`) skips past an
    operation one side lacks; a replayed operation left without a
    position is unattributed.  Where more than 1% of the operations
    find no position, or for a graph never learned, the replay's time
    is apportioned by the window key's static weights and the window is
    ``degraded``, as in the reference.
  - *Unattributed*: a device operation of a call made inside the window
    that can be tied neither to a launch nor to a graph position.
    Device operations of calls made before the window are not read.
  - A window must not hold a graph's first call (its learning trace and
    its capture): :meth:`Profiler.learn` refuses one while a window
    records.

* **coarse**: the engine's existing wall timings (:meth:`observe`, one
  dict add a dispatch; the bookkeeping's own time is
  :attr:`Profiler.overhead_ms`, which the card check holds under 3% of
  the decode wall) are apportioned across families at snapshot time by
  each program's static weights (:func:`static_family_weights` over the
  walk of :mod:`repro_torch.core.op_analysis`).  Shares still sum to 1;
  they are model-weighted rather than measured.
* **off** (default): every hook is a no-op.

Snapshots carry ``version`` and ``mode``, the reference's schema.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import scope as _scope
from repro_torch.core.classify import classify
from repro_torch.core.op_analysis import CostSummary

#: schema version stamped on profiler snapshots / measured-share records
PROFILE_SCHEMA_VERSION = 1

PROFILE_MODES = ("off", "coarse", "trace")

#: nominal roofline peaks for coarse-mode static weights; only the
#: *ratios* between families matter, never the absolute throughput
_PEAK_FLOPS = 1.0e12
_PEAK_BYTES = 1.0e11

# the profiler's own annotations in a trace (never scopes)
WINDOW = "repro:window"
REPLAY = "repro:replay:"
_OWN = "repro:"
# how far :func:`align` looks past an operation one side lacks, and the
# share of operations it may leave without a position before a replay is
# degraded
_LOOKAHEAD = 64
_MAX_UNMATCHED = 0.01

# small launches, each waited for, that open every trace: the tracer
# loses the device records of a trace's first launches on the card
# (dozens, and past a hundred, late in a long process), which would
# leave a window's first graph replay unmatched
TRACER_PRIMER = 256

_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")
_NULL = contextlib.nullcontext()


def static_family_weights(cost: CostSummary) -> Dict[str, float]:
    """Normalized per-family share of modeled runtime (``max(flops/peak,
    bytes/peak)`` per kernel) -- the apportioning vector coarse mode
    uses."""
    t: Dict[str, float] = {}
    for k in cost.kernels:
        c = max(k.flops / _PEAK_FLOPS, k.bytes / _PEAK_BYTES) * k.count
        t[k.clazz] = t.get(k.clazz, 0.0) + c
    total = sum(t.values())
    if total <= 0:
        return {}
    return {fam: v / total for fam, v in sorted(t.items())}


@dataclass
class FamilyTimes:
    """Attributed device time for one profiling window (ms per family)."""

    key: str = ""
    ms: Dict[str, float] = field(default_factory=dict)
    unattributed_ms: float = 0.0
    wall_ms: float = 0.0
    events: int = 0
    mode: str = "off"
    degraded: bool = False      # a graph replay fell back to static weights

    def add(self, family: str, ms: float) -> None:
        self.ms[family] = self.ms.get(family, 0.0) + ms

    def merge(self, other: "FamilyTimes") -> None:
        for fam, v in other.ms.items():
            self.add(fam, v)
        self.unattributed_ms += other.unattributed_ms
        self.wall_ms += other.wall_ms
        self.events += other.events
        self.mode = other.mode
        self.degraded = self.degraded or other.degraded

    def shares(self) -> Dict[str, float]:
        """Per-family share of *attributed* device time (sums to 1 when
        any time was attributed)."""
        total = sum(self.ms.values())
        if total <= 0:
            return {}
        return {fam: v / total for fam, v in sorted(self.ms.items())}

    def as_dict(self) -> Dict[str, Any]:
        return {"key": self.key, "mode": self.mode,
                "degraded": self.degraded, "events": self.events,
                "wall_ms": self.wall_ms,
                "unattributed_ms": self.unattributed_ms,
                "ms": dict(sorted(self.ms.items())),
                "shares": self.shares()}


def op_name(event: Dict[str, Any]) -> str:
    """A device operation's name for matching graph positions: ``memcpy``
    or ``memset`` for copies and fills (a graph's memcpy node runs as a
    kernel named ``memcpy*``), else the kernel's name."""
    name = str(event.get("name", ""))
    cat = event.get("cat")
    if cat == "gpu_memcpy" or name.startswith("memcpy"):
        return "memcpy"
    if cat == "gpu_memset" or name.startswith("memset"):
        return "memset"
    return name


def _corr(event: Dict[str, Any]):
    return (event.get("args") or {}).get("correlation")


def _host_context(events: List[Dict[str, Any]], calls: List[Dict[str, Any]]
                  ) -> Dict[int, Tuple[Tuple[str, ...], str, str]]:
    """For each launch call (by index in ``calls``): (the scopes open
    around it, outermost first; the innermost aten op's name or "";
    the innermost profiler annotation of its own, or "") on its thread."""
    by_tid: Dict[Any, List[Tuple[float, float, Dict[str, Any]]]] = {}
    for e in events:
        if (e.get("ph") == "X" and "dur" in e
                and e.get("cat") in ("cpu_op", "user_annotation")):
            t0 = float(e["ts"])
            by_tid.setdefault((e.get("pid"), e.get("tid")), []).append(
                (t0, t0 + float(e["dur"]), e))
    points: Dict[Any, List[Tuple[float, int]]] = {}
    for i, c in enumerate(calls):
        points.setdefault((c.get("pid"), c.get("tid")), []).append(
            (float(c["ts"]), i))
    out: Dict[int, Tuple[Tuple[str, ...], str, str]] = {}
    for tid, pts in points.items():
        ivs = sorted(by_tid.get(tid, []), key=lambda v: (v[0], -v[1]))
        pts.sort()
        stack: List[Tuple[float, float, Dict[str, Any]]] = []
        j = 0
        for t, i in pts:
            while j < len(ivs) and ivs[j][0] <= t:
                while stack and stack[-1][1] < ivs[j][0]:
                    stack.pop()
                stack.append(ivs[j])
                j += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            scopes, op, own = [], "", ""
            for _, end, e in stack:
                if end < t:
                    continue
                name = str(e.get("name", ""))
                if e.get("cat") == "cpu_op":
                    op = name.split("::")[-1]
                elif name.startswith(_OWN):
                    own = name
                else:
                    scopes.append(name)
            out[i] = (tuple(scopes), op, own)
    return out


def align(seq: List[Tuple[str, str]], names: List[str]
          ) -> Tuple[List[Optional[str]], int]:
    """The family of each of a replay's operations (``names``, in device
    order) from its position in the learned sequence ``seq`` of (name,
    family): walking both in order, an operation one side lacks (a record
    the tracer dropped) is skipped, looking up to ``_LOOKAHEAD`` ahead on
    either side, and a name met on neither side is one substituted.
    Returns (the families, None where a replayed operation has no
    position; the operations of both sides left unmatched)."""
    fams: List[Optional[str]] = [None] * len(names)
    i = j = unmatched = 0
    while i < len(seq) and j < len(names):
        if seq[i][0] == names[j]:
            fams[j] = seq[i][1]
            i += 1
            j += 1
            continue
        k = next((k for k in range(i + 1, min(len(seq), i + _LOOKAHEAD))
                  if seq[k][0] == names[j]), None)
        m = next((m for m in range(j + 1, min(len(names), j + _LOOKAHEAD))
                  if names[m] == seq[i][0]), None)
        if k is not None and (m is None or k - i <= m - j):
            unmatched += k - i
            i = k
        elif m is not None:
            unmatched += m - j
            j = m
        else:
            unmatched += 1
            i += 1
            j += 1
    return fams, unmatched + (len(seq) - i) + (len(names) - j)


def parse_trace(events: List[Dict[str, Any]],
                graphs: Optional[Dict[str, List[Tuple[str, str]]]] = None,
                weights: Optional[Dict[str, float]] = None
                ) -> Tuple[FamilyTimes, List[Tuple[str, str]]]:
    """Attribute the device operations of a ``torch.profiler`` Chrome
    trace (its ``traceEvents``) to kernel families (module docstring).
    Only calls made inside the profiler's window annotation (the whole
    trace when it has none) are read.  ``graphs`` maps a learned graph's
    id to its sequence of (name, family); ``weights`` apportion a replay
    that cannot be matched.  Returns (the attribution, the window's eager
    device operations as (name, family) in device order: a graph's
    learned sequence when the window is its eager first call)."""
    graphs = graphs or {}
    res = FamilyTimes()
    window = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == WINDOW and "dur" in e]
    lo, hi = ((float(window[0]["ts"]),
               float(window[0]["ts"]) + float(window[0]["dur"]))
              if window else (float("-inf"), float("inf")))
    calls = [e for e in events if e.get("cat") in _LAUNCH_CATS
             and _corr(e) is not None and "ts" in e
             and lo <= float(e["ts"]) <= hi]
    device: Dict[Any, List[Dict[str, Any]]] = {}
    for e in events:
        if e.get("cat") in _DEVICE_CATS and "dur" in e \
                and _corr(e) is not None:
            device.setdefault(_corr(e), []).append(e)
    for ops in device.values():
        ops.sort(key=lambda e: float(e["ts"]))
    context = _host_context(events, calls)
    eager: List[Tuple[float, str, str]] = []
    replays: List[Tuple[Optional[str], List[Dict[str, Any]]]] = []
    for i, call in enumerate(calls):
        ops = device.get(_corr(call))
        if not ops:
            continue
        scopes, op, own = context.get(i, ((), "", ""))
        if call.get("name") in _GRAPH_LAUNCHES:
            gid = own[len(REPLAY):] if own.startswith(REPLAY) else None
            replays.append((gid, ops))
            continue
        for e in ops:
            name = op_name(e)
            fam = classify(scopes, op or ("copy_" if name in ("memcpy",
                                                              "memset")
                                          else ""))
            res.add(fam, float(e["dur"]) / 1e3)
            res.events += 1
            eager.append((float(e["ts"]), name, fam))
    for gid, ops in replays:
        ms = sum(float(e["dur"]) for e in ops) / 1e3
        if gid is None:
            res.unattributed_ms += ms
            continue
        seq = graphs.get(gid)
        if seq is not None:
            fams, unmatched = align(seq, [op_name(e) for e in ops])
            if unmatched <= _MAX_UNMATCHED * max(len(seq), len(ops)):
                for e, fam in zip(ops, fams):
                    if fam is None:
                        res.unattributed_ms += float(e["dur"]) / 1e3
                    else:
                        res.add(fam, float(e["dur"]) / 1e3)
                        res.events += 1
                continue
        res.degraded = True
        if weights:
            for fam, w in weights.items():
                res.add(fam, ms * w)
        else:
            res.unattributed_ms += ms
    return res, [(n, f) for _, n, f in sorted(eager)]


def read_trace_file(path: str) -> List[Dict[str, Any]]:
    """A Chrome trace's ``traceEvents``; none when the file is missing or
    not a trace."""
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    except (OSError, ValueError, AttributeError):
        return []
    return events if isinstance(events, list) else []


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Profiler:
    """Per-dispatch device-time attribution hub for one engine or bench.

    ``mode`` is one of :data:`PROFILE_MODES` (default ``"off"``).
    ``register(key, cost)`` teaches the profiler one program's static
    weights (``cost``: the program's
    :class:`~repro_torch.core.op_analysis.CostSummary`); :meth:`window`
    wraps a group of dispatches and attributes their device time;
    :meth:`observe` is the always-cheap per-dispatch hook the engine calls
    with its existing wall timings; :meth:`learn` and :meth:`replay` are
    the graph runner's (module docstring).  ``trace_dir`` keeps each trace
    window's Chrome trace there (``<key>_<n>.json``; default: a temporary
    directory, removed)."""

    def __init__(self, mode: str = "off",
                 clock: Optional[Callable[[], float]] = None,
                 trace_dir: Optional[str] = None):
        if mode not in PROFILE_MODES:
            raise ValueError(f"profile mode {mode!r}: expected one of "
                             f"{PROFILE_MODES}")
        self.mode = mode
        # time.monotonic, like every serving module (the injectable clock)
        self._clock = clock or time.monotonic
        self.trace_dir = trace_dir
        self._weights: Dict[str, Dict[str, float]] = {}
        self._graphs: Dict[str, List[Tuple[str, str]]] = {}
        self._graph_ids = itertools.count()
        self._totals: Dict[str, FamilyTimes] = {}
        self._coarse_wall: Dict[str, float] = {}
        self._coarse_n: Dict[str, int] = {}
        self._traces = itertools.count()
        #: measured profiler bookkeeping self-time (ms): the overhead the
        #: card check bounds at < 3% of decode wall
        self.overhead_ms = 0.0
        self._tracing = False
        #: the path of the last trace written under ``trace_dir``
        self.last_trace: Optional[str] = None

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    def register(self, key: str, cost: CostSummary) -> None:
        """Register one program's static weights under ``key``
        (idempotent per key)."""
        if key not in self._weights:
            self._weights[key] = static_family_weights(cost)

    def registered(self, key: str) -> bool:
        return key in self._weights

    # ------------------------------------------------------------ traces
    @contextlib.contextmanager
    def _trace(self, name: str):
        """Record one ``torch.profiler`` trace of the body (scopes open
        ``record_function`` inside) under the window annotation; yields a
        list that receives the trace's events on exit."""
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        out: List[Dict[str, Any]] = []
        tmp = None
        if self.trace_dir is None:
            tmp = tempfile.mkdtemp(prefix="repro_profile_")
        d = self.trace_dir or tmp
        _sync()
        self._tracing = True
        try:
            with profile(activities=acts) as prof:
                if torch.cuda.is_available():
                    # the primer comes before the window (it is not read)
                    primer = torch.zeros(1, device="cuda")
                    for _ in range(TRACER_PRIMER):
                        primer.add_(1.0)
                        _sync()
                with _scope.recording(trace=True), record_function(WINDOW):
                    yield out
                _sync()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"{name}_{next(self._traces)}.json")
            prof.export_chrome_trace(path)
            out.extend(read_trace_file(path))
            if tmp is None:
                self.last_trace = path
        finally:
            self._tracing = False
            if tmp is not None:
                shutil.rmtree(tmp, ignore_errors=True)

    # ------------------------------------------------------------ windows
    @contextlib.contextmanager
    def window(self, key: str):
        """Profile every dispatch inside the ``with`` body and attribute
        its device time; yields a :class:`FamilyTimes` filled on exit.
        Off mode yields an empty record; coarse mode wall-times the
        window and apportions by the key's static weights; trace mode
        records and parses a ``torch.profiler`` trace (degrading to the
        coarse apportioning, flagged, when the trace holds no device
        operation)."""
        res = FamilyTimes(key=key, mode=self.mode)
        if self.mode == "off" or self._tracing:
            yield res
            return
        if self.mode == "coarse":
            t0 = self._clock()
            try:
                yield res
            finally:
                t1 = self._clock()
                res.wall_ms = (t1 - t0) * 1e3
                self._apportion(key, res.wall_ms, res)
                self._merge_total(key, res)
                self.overhead_ms += (self._clock() - t1) * 1e3
            return
        tb0 = self._clock()
        with self._trace(key) as events:
            t0 = self._clock()
            self.overhead_ms += (t0 - tb0) * 1e3
            try:
                yield res
            finally:
                t1 = self._clock()
        parsed, _ = parse_trace(events, self._graphs,
                                self._weights.get(key))
        if parsed.events == 0 and not parsed.degraded:
            # no device trace on this host: degrade to the coarse static
            # apportioning so shares still exist
            res.degraded = True
            self._apportion(key, (t1 - t0) * 1e3, res)
        else:
            res.ms = parsed.ms
            res.unattributed_ms = parsed.unattributed_ms
            res.events = parsed.events
            res.degraded = parsed.degraded
        res.wall_ms = (t1 - t0) * 1e3
        self._merge_total(key, res)
        self.overhead_ms += (self._clock() - t1) * 1e3

    def _apportion(self, key: str, wall_ms: float, res: FamilyTimes) -> None:
        weights = self._weights.get(key)
        if not weights:
            res.unattributed_ms += wall_ms
            return
        for fam, w in weights.items():
            res.add(fam, wall_ms * w)

    def _merge_total(self, key: str, res: FamilyTimes) -> None:
        tot = self._totals.get(key)
        if tot is None:
            self._totals[key] = tot = FamilyTimes(key=key, mode=self.mode)
        tot.merge(res)

    # ------------------------------------------------------------- graphs
    @contextlib.contextmanager
    def learn(self):
        """Around a graph's eager first call: in trace mode, a trace of
        its own records the call and learns its sequence of device
        operations and their families; yields the graph's id (None when
        not in trace mode).  Not inside a window."""
        if self.mode != "trace":
            yield None
            return
        if self._tracing:
            raise RuntimeError("a graph's first call (its learning trace "
                               "and its capture) cannot run inside a "
                               "trace window")
        gid = f"g{next(self._graph_ids)}"
        t0 = self._clock()
        with self._trace("learn") as events:
            t1 = self._clock()
            yield gid
            t2 = self._clock()
        self._graphs[gid] = parse_trace(events)[1]
        self.overhead_ms += ((t1 - t0) + (self._clock() - t2)) * 1e3

    def replay(self, gid: Optional[str]):
        """Around a graph's replay: inside a trace window, tags the launch
        with the graph's id."""
        if not self._tracing or gid is None:
            return _NULL
        from torch.profiler import record_function
        return record_function(REPLAY + gid)

    # ---------------------------------------------------------- coarse hook
    def observe(self, key: str, wall_ms: float) -> None:
        """Always-cheap per-dispatch hook: accumulate one wall-time sample
        under ``key`` (one dict add; apportioned by static weights at
        snapshot time).  No-op when off."""
        if self.mode == "off":
            return
        t0 = self._clock()
        self._coarse_wall[key] = self._coarse_wall.get(key, 0.0) + wall_ms
        self._coarse_n[key] = self._coarse_n.get(key, 0) + 1
        self.overhead_ms += (self._clock() - t0) * 1e3

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Dict[str, Any]:
        """JSON-able state: per-key windowed attributions plus the coarse
        per-dispatch accumulations apportioned by static weights."""
        coarse: Dict[str, Any] = {}
        for key, wall in sorted(self._coarse_wall.items()):
            res = FamilyTimes(key=key, mode="coarse")
            self._apportion(key, wall, res)
            res.wall_ms = wall
            coarse[key] = res.as_dict()
            coarse[key]["dispatches"] = self._coarse_n.get(key, 0)
        return {"version": PROFILE_SCHEMA_VERSION, "mode": self.mode,
                "overhead_ms": self.overhead_ms,
                "windows": {k: t.as_dict()
                            for k, t in sorted(self._totals.items())},
                "coarse": coarse}
