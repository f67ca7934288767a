"""Structured serving telemetry: the per-(arch, phase, KV-bucket) latency
model and per-request span traces.

The port's copy of the reference's ``serving/telemetry.py``, less
``operator_costs`` (static attribution over a compiled XLA program; its
torch counterpart comes with the profiler, ROADMAP.md).  Two layers:

* **Latency table** — :class:`TelemetryTable`, one
  :class:`PhaseBucketStats` per ``(arch, phase, kv_bucket)`` key (arch =
  the config name; phases ``prefill`` / ``decode``; bucket = the KV rung
  the call ran under, ``None`` without a KV cache).  Each entry keeps a
  ``steady`` and a ``compile`` :class:`LatencyRecord`: a first dispatch
  at a key (on the card: an eager burst plus a CUDA graph capture) lands
  in ``compile`` and never moves the estimate that deadline admission
  and victim slack read.  :meth:`Telemetry.estimate` falls back from the
  bucket to the same arch's phase-global steady record, never across
  archs.  The table round-trips through a versioned JSON blob for warm
  starts (a path passed as an argument).
* **Span traces** — per-request event timelines (queued -> prefill
  chunks -> decode bursts -> terminal state, with bucket, preemption,
  checkpoint, replay and fault events); same-kind same-bucket events
  coalesce.  With ``trace_path`` each finished span is appended as one
  JSON line carrying ``version`` and ``arch``; :func:`read_trace`
  rejects lines of another schema.

All timestamps come from the injected ``clock``.
"""
from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

log = logging.getLogger("repro_torch.serving.telemetry")

# phases a latency key may carry (order = pipeline order)
PHASES = ("prefill", "decode")

#: schema version for trace JSONL lines AND latency snapshots; bumped to 2
#: when the table became arch-keyed (v1 lines have no arch and would be
#: misattributed — read_trace rejects them)
TRACE_SCHEMA_VERSION = 2

#: schema version of the warm-start blob (arch-keyed table serialization)
TELEMETRY_BLOB_VERSION = 1

#: arch key used when the caller never names one (single-config benches)
DEFAULT_ARCH = "default"


@dataclass
class LatencyRecord:
    """EWMA + count + min/max over per-token latency samples (ms)."""

    ewma_ms: float = 0.0
    count: int = 0
    min_ms: float = float("inf")
    max_ms: float = 0.0

    def observe(self, ms: float, alpha: float) -> None:
        self.ewma_ms = ms if self.count == 0 \
            else alpha * ms + (1.0 - alpha) * self.ewma_ms
        self.count += 1
        self.min_ms = min(self.min_ms, ms)
        self.max_ms = max(self.max_ms, ms)

    def as_dict(self) -> Dict[str, Any]:
        return {"ewma_ms": self.ewma_ms, "count": self.count,
                "min_ms": None if self.count == 0 else self.min_ms,
                "max_ms": None if self.count == 0 else self.max_ms}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LatencyRecord":
        count = int(d.get("count", 0))
        return cls(ewma_ms=float(d.get("ewma_ms", 0.0)), count=count,
                   min_ms=(float("inf") if d.get("min_ms") is None
                           else float(d["min_ms"])),
                   max_ms=float(d.get("max_ms") or 0.0))


@dataclass
class PhaseBucketStats:
    """Latency for one (arch, phase, kv_bucket) key: steady-state samples
    and first-dispatch (trace+compile) samples, segregated — only
    ``steady`` ever feeds admission/preemption estimates."""

    steady: LatencyRecord = field(default_factory=LatencyRecord)
    compile: LatencyRecord = field(default_factory=LatencyRecord)

    def as_dict(self) -> Dict[str, Any]:
        return {"steady": self.steady.as_dict(),
                "compile": self.compile.as_dict()}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PhaseBucketStats":
        return cls(steady=LatencyRecord.from_dict(d.get("steady", {})),
                   compile=LatencyRecord.from_dict(d.get("compile", {})))


def _bucket_key(bucket: Optional[int]) -> int:
    # None (no KV cache / bucketing off) keys as -1 so the table stays
    # JSON-sortable; the phase-global aggregate lives under GLOBAL_KEY
    return -1 if bucket is None else int(bucket)


GLOBAL_KEY = "*"


def _parse_key(s: str):
    return GLOBAL_KEY if s == GLOBAL_KEY else int(s)


class TelemetryTable:
    """The per-(arch, phase, kv_bucket) latency table, shareable across
    several :class:`Telemetry` fronts (one engine per arch) and
    persistable as a versioned JSON blob for cross-process warm starts.
    """

    def __init__(self, alpha: float = 0.25):
        self.alpha = float(alpha)
        # {(arch, phase, bucket_key) -> PhaseBucketStats}; bucket
        # GLOBAL_KEY is the per-(arch, phase) aggregate estimates fall
        # back to — never across archs
        self._lat: Dict[Tuple[str, str, Any], PhaseBucketStats] = {}

    def _entry(self, arch: str, phase: str, key) -> PhaseBucketStats:
        if (arch, phase, key) not in self._lat:
            self._lat[(arch, phase, key)] = PhaseBucketStats()
        return self._lat[(arch, phase, key)]

    def record(self, arch: str, phase: str, bucket: Optional[int],
               tok_ms: float, *, compiled: bool = False) -> None:
        for key in (_bucket_key(bucket), GLOBAL_KEY):
            rec = self._entry(arch, phase, key)
            (rec.compile if compiled else rec.steady).observe(
                tok_ms, self.alpha)

    def estimate(self, arch: str, phase: str,
                 bucket: Optional[int]) -> Optional[float]:
        for key in (_bucket_key(bucket), GLOBAL_KEY):
            rec = self._lat.get((arch, phase, key))
            if rec is not None and rec.steady.count > 0:
                return rec.steady.ewma_ms
        return None

    def archs(self) -> List[str]:
        return sorted({arch for (arch, _, _) in self._lat})

    def snapshot(self, arch: str) -> Dict[str, Dict[str, Any]]:
        """One arch's slice as ``{"decode@256": {...}, ...}``."""
        return {f"{phase}@{key}": rec.as_dict()
                for (a, phase, key), rec in sorted(
                    self._lat.items(),
                    key=lambda kv: (kv[0][0], kv[0][1], str(kv[0][2])))
                if a == arch}

    # ------------------------------------------------------- persistence
    def as_blob(self) -> Dict[str, Any]:
        archs: Dict[str, Dict[str, Any]] = {}
        for (arch, phase, key), rec in self._lat.items():
            archs.setdefault(arch, {})[f"{phase}@{key}"] = rec.as_dict()
        return {"version": TELEMETRY_BLOB_VERSION, "alpha": self.alpha,
                "archs": {a: dict(sorted(v.items()))
                          for a, v in sorted(archs.items())}}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.as_blob(), f, indent=1)
        return path

    def load(self, path: str) -> int:
        """Merge a saved blob into this table (saved entries overwrite
        same-key entries).  Raises ``ValueError`` on corrupt JSON, a
        structurally invalid blob, or a version mismatch — callers log
        and stay cold.  Returns the number of entries loaded."""
        try:
            with open(path) as f:
                blob = json.load(f)
        except (OSError, ValueError) as e:
            raise ValueError(
                f"telemetry warm-start blob {path!r} unreadable: {e}")
        if not isinstance(blob, dict):
            raise ValueError(
                f"telemetry warm-start blob {path!r}: expected an object, "
                f"got {type(blob).__name__}")
        version = blob.get("version")
        if version != TELEMETRY_BLOB_VERSION:
            raise ValueError(
                f"telemetry warm-start blob {path!r} has version "
                f"{version!r}, expected {TELEMETRY_BLOB_VERSION}")
        archs = blob.get("archs")
        if not isinstance(archs, dict):
            raise ValueError(
                f"telemetry warm-start blob {path!r}: missing 'archs'")
        loaded = 0
        try:
            for arch, table in archs.items():
                for pk, rec in table.items():
                    phase, _, key_s = pk.partition("@")
                    self._lat[(arch, phase, _parse_key(key_s))] = \
                        PhaseBucketStats.from_dict(rec)
                    loaded += 1
        except (AttributeError, KeyError, TypeError, ValueError) as e:
            raise ValueError(
                f"telemetry warm-start blob {path!r} malformed: {e}")
        return loaded


class Telemetry:
    """Metrics + tracing front for one :class:`ServingEngine` (or bench),
    bound to one ``arch`` over a (possibly shared) :class:`TelemetryTable`.

    ``clock`` is the time base (seconds); ``alpha`` the EWMA smoothing
    factor shared by every record; ``trace_path`` enables JSONL span
    export; ``warmstart_path`` names a blob to load at construction — if
    it exists — and to save via :meth:`save_warmstart`.  A bad blob logs a warning and leaves the
    table cold; it never raises out of the constructor.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 alpha: float = 0.25,
                 trace_path: Optional[str] = None,
                 arch: str = DEFAULT_ARCH,
                 table: Optional[TelemetryTable] = None,
                 warmstart_path: Optional[str] = None):
        import time
        self._clock = clock or time.monotonic
        self.arch = arch
        self.table = table if table is not None else TelemetryTable(alpha)
        self.alpha = self.table.alpha
        self.trace_path = trace_path or None
        self.warmstart_path = warmstart_path or None
        self.warmstart_loaded = False
        if self.warmstart_path and os.path.exists(self.warmstart_path):
            try:
                n = self.table.load(self.warmstart_path)
            except ValueError as e:
                log.warning("telemetry warm-start rejected (cold start): %s",
                            e)
            else:
                self.warmstart_loaded = True
                log.info("telemetry warm-start: %d entries from %s",
                         n, self.warmstart_path)
        self._spans: Dict[int, Dict[str, Any]] = {}    # rid -> open span
        self.finished_spans: List[Dict[str, Any]] = []

    # ------------------------------------------------------- latency table
    def record_latency(self, phase: str, bucket: Optional[int],
                       tok_ms: float, *, compiled: bool = False) -> None:
        """One per-token latency sample for ``phase`` under ``bucket``.
        ``compiled=True`` marks a first-dispatch (trace+compile) sample:
        it lands in the segregated compile record and NEVER moves the
        steady-state estimate."""
        self.table.record(self.arch, phase, bucket, tok_ms,
                          compiled=compiled)

    def estimate(self, phase: str, bucket: Optional[int]) -> Optional[float]:
        """Steady-state ms/token for this arch's ``phase`` at ``bucket``;
        falls back to the same arch's phase-global steady record when the
        bucket is unmeasured; None when the phase has no steady samples
        at all.  Never reads another arch's rungs."""
        return self.table.estimate(self.arch, phase, bucket)

    def latency_snapshot(self) -> Dict[str, Any]:
        """JSON-able view of this arch's slice of the table:
        ``{"version": 2, "arch": ..., "table": {"decode@256": {...},
        ...}}`` (``@*`` = phase-global aggregate, ``@-1`` =
        unbucketed)."""
        return {"version": TRACE_SCHEMA_VERSION, "arch": self.arch,
                "table": self.table.snapshot(self.arch)}

    def save_warmstart(self, path: Optional[str] = None) -> Optional[str]:
        """Persist the (shared) table for the next process; returns the
        path written, or None when no path is configured."""
        path = path or self.warmstart_path
        if not path:
            return None
        return self.table.save(path)

    # -------------------------------------------------------- span traces
    def begin_span(self, rid: int, *, prompt_len: int, max_new: int,
                   deadline_ms: Optional[float] = None,
                   priority: int = 0, t: Optional[float] = None,
                   **fields: Any) -> None:
        """Open ``rid``'s span.  Extra ``fields`` land on the span record
        verbatim — the engine's restart-recovery path stamps
        ``rehydrated=<outcome>`` so a resumed request's trace says it
        crossed a process boundary (its ``submit_t`` is back-dated to
        preserve the deadline budget already consumed)."""
        self._spans[rid] = {
            "version": TRACE_SCHEMA_VERSION, "arch": self.arch,
            "rid": rid, "submit_t": self._clock() if t is None else t,
            "prompt_len": int(prompt_len), "max_new": int(max_new),
            "deadline_ms": deadline_ms, "priority": int(priority),
            "status": "pending", "events": [], **fields}

    def first_token(self, rid: int) -> Optional[float]:
        """Mark ``rid``'s first emitted token and return its TTFT in ms
        (clock now minus span submit time).  Idempotent — a request
        restored after preemption already has its TTFT and keeps it; a
        no-op (None) for unknown rids."""
        span = self._spans.get(rid)
        if span is None:
            return None
        if "ttft_ms" not in span:
            span["ttft_ms"] = (self._clock() - span["submit_t"]) * 1e3
        return span["ttft_ms"]

    # repeated same-(kind, bucket) events merge into one counting event:
    # spans scale with bucket climbs and phase changes, not token counts
    _COALESCE = {"prefill": "chunks", "decode": "bursts",
                 "checkpoint": "count"}

    def event(self, rid: int, kind: str, *, bucket: Optional[int] = None,
              tokens: int = 0, **fields: Any) -> None:
        """Append one event to ``rid``'s span (no-op for unknown rids, so
        bench/test callers need no span bookkeeping).  ``prefill`` /
        ``decode`` / ``checkpoint`` events coalesce with the previous
        event when the kind AND bucket match."""
        span = self._spans.get(rid)
        if span is None:
            return
        ev: Dict[str, Any] = {"t": self._clock(), "kind": kind}
        if bucket is not None:
            ev["bucket"] = int(bucket)
        unit = self._COALESCE.get(kind)
        if unit is not None:
            prev = span["events"][-1] if span["events"] else None
            if (prev is not None and prev["kind"] == kind
                    and prev.get("bucket") == ev.get("bucket")):
                prev[unit] += 1
                if kind != "checkpoint":
                    prev["tokens"] += int(tokens)
                prev["t_last"] = ev["t"]
                return
            ev[unit] = 1
            if kind != "checkpoint":
                ev["tokens"] = int(tokens)
        ev.update(fields)
        span["events"].append(ev)

    def end_span(self, rid: int, status: str, *,
                 error: Optional[str] = None, tokens_out: int = 0) -> None:
        span = self._spans.pop(rid, None)
        if span is None:
            return
        span["status"] = status
        span["end_t"] = self._clock()
        span["span_ms"] = (span["end_t"] - span["submit_t"]) * 1e3
        span["tokens_out"] = int(tokens_out)
        if error:
            span["error"] = error
        span["preemptions"] = sum(1 for e in span["events"]
                                  if e["kind"] == "preempt")
        self.finished_spans.append(span)
        if self.trace_path:
            with open(self.trace_path, "a") as f:
                f.write(json.dumps(span) + "\n")

    def class_summary(self) -> Dict[int, Dict[str, Any]]:
        """Per-priority-class aggregates over the finished spans: request
        counts by status, tokens out, and TTFT p50/p95 (ms, over spans
        that emitted a first token).  The scheduling smoke bench reads
        this for its per-class fairness/starvation record."""
        by_cls: Dict[int, Dict[str, Any]] = {}
        for span in self.finished_spans:
            cls = int(span.get("priority", 0))
            agg = by_cls.setdefault(cls, {"count": 0, "by_status": {},
                                          "tokens_out": 0, "_ttft": []})
            agg["count"] += 1
            st = span.get("status", "unknown")
            agg["by_status"][st] = agg["by_status"].get(st, 0) + 1
            agg["tokens_out"] += int(span.get("tokens_out", 0))
            if span.get("ttft_ms") is not None:
                agg["_ttft"].append(float(span["ttft_ms"]))
        for agg in by_cls.values():
            ttfts = sorted(agg.pop("_ttft"))
            if ttfts:
                agg["ttft_p50_ms"] = ttfts[len(ttfts) // 2]
                agg["ttft_p95_ms"] = ttfts[
                    min(len(ttfts) - 1, int(len(ttfts) * 0.95))]
            else:
                agg["ttft_p50_ms"] = agg["ttft_p95_ms"] = None
        return by_cls


def read_trace(path: str) -> List[Dict[str, Any]]:
    """Load a JSONL span trace written through ``trace_path`` (one span
    object per line; blank lines ignored).  Raises ``ValueError`` when a
    line carries a different schema ``version`` — stale traces from an
    earlier (or later) layout must not be silently misread."""
    spans = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            span = json.loads(line)
            v = span.get("version")
            if v != TRACE_SCHEMA_VERSION:
                raise ValueError(
                    f"{path}:{i + 1}: trace span has schema version {v!r}, "
                    f"expected {TRACE_SCHEMA_VERSION} — stale trace file?")
            spans.append(span)
    return spans
