"""Typed serving metrics registry: counters, gauges and histograms with
JSONL and Prometheus text exports.

The port's copy of the reference's ``serving/metrics.py``; the export
path is an argument only (the port reads no environment).

The serving engine's ``stats`` dict grew one ad-hoc scalar per PR; none of
it was typed, labelled, or exportable to the monitoring stack a real
deployment scrapes.  This module is the structured replacement: a small
registry of named instruments —

* :class:`Counter` — monotone totals (requests admitted, tokens decoded,
  checkpoint bytes, bucket-ladder climbs).  ``inc`` of a negative amount
  is a caller bug and raises.
* :class:`Gauge` — point-in-time values (queue depth, live slots,
  tokens/s per phase).
* :class:`Histogram` — distribution of samples over fixed bucket bounds
  (decode-burst / prefill-chunk wall ms), exported cumulatively the way
  Prometheus expects.

Every instrument supports Prometheus-style labels via :meth:`labels`
(children are cached per label-set, so hot-path calls are one dict
lookup).  The registry snapshots to a JSON-able dict (pure copy — two
consecutive snapshots are equal and mutating one never touches the
registry), exports one JSON line per call via :meth:`MetricsRegistry.export` (to
the path given at construction or to the call; a ``.prom`` suffix
switches to the Prometheus text exposition format, full escaping
included), and is shared by
``ServingEngine``, ``ChunkedPrefill`` and the cache offload/restore path
through plain get-or-create lookups — no global mutable default registry.
"""
from __future__ import annotations

import copy
import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

#: schema version stamped on every metrics JSONL line (bump on breaking
#: changes so downstream readers can reject stale files)
METRICS_SCHEMA_VERSION = 1

#: default histogram bounds (ms-scale latencies); +Inf is implicit
DEFAULT_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   500.0, 1000.0, 2500.0)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return (str(v).replace("\\", "\\\\").replace("\"", "\\\"")
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    """HELP-line escaping: backslash and newline only (quotes are legal)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels: _LabelKey, extra: Optional[Tuple[str, str]] = None
                ) -> str:
    pairs = list(labels) + ([extra] if extra else [])
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs) + "}"


class _Child:
    """One (instrument, label-set) time series."""

    def __init__(self, labels: _LabelKey):
        self.label_pairs = labels


class _CounterChild(_Child):
    def __init__(self, labels: _LabelKey):
        super().__init__(labels)
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        self.value += amount


class _GaugeChild(_Child):
    def __init__(self, labels: _LabelKey):
        super().__init__(labels)
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class _HistogramChild(_Child):
    def __init__(self, labels: _LabelKey, bounds: Tuple[float, ...]):
        super().__init__(labels)
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)    # last = > bounds[-1]
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> List[Tuple[str, int]]:
        """Prometheus-style cumulative (le, count) rows ending at +Inf."""
        out = []
        run = 0
        for b, c in zip(self.bounds, self.counts):
            run += c
            out.append((repr(float(b)), run))
        out.append(("+Inf", self.count))
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Prometheus-style estimated q-quantile (linear interpolation
        inside the covering bucket; the overflow bucket reports its lower
        bound — an honest floor, since nothing bounds it above).  None
        until a sample has been observed."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return None
        rank = q * self.count
        run = 0
        lo = 0.0
        for b, c in zip(self.bounds, self.counts):
            if run + c >= rank and c > 0:
                return lo + (b - lo) * max(rank - run, 0.0) / c
            run += c
            lo = b
        return self.bounds[-1]


class _Instrument:
    """A named metric family: the no-label default child plus any
    labelled children created through :meth:`labels`."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", **kwargs: Any):
        self.name = name
        self.help = help
        self._kwargs = kwargs
        self._children: Dict[_LabelKey, _Child] = {}

    def _child_cls(self):
        raise NotImplementedError

    def labels(self, **labels: str):
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            child = self._child_cls()(key, **self._kwargs)
            self._children[key] = child
        return child

    @property
    def _default(self):
        return self.labels()

    def children(self) -> List[_Child]:
        return list(self._children.values())


class Counter(_Instrument):
    kind = "counter"

    def _child_cls(self):
        return _CounterChild

    def inc(self, amount: float = 1.0) -> None:
        self._default.inc(amount)

    @property
    def value(self) -> float:
        return self._default.value


class Gauge(_Instrument):
    kind = "gauge"

    def _child_cls(self):
        return _GaugeChild

    def set(self, value: float) -> None:
        self._default.set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default.inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default.dec(amount)

    @property
    def value(self) -> float:
        return self._default.value


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError(f"{name}: histogram needs >= 1 bucket bound")
        super().__init__(name, help, bounds=bounds)
        self.bounds = bounds

    def _child_cls(self):
        return _HistogramChild

    def observe(self, value: float) -> None:
        self._default.observe(value)

    def quantile(self, q: float) -> Optional[float]:
        return self._default.quantile(q)


class MetricsRegistry:
    """Get-or-create instrument registry for one serving process.

    ``clock`` stamps exported JSONL lines (injectable so fake-clock tests
    see deterministic timestamps); ``path`` is the default export target
    (None: :meth:`export` writes nothing unless given a path).
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 path: Optional[str] = None):
        self._clock = clock or time.monotonic
        self.default_path = path or None
        self._metrics: Dict[str, _Instrument] = {}

    def _get(self, cls, name: str, help: str, **kwargs: Any):
        inst = self._metrics.get(name)
        if inst is None:
            inst = cls(name, help, **kwargs)
            self._metrics[name] = inst
        elif not isinstance(inst, cls):
            raise ValueError(
                f"metric {name!r} already registered as {inst.kind}, "
                f"requested {cls.kind}")
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    # --------------------------------------------------------------- export
    def snapshot(self) -> Dict[str, Any]:
        """Pure JSON-able copy of every time series.  Idempotent: calling
        it twice without intervening updates yields equal dicts, and the
        returned structure shares no state with the registry."""
        out: Dict[str, Any] = {"version": METRICS_SCHEMA_VERSION,
                               "metrics": {}}
        for name in sorted(self._metrics):
            inst = self._metrics[name]
            samples = []
            for child in inst.children():
                labels = dict(child.label_pairs)
                if isinstance(child, _HistogramChild):
                    samples.append({
                        "labels": labels, "sum": child.sum,
                        "count": child.count,
                        "buckets": [[le, c] for le, c in child.cumulative()]})
                else:
                    samples.append({"labels": labels, "value": child.value})
            out["metrics"][name] = {"type": inst.kind, "help": inst.help,
                                    "samples": samples}
        return copy.deepcopy(out)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (escaped HELP lines and label
        values, cumulative histogram buckets with the +Inf rail)."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            inst = self._metrics[name]
            if inst.help:
                lines.append(f"# HELP {name} {_escape_help(inst.help)}")
            lines.append(f"# TYPE {name} {inst.kind}")
            for child in inst.children():
                lp = child.label_pairs
                if isinstance(child, _HistogramChild):
                    for le, c in child.cumulative():
                        lines.append(
                            f"{name}_bucket{_fmt_labels(lp, ('le', le))} {c}")
                    lines.append(f"{name}_sum{_fmt_labels(lp)} {child.sum}")
                    lines.append(f"{name}_count{_fmt_labels(lp)} "
                                 f"{child.count}")
                else:
                    lines.append(f"{name}{_fmt_labels(lp)} {child.value}")
        return "\n".join(lines) + "\n"

    def export(self, path: Optional[str] = None) -> Optional[str]:
        """Write the current state to ``path`` (default: the registry's
        ``default_path``).  ``*.prom`` targets are overwritten with
        the Prometheus text format; anything else gets one appended JSON
        line per call (``{"t": ..., "version": ..., "metrics": ...}``).
        Returns the path written, or None when no path is configured."""
        path = path or self.default_path
        if not path:
            return None
        if path.endswith(".prom"):
            with open(path, "w") as f:
                f.write(self.to_prometheus())
        else:
            snap = self.snapshot()
            snap["t"] = self._clock()
            with open(path, "a") as f:
                f.write(json.dumps(snap) + "\n")
        return path
