"""The port's metrics registry and telemetry against the reference's, on
the CPU: the same sequence of calls on both sides gives the same
Prometheus text, snapshots, JSONL exports, latency table, estimates,
warm-start blob, spans, JSONL trace and class summary.  Then one engine
run each (the hybrid fault-matrix config, fp32, a fake clock that ticks
1 ms a read, a preemption and a replay on the way) gives the reference
engine's counters, span events and latency-table keys, and the first
burst at each KV rung is kept out of the steady estimates.
"""
import json

import numpy as np
import pytest

from repro.serving import metrics as jmetrics
from repro.serving import telemetry as jtel
from repro_torch.serving import metrics as tmetrics
from repro_torch.serving import telemetry as ttel
from tests.test_torch_faults import (FakeClock, engines,  # noqa: F401
                                     fp32_caches, outcome, prompts_for,
                                     setup_pair, submit_both)


def _drive_metrics(mod, clock):
    reg = mod.MetricsRegistry(clock=clock)
    c = reg.counter("repro_tokens_total", 'tokens "per" phase\nand class')
    c.inc()
    c.labels(phase="decode").inc(8)
    c.labels(phase='pre"fill\\x').inc(3.5)
    g = reg.gauge("repro_queue_depth", "queue")
    g.set(4)
    g.dec(1.5)
    g.labels(slot="2").inc(2)
    h = reg.histogram("repro_decode_burst_ms", "burst ms")
    for v in (0.2, 3.0, 7.5, 7.5, 60.0, 5000.0):
        h.observe(v)
    h2 = reg.histogram("repro_custom_ms", "custom", buckets=(10.0, 1.0))
    h2.labels(priority="1").observe(4.0)
    return reg


def test_metrics_registry_equals_reference(tmp_path):
    t = _drive_metrics(tmetrics, FakeClock(tick_ms=2.0))
    j = _drive_metrics(jmetrics, FakeClock(tick_ms=2.0))
    assert t.to_prometheus() == j.to_prometheus()
    assert t.snapshot() == j.snapshot()
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert t.histogram("repro_decode_burst_ms").quantile(q) == \
            j.histogram("repro_decode_burst_ms").quantile(q)
    for name in ("m.prom", "m.jsonl"):
        tp, jp = tmp_path / ("t" + name), tmp_path / ("j" + name)
        for _ in range(2):
            assert t.export(str(tp)) == str(tp)
            j.export(str(jp))
        assert tp.read_text() == jp.read_text()
    assert t.export() is None


def test_metrics_semantics():
    reg = tmetrics.MetricsRegistry()
    with pytest.raises(ValueError, match=">= 0"):
        reg.counter("a").inc(-1)
    reg.gauge("b")
    with pytest.raises(ValueError, match="already registered as gauge"):
        reg.counter("b")
    assert reg.counter("a") is reg.counter("a")
    with pytest.raises(ValueError, match="bucket"):
        reg.histogram("c", buckets=())
    assert reg.histogram("d").quantile(0.5) is None
    snap = reg.snapshot()
    snap["metrics"]["a"]["samples"].append("x")
    assert reg.snapshot() != snap


def _drive_telemetry(mod, clock, tmp_path, tag):
    tel = mod.Telemetry(clock=clock, arch="hyb",
                        trace_path=str(tmp_path / f"{tag}.jsonl"),
                        warmstart_path=str(tmp_path / f"{tag}.json"))
    for i, (phase, bucket, ms, comp) in enumerate(
            (("decode", 128, 9.0, True), ("decode", 128, 1.0, False),
             ("decode", 128, 3.0, False), ("decode", 256, 2.0, False),
             ("prefill", None, 0.5, False), ("prefill", 512, 40.0, True))):
        tel.record_latency(phase, bucket, ms, compiled=comp)
    for rid, prio in ((1, 0), (2, 1), (3, 1)):
        tel.begin_span(rid, prompt_len=9 + rid, max_new=8,
                       deadline_ms=None if rid == 1 else 500.0,
                       priority=prio)
    tel.event(1, "prefill", bucket=128, tokens=8)
    tel.event(1, "prefill", bucket=128, tokens=1)
    tel.first_token(1)
    tel.first_token(1)
    for _ in range(3):
        tel.event(1, "decode", bucket=128, tokens=4)
    tel.event(1, "decode", bucket=256, tokens=4)
    tel.event(1, "checkpoint")
    tel.event(1, "checkpoint")
    tel.event(2, "preempt", pos=17)
    tel.event(2, "restore", pos=17)
    tel.first_token(2)
    tel.event(99, "decode", bucket=128, tokens=4)        # unknown rid
    tel.end_span(1, "ok", tokens_out=16)
    tel.end_span(2, "failed", error="rid=2: payload crc32 mismatch",
                 tokens_out=3)
    tel.end_span(3, "timed_out", tokens_out=0)
    tel.save_warmstart()
    return tel


def test_telemetry_equals_reference(tmp_path):
    t = _drive_telemetry(ttel, FakeClock(tick_ms=1.0), tmp_path, "t")
    j = _drive_telemetry(jtel, FakeClock(tick_ms=1.0), tmp_path, "j")
    for phase in ("decode", "prefill"):
        for bucket in (None, 128, 256, 512, 1024):
            assert t.estimate(phase, bucket) == j.estimate(phase, bucket)
    assert t.latency_snapshot() == j.latency_snapshot()
    assert t.table.as_blob() == j.table.as_blob()
    assert t.finished_spans == j.finished_spans
    assert t.class_summary() == j.class_summary()
    assert (tmp_path / "t.jsonl").read_text() == \
        (tmp_path / "j.jsonl").read_text()
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    assert ttel.read_trace(str(tmp_path / "t.jsonl")) == t.finished_spans
    # warm start: a new front loads the saved table, and each side reads
    # the other's blob
    for path in ("t.json", "j.json"):
        warm = ttel.Telemetry(arch="hyb",
                              warmstart_path=str(tmp_path / path))
        assert warm.warmstart_loaded
        assert warm.latency_snapshot() == t.latency_snapshot()


def test_compile_samples_stay_out_of_estimates():
    tel = ttel.Telemetry(arch="a")
    tel.record_latency("decode", 256, 500.0, compiled=True)
    assert tel.estimate("decode", 256) is None
    tel.record_latency("decode", 128, 2.0)
    assert tel.estimate("decode", 256) == 2.0          # phase-global
    other = ttel.Telemetry(arch="b", table=tel.table)
    assert other.estimate("decode", 128) is None       # never across archs


@pytest.mark.parametrize("bad", ["{not json", '{"version": 9}', "[1, 2]",
                                 '{"version": 1}',
                                 '{"version": 1, "archs": {"a": 3}}'])
def test_warmstart_rejects_corrupt_blobs(bad, tmp_path):
    path = tmp_path / "w.json"
    path.write_text(bad)
    with pytest.raises(ValueError, match="warm-start blob"):
        ttel.TelemetryTable().load(str(path))
    tel = ttel.Telemetry(arch="a", warmstart_path=str(path))
    assert not tel.warmstart_loaded
    assert tel.estimate("decode", None) is None


def test_read_trace_rejects_stale_schema(tmp_path):
    path = tmp_path / "t.jsonl"
    path.write_text(json.dumps({"version": 1, "rid": 0}) + "\n\n")
    with pytest.raises(ValueError, match="schema version"):
        ttel.read_trace(str(path))


def test_engine_telemetry_and_metrics_equal_reference(fp32_caches):
    """One slot under strict tiers with a class-1 arrival (a preemption)
    and a decode NaN (a replay): counters, span events, statuses and
    latency-table keys equal the reference engine's under the same fake
    clock; the first burst at each rung is a compile sample."""
    jeng, teng = engines("hybrid", slots=1, preempt_after=2,
                         checkpoint_every=2, spec="nan_decode@iter=3:slot=0",
                         clock=None)
    for eng in (jeng, teng):
        clock = FakeClock(tick_ms=1.0)
        eng._clock = eng.telemetry._clock = eng.metrics._clock = clock
    _, tc, _, _ = setup_pair("hybrid")
    p = prompts_for(tc.vocab_size, lens=(9, 6, 11))
    submit_both(jeng, teng, [(0, p[0], 16, {}), (1, p[1], 12, {}),
                             (2, p[2], 6, {"priority": 1})])
    jeng.run(max_iters=300)
    teng.run(max_iters=300)
    assert outcome(teng) == outcome(jeng)
    assert teng.stats["preemptions"] >= 1 and teng.stats["replays"] == 1

    def counters(eng):
        snap = eng.metrics.snapshot()["metrics"]
        return {k: v for k, v in snap.items() if v["type"] == "counter"
                and not k.endswith("_ms")}
    assert counters(teng) == counters(jeng)
    strip = lambda spans: [  # noqa: E731
        (s["rid"], s["status"], s["preemptions"], s["tokens_out"],
         [(e["kind"], e.get("bucket"), e.get("tokens"), e.get("bursts"),
           e.get("chunks"), e.get("detail"), e.get("pos"))
          for e in s["events"]]) for s in spans]
    assert strip(teng.telemetry.finished_spans) == \
        strip(jeng.telemetry.finished_spans)
    table = teng.telemetry.latency_snapshot()["table"]
    assert sorted(table) == \
        sorted(jeng.telemetry.latency_snapshot()["table"])
    for key, rec in table.items():
        if key.startswith("decode@") and key != "decode@*":
            assert rec["compile"]["count"] == 1
    assert np.isfinite(teng.telemetry.estimate("decode", None))
