"""The port's scheduling policies against the reference's, on the CPU.

* Policy decisions on seeded random queues, the same calls on both
  sides: admission order, expiry, starvation, urgency, victims,
  interleave shares and DRR credit after service, for ``fifo``,
  ``strict_tiers`` and ``weighted_fair``; ``parse_weights`` and
  ``make_scheduler``.
* The engines: mixed-class traffic through 1 or 2 slots under each
  policy on the dense, mamba2 and hybrid fault-matrix configs (fp32):
  statuses, streams, preemptions and ``stats`` equal to the reference
  engine's, and every request's stream equal under every policy; a
  strict-tier preemption after the low request's KV passed the 128 rung
  and a preemption across a ring wrap (a ``local`` window of 16) equal to
  the reference's and to the uninterrupted run.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core.config import AttnConfig as JAttn
from repro.core.config import ModelConfig as JModel
from repro.serving import scheduler as jsched
from repro.serving.engine import Request as JRequest
from repro_torch.serving import scheduler as tsched
from repro_torch.serving.engine import Request
from tests.test_torch_faults import (engines, fp32_caches,  # noqa: F401
                                     outcome, prompts_for, run_both,
                                     setup_pair)

POLICIES = ("fifo", "strict_tiers", "weighted_fair")


def _queue(rng, n):
    return [SimpleNamespace(rid=i, priority=int(rng.integers(0, 3)),
                            submit_t=float(rng.uniform(0, 0.2)),
                            deadline_ms=(None if rng.random() < 0.5
                                         else float(rng.uniform(10, 300))))
            for i in range(n)]


def _cands(rng, n):
    return [(int(b), int(rng.integers(0, 3)),
             float("inf") if rng.random() < 0.3 else
             float(rng.choice([5.0, 50.0, 500.0])), int(rng.integers(1, 9)))
            for b in rng.permutation(n)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_decisions_equal_reference(policy, seed):
    rng = np.random.default_rng(seed)
    weights, starve = {0: 1.0, 1: 4.0, 2: 16.0}, 60.0
    t, j = (m.make_scheduler(policy, dict(weights), starve)
            for m in (tsched, jsched))
    for step in range(12):
        now = 0.2 + 0.01 * step
        queue = _queue(rng, int(rng.integers(0, 7)))
        live = [r if rng.random() < 0.7 else None
                for r in _queue(rng, 4)]
        ids = lambda rs: [r.rid for r in rs]  # noqa: E731
        assert ids(t.admission_order(queue, now)) == \
            ids(j.admission_order(queue, now))
        assert ids(t.starved_out(queue, live, now)) == \
            ids(j.starved_out(queue, live, now))
        assert t.urgent_preempt(queue, live) == j.urgent_preempt(queue, live)
        assert [t.expired(r, now) for r in queue] == \
            [j.expired(r, now) for r in queue]
        cands = _cands(rng, int(rng.integers(0, 5)))
        assert t.preempt_victim([tsched.VictimCandidate(*c) for c in cands],
                                queue) == \
            j.preempt_victim([jsched.VictimCandidate(*c) for c in cands],
                             queue)
        g = [int(x) for x in rng.integers(0, 3, int(rng.integers(0, 3)))]
        lv = [int(x) for x in rng.integers(0, 3, int(rng.integers(0, 3)))]
        assert t.interleave_share(g, lv) == j.interleave_share(g, lv)
        for _ in range(int(rng.integers(0, 4))):
            cls, tok = int(rng.integers(0, 3)), int(rng.integers(0, 80))
            t.note_service(cls, tok)
            j.note_service(cls, tok)
        assert t.class_service() == j.class_service()
        assert getattr(t, "_credit", None) == getattr(j, "_credit", None)


@pytest.mark.parametrize("spec", [None, "", "0:1,1:4", " 0:1 , 2:16.5 ,"])
def test_parse_weights_equals_reference(spec):
    assert tsched.parse_weights(spec) == jsched.parse_weights(spec)


@pytest.mark.parametrize("bad", ["1", "a:2", "1:x", "-1:2", "1:0", "1:-3"])
def test_parse_weights_rejects(bad):
    with pytest.raises(ValueError, match="malformed"):
        tsched.parse_weights(bad)


def test_make_scheduler():
    assert tsched.make_scheduler().policy == "fifo"
    s = tsched.make_scheduler("weighted_fair", {1: 4.0}, 30.0)
    assert s.policy == "weighted_fair" and s.weights == {1: 4.0}
    assert s.starve_ms == 30.0 and s.quantum == tsched.DEFAULT_QUANTUM
    assert tsched.POLICIES == jsched.POLICIES
    with pytest.raises(ValueError, match="unknown scheduling policy"):
        tsched.make_scheduler("lottery")


# ------------------------------------------------------------- engines

def _pair(policy, weights=None, starve_ms=None):
    return (tsched.make_scheduler(policy, weights, starve_ms),
            jsched.make_scheduler(policy, weights, starve_ms))


def _mixed(arch, lens=(9, 6, 11, 7), max_new=8):
    _, tc, _, _ = setup_pair(arch)
    return [(i, p, max_new, {"priority": i % 2})
            for i, p in enumerate(prompts_for(tc.vocab_size, lens))]


_STREAMS = {}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ("dense", "mamba2", "hybrid"))
def test_engine_policy_equals_reference(arch, policy, fp32_caches):
    """Two slots, four mixed-class requests (weights 1:4): the port's
    engine decides and decodes as the reference's, and each request's
    stream is the same under every policy."""
    teng, _ = run_both(arch, _mixed(arch), max_iters=500,
                       scheduler=_pair(policy, {0: 1.0, 1: 4.0}))
    assert all(r.status == "ok" for r in teng.finished)
    streams = {r.rid: r.out for r in teng.finished}
    assert _STREAMS.setdefault(arch, streams) == streams


def _staged(arch, first, later, *, after=3, max_iters=500, **kw):
    """Both engines: submit ``first``, step ``after`` times, submit
    ``later`` (arrivals while the first requests decode), run; their
    outcomes must agree.  Returns the port's engine."""
    jeng, teng = engines(arch, **kw)
    for eng, make in ((teng, Request), (jeng, JRequest)):
        for batch in (first, later):
            for rid, p, n, extra in batch:
                eng.submit(make(rid=rid, prompt=p, max_new=n, **extra))
            if batch is first:
                for _ in range(after):
                    eng.step()
        eng.run(max_iters=max_iters)
    assert outcome(teng) == outcome(jeng)
    return teng


@pytest.mark.parametrize("policy", POLICIES)
def test_engine_preempts_with_one_slot(policy, fp32_caches):
    """One slot: a class-2 arrival while class-0/1 requests decode.
    Strict tiers preempts at once, the other policies after
    ``preempt_after``; every preempted request is restored and both
    engines agree on every stream."""
    reqs = _mixed("hybrid", lens=(9, 6, 11, 5), max_new=20)
    later = [(3, reqs[3][1], 6, {"priority": 2})]
    teng = _staged("hybrid", reqs[:3], later, after=2, slots=1,
                   preempt_after=2,
                   scheduler=_pair(policy, {0: 1.0, 1: 2.0, 2: 8.0}))
    assert teng.stats["preemptions"] >= 1
    assert teng.stats["restores"] == teng.stats["preemptions"]
    assert all(r.status == "ok" for r in teng.finished)


def test_strict_tier_preemption_restores_across_buckets(fp32_caches):
    """The low request is preempted after its KV passed the 128 rung and
    resumes under other rungs: both engines agree, and its stream is the
    uninterrupted run's."""
    _, tc, _, _ = setup_pair("dense")
    rng = np.random.default_rng(11)
    low = rng.integers(2, tc.vocab_size, 120).astype(np.int32)
    high = rng.integers(2, tc.vocab_size, 9).astype(np.int32)
    kw = dict(slots=1, max_seq=192, chunk_size=32, max_iters=500)
    solo, _ = run_both("dense", [(0, low, 16, {})],
                       scheduler=_pair("strict_tiers"), **kw)
    jeng, teng = engines("dense", slots=1, max_seq=192, chunk_size=32,
                         scheduler=_pair("strict_tiers"))
    for eng, req in ((teng, Request), (jeng, JRequest)):
        eng.submit(req(rid=0, prompt=low, max_new=16, priority=0))
        while not (eng.live[0] is not None and len(eng.live[0].out) >= 10):
            assert eng.step()
        assert int(eng.pos[0]) > 128
        eng.submit(req(rid=1, prompt=high, max_new=8, priority=1))
        eng.run(max_iters=500)
    assert outcome(teng) == outcome(jeng)
    done = {r.rid: r for r in teng.finished}
    assert teng.stats["preemptions"] >= 1
    assert [r.rid for r in teng.finished][0] == 1
    assert done[0].status == "ok" and done[0].out == solo.finished[0].out


def _local_cfg():
    """A two-layer sliding-window model (window 16) on the reference's
    fault-matrix widths."""
    return JModel(name="local", family="dense", n_layers=2, d_model=64,
                  d_ff=128, vocab_size=97,
                  attn=JAttn(n_heads=4, n_kv_heads=2, head_dim=16,
                             sliding_window=16),
                  layer_pattern=("local",), vocab_pad_multiple=16)


@pytest.mark.parametrize("policy", ("fifo", "strict_tiers"))
def test_preemption_across_a_ring_wrap(policy, fp32_caches):
    """Every prompt is past the 16-slot window, so each ring has wrapped
    when its slot is offloaded; the resumed streams equal the reference
    engine's and the uninterrupted ones."""
    jc = dataclasses.replace(_local_cfg(), compute_dtype="float32")
    _, tc, _, _ = setup_pair("local", jc)
    prompts = prompts_for(tc.vocab_size, lens=(21, 27, 18), seed=4)
    reqs = [(i, p, 14, {"priority": int(i == 2)})
            for i, p in enumerate(prompts)]
    kw = dict(jcfg=jc, slots=1, max_seq=64, chunk_size=8, preempt_after=2)
    teng = _staged("local", reqs[:2], reqs[2:], after=5,
                   scheduler=_pair(policy), **kw)
    assert teng.stats["preemptions"] >= 1
    for rid, p, n, extra in reqs:
        solo, _ = run_both("local", [(rid, p, n, extra)],
                           scheduler=_pair(policy), max_iters=500, **kw)
        assert {r.rid: r.out for r in teng.finished}[rid] == \
            solo.finished[0].out
