"""The port's fault-tolerance layer against the reference's, on the CPU.

The reference's fault matrix configs (``tests/test_faults.py``: dense,
mamba2 and the zamba2-style hybrid at d_model 64, vocab 97) in fp32
compute on fp32 caches, the reference's params carried across by
``from_jax``; the reference engine's calls run under ``jax.jit`` as the
engine itself jits them.  Under one fault spec both engines must end
every request in the same status with the same error text and token
stream, and with equal ``stats`` (the timing entry ``ckpt_ms`` aside):

* the spec grammar, clause budgets, the stall window, ``corrupt_blob``
  (the same byte flipped as the reference's) and ``poison_slot`` (one
  row, in place);
* a decode NaN replayed from its checkpoint (streams equal to the
  fault-free run), a decode NaN without checkpoints, a prefill NaN;
* a corrupt preemption blob failing only its victim;
* the watchdog and ``run(max_iters)``.

Decisions that hang on the engine's own clock reads (deadlines queued,
mid-prefill and mid-decode, the admission reject) make the reference
tests' own assertions with the same fake clock.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.engine as j_engine_mod
import repro.serving.prefill as j_prefill_mod
import repro_torch.serving.engine as t_engine_mod
import repro_torch.serving.prefill as t_prefill_mod
from repro.models import lm as jlm
from repro.serving.cache import offload_slot as j_offload_slot
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.fault_inject import FaultPlan as JFaultPlan
from repro.serving.fault_inject import parse_spec as j_parse_spec
from repro_torch.convert import from_jax, to_numpy
from repro_torch.core import config as tconfig
from repro_torch.models import lm
from repro_torch.models.params import tree_leaves
from repro_torch.serving.cache import offload_slot
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.fault_inject import (FaultPlan, parse_spec,
                                              poison_slot)
from repro_torch.serving.faults import (TERMINAL_STATES, CacheCorruption,
                                        DeadlineExceeded, DivergenceDetected,
                                        RequestError, SlotStalled)
from tests.test_faults import _cfg as j_test_cfg

ARCHS = ("dense", "mamba2", "hybrid")


# ------------------------------------------------------------- shared setup

def port_cfg(jcfg):
    """The port's ModelConfig with the reference config's fields."""
    def conv(obj, cls):
        if obj is None:
            return None
        return cls(**{f.name: getattr(obj, f.name)
                      for f in dataclasses.fields(cls)})
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(tconfig.ModelConfig)}
    kw.update(attn=conv(jcfg.attn, tconfig.AttnConfig),
              ssm=conv(jcfg.ssm, tconfig.SSMConfig),
              shared_attn=conv(jcfg.shared_attn, tconfig.AttnConfig),
              moe=conv(jcfg.moe, tconfig.MoEConfig))
    return tconfig.ModelConfig(**kw)


_SETUPS = {}


def setup_pair(arch, jcfg=None):
    """(reference cfg, port cfg, reference params, port params) in fp32
    compute for one of the reference's fault-matrix archs (or ``jcfg``)."""
    key = arch if jcfg is None else (arch, jcfg)
    if key not in _SETUPS:
        jc = dataclasses.replace(jcfg or j_test_cfg(arch),
                                 compute_dtype="float32")
        jp = jax.jit(functools.partial(jlm.init_lm_params, jc))(
            jax.random.PRNGKey(0))
        tp = from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        _SETUPS[key] = (jc, port_cfg(jc), jp, tp)
    return _SETUPS[key]


@pytest.fixture
def fp32_caches(monkeypatch):
    """Both engines (and their prefill groups) on fp32 caches."""
    for mod in (j_engine_mod, j_prefill_mod):
        monkeypatch.setattr(mod, "init_lm_cache", functools.partial(
            jlm.init_lm_cache, dtype=jnp.float32))
    for mod in (t_engine_mod, t_prefill_mod):
        monkeypatch.setattr(mod, "init_lm_cache", functools.partial(
            lm.init_lm_cache, dtype=torch.float32))


def prompts_for(vocab, lens=(9, 6), seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, int(n)).astype(np.int32) for n in lens]


ENG_KW = dict(slots=2, max_seq=48, decode_block=4, chunk_size=8)


def engines(arch, *, spec="", seed=0, jcfg=None, **kw):
    """The reference engine and the port's, same arguments, each with its
    own fault plan from ``spec``."""
    jc, tc, jp, tp = setup_pair(arch, jcfg)
    args = dict(ENG_KW, **kw)
    j_args = {k: v for k, v in args.items() if k != "scheduler"}
    t_args = dict(j_args)
    if "scheduler" in args:
        j_args["scheduler"], t_args["scheduler"] = args["scheduler"]
    jeng = JEngine(jc, jp, fault_plan=JFaultPlan.from_spec(spec, seed),
                   **j_args)
    teng = ServingEngine(tc, tp, fault_plan=FaultPlan.from_spec(spec, seed),
                         device="cpu", **t_args)
    return jeng, teng


def submit_both(jeng, teng, reqs):
    """``reqs``: (rid, prompt, max_new, extra Request fields) tuples."""
    for rid, prompt, max_new, extra in reqs:
        jeng.submit(JRequest(rid=rid, prompt=prompt, max_new=max_new,
                             **extra))
        teng.submit(Request(rid=rid, prompt=prompt, max_new=max_new,
                            **extra))


def outcome(eng):
    """Everything the two engines must agree on: per request status, error
    class and text, tokens and preemptions, in finishing order, and
    ``stats`` less its timing entry."""
    reqs = [(r.rid, r.status, type(r.error).__name__ if r.error else None,
             str(r.error) if r.error else None, list(r.out), r.preemptions,
             r.replays) for r in eng.finished]
    return reqs, {k: v for k, v in eng.stats.items() if k != "ckpt_ms"}


def run_both(arch, reqs, *, max_iters=200, **kw):
    jeng, teng = engines(arch, **kw)
    submit_both(jeng, teng, reqs)
    jeng.run(max_iters=max_iters)
    teng.run(max_iters=max_iters)
    got, want = outcome(teng), outcome(jeng)
    assert got == want
    assert all(r.status in TERMINAL_STATES for r in teng.finished)
    return teng, jeng


def matrix_reqs(arch, n_req=2, max_new=8):
    _, tc, _, _ = setup_pair(arch)
    return [(i, p, max_new, {}) for i, p in
            enumerate(prompts_for(tc.vocab_size, (9, 6, 11)[:n_req]))]


class FakeClock:
    """Injectable engine clock (seconds), as the reference tests' own."""

    def __init__(self, tick_ms=0.0):
        self.t = 0.0
        self.tick = tick_ms / 1e3

    def __call__(self):
        self.t += self.tick
        return self.t

    def advance_ms(self, ms):
        self.t += ms / 1e3


# ---------------------------------------------------------------- spec DSL

@pytest.mark.parametrize("spec", [
    "nan_decode@iter=7:slot=2,corrupt_blob@rid=r3,stall@iter=12:n=3",
    "nan_prefill@chunk=1:row=2:n=-1,kill@iter=4:point=1",
    " kill@iter=0 , ,stall@iter=5", ""])
def test_parse_spec_equals_reference(spec):
    got = [(c.kind, c.params, c.fired) for c in parse_spec(spec)]
    want = [(c.kind, c.params, c.fired) for c in j_parse_spec(spec)]
    assert got == want


@pytest.mark.parametrize("bad", ["meteor@iter=1", "nan_decode",
                                 "stall@iter", "nan_decode@iter=x"])
def test_parse_spec_rejects(bad):
    with pytest.raises(ValueError) as got:
        parse_spec(bad)
    with pytest.raises(ValueError) as want:
        j_parse_spec(bad)
    assert str(got.value) == str(want.value)


def test_clause_budgets_and_stall_window():
    plan = FaultPlan.from_spec("nan_decode@iter=2:slot=1,stall@iter=5:n=2,"
                               "kill@iter=3:point=1")
    assert plan.nan_decode_slots(1) == []
    assert plan.nan_decode_slots(3) == [1]
    assert plan.nan_decode_slots(4) == []
    assert not plan.stalled(4)
    assert plan.stalled(5) and plan.stalled(6)
    assert not plan.stalled(7)
    assert not plan.kill_now(5) and not plan.kill_now(2, point=1)
    assert plan.kill_now(3, point=1) and not plan.kill_now(4, point=1)
    assert FaultPlan.from_spec("stall@iter=0").stalled(10 ** 6)
    assert not FaultPlan().active


def _filled_cache(tc, jc, b=2, max_seq=32):
    """The same random values in a port and a reference cache (fp32)."""
    tcache = lm.init_lm_cache(tc, b, max_seq, dtype=torch.float32,
                              device="cpu")
    rng = np.random.default_rng(0)
    for t in tree_leaves(tcache["segments"]):
        t.copy_(torch.from_numpy(rng.normal(size=t.shape).astype(
            np.float32)))
    tcache["pos"].copy_(torch.tensor([5, 17][:b], dtype=torch.int32))
    jcache = jax.tree_util.tree_map(jnp.asarray, to_numpy(tcache))
    return tcache, jcache


@pytest.mark.parametrize("arch", ARCHS)
def test_corrupt_blob_flips_the_references_bit(arch):
    """Same spec and seed: the port flips the byte the reference flips
    (same key, same bytes after), leaves its input untouched, and spends
    no budget on another rid."""
    jc, tc, _, _ = setup_pair(arch)
    tcache, jcache = _filled_cache(tc, jc)
    tblob = offload_slot(tcache, 1, tags={"rid": 5})
    jblob = j_offload_slot(jcache, 1, tags={"rid": 5})
    keep = {k: v.clone() for k, v in tblob.items() if k != "__meta__"}
    tplan = FaultPlan.from_spec("corrupt_blob@rid=r5", seed=11)
    jplan = JFaultPlan.from_spec("corrupt_blob@rid=r5", seed=11)
    assert tplan.corrupt_blob(6, tblob) is tblob
    got, want = tplan.corrupt_blob(5, tblob), jplan.corrupt_blob(5, jblob)
    diff = [k for k in keep if not torch.equal(got[k], keep[k])]
    assert diff == [k for k in keep
                    if not np.array_equal(want[k], jblob[k])]
    assert len(diff) == 1
    np.testing.assert_array_equal(got[diff[0]].numpy(), want[diff[0]])
    for k in keep:
        assert torch.equal(tblob[k], keep[k])
    assert tplan.corrupt_blob(5, tblob) is tblob       # budget n=1 spent


def test_poison_slot_hits_one_row_in_place():
    jc, tc, _, _ = setup_pair("hybrid")
    cache = lm.init_lm_cache(tc, 3, 32, device="cpu")
    ptrs = [t.data_ptr() for t in tree_leaves(cache)]
    assert poison_slot(cache, 1) is cache
    assert [t.data_ptr() for t in tree_leaves(cache)] == ptrs
    for leaf in tree_leaves(cache["segments"]):
        assert bool(torch.isnan(leaf[:, 1].float()).all())
        assert bool(torch.isfinite(leaf[:, 0].float()).all())
        assert bool(torch.isfinite(leaf[:, 2].float()).all())
    assert cache["pos"].tolist() == [0, 0, 0]


def test_submit_rejects_bad_prompts():
    _, tc, _, tp = setup_pair("hybrid")
    eng = ServingEngine(tc, tp, slots=1, max_seq=32, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        eng.submit(Request(rid=0, prompt=np.array([1, tc.vocab_size],
                                                  np.int32), max_new=2))
    with pytest.raises(ValueError, match="vocab"):
        eng.submit(Request(rid=1, prompt=np.array([-1, 2], np.int32),
                           max_new=2))
    with pytest.raises(ValueError, match="integer"):
        eng.submit(Request(rid=2, prompt=np.array([1.5, 2.0]), max_new=2))
    with pytest.raises(ValueError, match="empty"):
        eng.submit(Request(rid=3, prompt=np.array([], np.int32), max_new=2))
    assert not eng.queue


# ------------------------------------------------------ the fault matrix

# case -> (spec, engine arguments): rid0 (9 tokens, two chunks) emits at
# iteration 1 into slot 0 and decodes through iteration 2
MATRIX = {
    "replay": ("nan_decode@iter=2:slot=0", dict(checkpoint_every=2)),
    "no_checkpoint": ("nan_decode@iter=2:slot=0", dict(checkpoint_every=0)),
    "prefill_nan": ("nan_prefill@chunk=0:row=0", {}),
}


@pytest.mark.parametrize("case", sorted(MATRIX))
@pytest.mark.parametrize("arch", ARCHS)
def test_fault_matrix_equals_reference(arch, case, fp32_caches):
    spec, kw = MATRIX[case]
    reqs = matrix_reqs(arch)
    teng, _ = run_both(arch, reqs, spec=spec, **kw)
    done = {r.rid: r for r in teng.finished}
    clean = ServingEngine(*setup_pair(arch)[1::2], device="cpu", **ENG_KW)
    for rid, p, n, _ in reqs:
        clean.submit(Request(rid=rid, prompt=p, max_new=n))
    ref = {r.rid: r.out for r in clean.run()}
    if case == "replay":
        assert teng.stats["divergences"] == teng.stats["replays"] == 1
        assert {r: d.out for r, d in done.items()} == ref
        assert all(d.status == "ok" for d in done.values())
    elif case == "no_checkpoint":
        (victim,) = [d for d in done.values() if d.status == "failed"]
        assert isinstance(victim.error, DivergenceDetected)
        assert all(d.out == ref[r] for r, d in done.items()
                   if d.status == "ok")
    else:
        assert done[0].status == "failed" and not done[0].out
        assert isinstance(done[0].error, DivergenceDetected)
        assert done[1].status == "ok" and done[1].out == ref[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_corrupt_preemption_blob_fails_only_victim(arch, fp32_caches):
    """slots=1 forces preemption of rid 0; its offload blob is
    bit-flipped, so its restore fails it with CacheCorruption (the same
    key named as the reference's) and rid 1 finishes."""
    teng, _ = run_both(arch, matrix_reqs(arch, max_new=12),
                       spec="corrupt_blob@rid=r0", seed=5, slots=1,
                       preempt_after=2, checkpoint_every=0)
    done = {r.rid: r for r in teng.finished}
    assert teng.stats["preemptions"] >= 1
    assert done[0].status == "failed"
    assert isinstance(done[0].error, CacheCorruption)
    assert done[1].status == "ok"


def test_watchdog_trips_on_frozen_prefill(fp32_caches):
    teng, _ = run_both("hybrid", matrix_reqs("hybrid"), spec="stall@iter=0",
                       stall_after=4)
    assert teng.stats["watchdog_trips"] >= 1
    for r in teng.finished:
        assert r.status == "failed"
        assert isinstance(r.error, SlotStalled)
        assert "no progress" in str(r.error)


def test_run_max_iters_escape_hatch(fp32_caches):
    teng, _ = run_both("hybrid", matrix_reqs("hybrid"), spec="stall@iter=0",
                       stall_after=10 ** 6)
    assert teng.stats["iters"] <= 201
    for r in teng.finished:
        assert r.status == "cancelled"
        assert isinstance(r.error, SlotStalled)
        assert "max_iters" in str(r.error)


def test_preemption_picks_slackest_slot(fp32_caches):
    """The deadline-less live slot (infinite slack) is the victim, not the
    slot under a deadline; both engines agree."""
    _, tc, _, _ = setup_pair("hybrid")
    p = prompts_for(tc.vocab_size, lens=(6, 6, 6))
    reqs = [(0, p[0], 6, {"deadline_ms": 600_000.0}), (1, p[1], 24, {}),
            (2, p[2], 4, {})]
    teng, _ = run_both("hybrid", reqs, max_seq=64, decode_block=2,
                       preempt_after=1)
    done = {r.rid: r for r in teng.finished}
    assert all(r.status == "ok" for r in done.values())
    assert done[0].preemptions == 0 and done[1].preemptions >= 1


# ----------------------------------------------- deadlines (engine clock)

def _engine(arch="hybrid", **kw):
    _, tc, _, tp = setup_pair(arch)
    return tc, ServingEngine(tc, tp, device="cpu", **kw)


def test_deadline_expires_while_queued():
    clock = FakeClock()
    tc, eng = _engine(slots=1, max_seq=48, decode_block=4, clock=clock)
    p0, p1 = prompts_for(tc.vocab_size)
    eng.submit(Request(rid=0, prompt=p0, max_new=4))
    eng.submit(Request(rid=1, prompt=p1, max_new=4, deadline_ms=5.0))
    clock.advance_ms(10)
    done = {r.rid: r for r in eng.run(max_iters=100)}
    assert done[0].status == "ok"
    assert done[1].status == "timed_out" and not done[1].out
    assert isinstance(done[1].error, DeadlineExceeded)
    assert "while queued" in str(done[1].error)
    assert eng.stats["timeouts"] == 1


def test_deadline_expires_mid_prefill():
    """A long prompt in 8-token chunks under a clock that ticks 1 ms a
    read: its TTL runs out between chunks, its row is cancelled, and the
    short co-batched request finishes."""
    tc, eng = _engine(slots=2, max_seq=64, decode_block=4, chunk_size=8,
                      clock=FakeClock(tick_ms=1.0))
    short, long_ = prompts_for(tc.vocab_size, lens=(6, 40))
    eng.submit(Request(rid=0, prompt=short, max_new=4))
    eng.submit(Request(rid=1, prompt=long_, max_new=4, deadline_ms=12.0))
    done = {r.rid: r for r in eng.run(max_iters=100)}
    assert done[0].status == "ok" and len(done[0].out) == 4
    assert done[1].status == "timed_out" and not done[1].out
    assert "mid-prefill" in str(done[1].error)
    assert not eng._pending and not eng._chunked_prefill.active


def test_deadline_expires_mid_decode():
    tc, eng = _engine(slots=1, max_seq=256, decode_block=4,
                      checkpoint_every=0, clock=FakeClock(tick_ms=1.0))
    eng.submit(Request(rid=0, prompt=prompts_for(tc.vocab_size)[0],
                       max_new=200, deadline_ms=40.0))
    (req,) = eng.run(max_iters=300)
    assert req.status == "timed_out"
    assert isinstance(req.error, DeadlineExceeded)
    assert req.out and len(req.out) < 200


def test_deadline_admission_reject_uses_latency_model():
    tc, eng = _engine(slots=1, max_seq=48, decode_block=4,
                      clock=FakeClock())
    eng.telemetry.record_latency("decode", None, 50.0)
    p0, p1 = prompts_for(tc.vocab_size)
    eng.submit(Request(rid=0, prompt=p0, max_new=8, deadline_ms=10.0))
    eng.submit(Request(rid=1, prompt=p1, max_new=8))
    done = {r.rid: r for r in eng.run(max_iters=100)}
    assert done[0].status == "cancelled"
    assert "admission reject" in str(done[0].error)
    assert done[1].status == "ok"


def test_error_hierarchy_and_rid_prefix():
    for exc in (DeadlineExceeded, DivergenceDetected, SlotStalled,
                CacheCorruption):
        assert issubclass(exc, RequestError)
    e = CacheCorruption("bad payload", rid=3, key="segments/0/k")
    assert str(e).startswith("rid=3: ")
    assert "segments/0/k" in str(e)
    assert str(DivergenceDetected("nan burst")) == "nan burst"
