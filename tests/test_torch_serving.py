"""The port's serving path against the reference's, on the CPU.

reduced(mamba2-2.7b) in fp32 compute with the reference's params carried
across: the port's ``ServingEngine`` and ``greedy_generate`` must emit
exactly the token streams the reference's do, with late-admitted slots
(5 requests through 2 slots) decoding at their own positions.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_2p7b as J_CFG
from repro.configs import reduced as j_reduced
from repro.models.lm import init_lm_params as j_init
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.engine import greedy_generate as j_greedy
from repro_torch.configs import mamba2_2p7b as T_CFG
from repro_torch.configs import reduced
from repro_torch.convert import from_jax
from repro_torch.serving.engine import Request, ServingEngine, greedy_generate


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(j_reduced(J_CFG), compute_dtype="float32")
    tcfg = dataclasses.replace(reduced(T_CFG), compute_dtype="float32")
    jp = j_init(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                    "cpu")


def _prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, int(n)).astype(np.int32) for n in lens]


def test_engine_streams_match_reference_engine(model):
    """5 requests through 2 slots: the last three are admitted mid-flight
    at positions different from the resident slots.  Per-request streams
    equal the reference engine's and a batch-1 greedy_generate's."""
    jcfg, tcfg, jp, tp = model
    prompts = _prompts(tcfg.vocab_size, (9, 17, 12, 9, 23))
    kw = dict(slots=2, max_seq=64, decode_block=4)
    jeng = JEngine(jcfg, jp, **kw)
    teng = ServingEngine(tcfg, tp, device="cpu", **kw)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=p, max_new=10))
        teng.submit(Request(rid=i, prompt=p, max_new=10))
    j_out = {r.rid: r.out for r in jeng.run()}
    t_done = teng.run()
    assert [r.status for r in t_done] == ["ok"] * len(prompts)
    t_out = {r.rid: r.out for r in t_done}
    assert t_out == j_out
    for i in (0, 4):
        solo, _ = greedy_generate(tcfg, tp,
                                  {"tokens": torch.from_numpy(prompts[i][None])},
                                  max_seq=64, gen_len=10, device="cpu")
        assert t_out[i] == solo[0].tolist()


def test_greedy_generate_matches_reference(model):
    jcfg, tcfg, jp, tp = model
    toks = np.stack(_prompts(tcfg.vocab_size, (11, 11), seed=5))
    j_toks, _ = j_greedy(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_seq=32,
                         gen_len=7)
    t_toks, cache = greedy_generate(tcfg, tp,
                                    {"tokens": torch.from_numpy(toks)},
                                    max_seq=32, gen_len=7, device="cpu")
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    assert cache["pos"].tolist() == [17, 17]


def test_stop_rules_and_interleave(model):
    """decode_block > max_new never over-emits; a prompt at max_seq-2 stops
    at max_seq-1 (the reference's room rule); prefill chunks interleave
    with decode bursts; TTFT stamps come from the injected clock."""
    _, tcfg, _, tp = model
    ticks = itertools.count()
    eng = ServingEngine(tcfg, tp, slots=2, max_seq=24, decode_block=8,
                        chunk_size=8, clock=lambda: float(next(ticks)),
                        device="cpu")
    short, long_ = _prompts(tcfg.vocab_size, (6, 22), seed=7)
    eng.submit(Request(rid=0, prompt=short, max_new=3))
    eng.submit(Request(rid=1, prompt=long_, max_new=50))
    done = {r.rid: r for r in eng.run()}
    assert len(done[0].out) == 3
    # 22 prompt rows + 1 decoded row reach max_seq - 1
    assert len(done[1].out) == 24 - 1 - 22 + 1
    assert all(r.status == "ok" and r.first_t is not None
               and r.first_t > r.submit_t for r in done.values())
    assert eng.stats["prefill_chunks"] == 3      # 22 tokens in chunks of 8
    with pytest.raises(ValueError):
        eng.submit(Request(rid=2, prompt=np.zeros(0, np.int32), max_new=1))
    with pytest.raises(ValueError):
        eng.submit(Request(rid=3, prompt=np.zeros(23, np.int32), max_new=1))
    with pytest.raises(ValueError):
        eng.submit(Request(rid=4, prompt=np.array([tcfg.vocab_size]),
                           max_new=1))


def test_admission_reuses_templates(model, monkeypatch):
    """Group cache templates are allocated once per batch size {1, slots},
    however many requests flow through."""
    import repro_torch.serving.prefill as prefill_mod
    _, tcfg, _, tp = model
    calls = []
    real = prefill_mod.init_lm_cache
    monkeypatch.setattr(prefill_mod, "init_lm_cache",
                        lambda *a, **kw: (calls.append(a), real(*a, **kw))[1])
    eng = ServingEngine(tcfg, tp, slots=2, max_seq=48, decode_block=4,
                        device="cpu")
    for i, p in enumerate(_prompts(tcfg.vocab_size, [8] * 6, seed=0)):
        eng.submit(Request(rid=i, prompt=p, max_new=4))
    assert len(eng.run()) == 6
    assert len(calls) <= 2
