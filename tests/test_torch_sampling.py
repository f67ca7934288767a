"""Temperature sampling in ``decode_tokens``, on the CPU.

The reference draws with ``jax.random.categorical`` from an ``rng`` key;
the port draws the same Gumbel-max sample from a ``torch.Generator``
(``models.lm._select``).  The two streams differ, so the tests hold both
to the distribution, and the port's sampled bursts to the reference's
model:

* ``temperature=0`` is bit for bit the default call and draws nothing;
  ``temperature > 0`` without a generator raises, as the reference does;
  the engine, ``greedy_generate`` and the graph runner take no
  temperature.
* One seed gives one burst, two seeds differ; no token reaches the padded
  vocab columns even where those hold the largest logits.
* A chi-square test over 20000 draws on fixed logits, of the port's
  selection and of the reference's ``jax.random.categorical``, against
  ``softmax(lg / T)``.
* A sampled burst on reduced mamba2-2.7b and zamba2-2.7b (fp32 compute
  and caches, the reference's params carried across by ``from_jax``):
  its tokens fed one by one through the reference's ``lm_decode_step``
  give the port's logits (each step's token is the Gumbel-max of those
  logits under the same generator) and final cache within 1e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.configs import mamba2_2p7b as J_MAMBA2
from repro.configs import reduced as j_reduced
from repro.configs import zamba2_2p7b as J_ZAMBA
from repro.models import lm as jlm
from repro_torch.configs import mamba2_2p7b as T_MAMBA2
from repro_torch.configs import reduced
from repro_torch.configs import zamba2_2p7b as T_ZAMBA
from repro_torch.convert import from_jax
from repro_torch.models import lm
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.serving import graphs
from repro_torch.serving.engine import ServingEngine, greedy_generate

ARCHS = {"mamba2": (J_MAMBA2, T_MAMBA2), "hybrid": (J_ZAMBA, T_ZAMBA)}
B, PROMPT, MAX_SEQ, N, T = 2, 11, 32, 6, 0.8
TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    """``models(arch)``: (jcfg, tcfg, jp, tp, j_cache, t_cache, first), both
    sides prefilled with one ``B`` x ``PROMPT`` prompt on fp32 caches
    (built once; callers clone ``t_cache`` before they decode on it)."""
    built = {}

    def get(arch):
        if arch not in built:
            jbase, tbase = ARCHS[arch]
            jcfg = dataclasses.replace(j_reduced(jbase, vocab=250),
                                       compute_dtype="float32")
            tcfg = dataclasses.replace(reduced(tbase, vocab=250),
                                       compute_dtype="float32")
            jp = jlm.init_lm_params(jcfg, jax.random.PRNGKey(0))
            tp = lm.prepare_params(tcfg, from_jax(
                jax.tree_util.tree_map(np.asarray, jp), "cpu"))
            toks = np.random.default_rng(5).integers(
                0, tcfg.vocab_size, (B, PROMPT)).astype(np.int32)
            _, j_cache = jax.jit(functools.partial(jlm.lm_prefill, jcfg))(
                jp, {"tokens": jnp.asarray(toks)},
                jlm.init_lm_cache(jcfg, B, MAX_SEQ, dtype=jnp.float32))
            t_lg, t_cache = lm.lm_prefill(
                tcfg, tp, torch.from_numpy(toks),
                lm.init_lm_cache(tcfg, B, MAX_SEQ, dtype=torch.float32,
                                 device="cpu"))
            first = torch.argmax(t_lg[..., :tcfg.vocab_size],
                                 -1).to(torch.int32)
            built[arch] = (jcfg, tcfg, jp, tp, j_cache, t_cache, first)
        return built[arch]
    return get


def _clone(cache):
    return {"segments": tree_map(torch.clone, cache["segments"]),
            "pos": cache["pos"].clone()}


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


def _close(got, want, tol):
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    err = float(np.abs(g - w).max())
    assert err <= tol * max(1.0, float(np.abs(w).max())), err


def _close_cache(t_segs, j_segs, tol):
    """Both caches walked by key (the reference's trees sort dict keys)."""
    def walk(t, j):
        assert set(t) == set(j)
        for key in t:
            if isinstance(t[key], dict):
                walk(t[key], j[key])
            else:
                np.testing.assert_allclose(
                    t[key].float().numpy(), np.asarray(j[key], np.float32),
                    rtol=tol, atol=tol, err_msg=key)
    assert len(t_segs) == len(j_segs)
    for ts, js in zip(t_segs, j_segs):
        assert len(ts) == len(js)
        for t, j in zip(ts, js):
            walk(t, j)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_temperature_zero_is_the_greedy_call_bit_for_bit(arch, models):
    _, tcfg, _, tp, _, t_cache, first = models(arch)
    want_toks, want, want_ok = lm.decode_tokens(
        tcfg, tp, _clone(t_cache), first, N, with_sentinel=True)
    gen = _gen(3)
    state = gen.get_state()
    got_toks, got, got_ok = lm.decode_tokens(
        tcfg, tp, _clone(t_cache), first, N, with_sentinel=True,
        temperature=0.0, generator=gen)
    assert torch.equal(got_toks, want_toks) and torch.equal(got_ok, want_ok)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(want)))
    assert torch.equal(gen.get_state(), state)        # nothing drawn


def test_sampling_needs_a_generator(models):
    _, tcfg, _, tp, _, t_cache, first = models("mamba2")
    with pytest.raises(ValueError, match="requires a generator"):
        lm.decode_tokens(tcfg, tp, _clone(t_cache), first, 2,
                         temperature=0.8)
    # the reference raises alike without its rng key
    jcfg, _, jp, *_ = models("mamba2")
    j_cache = jlm.init_lm_cache(jcfg, B, MAX_SEQ, dtype=jnp.float32)
    with pytest.raises(ValueError, match="rng"):
        jlm.decode_tokens(jcfg, jp, j_cache,
                          jnp.zeros((B, 1), jnp.int32), 2, temperature=0.8)


def test_greedy_entry_points_take_no_temperature(models):
    """As in the reference, only ``decode_tokens`` samples: the engine,
    ``greedy_generate`` and the decode graph runner refuse the keyword."""
    _, tcfg, _, tp, _, t_cache, first = models("mamba2")
    with pytest.raises(TypeError):
        ServingEngine(tcfg, tp, slots=1, max_seq=16, device="cpu",
                      temperature=0.8)
    with pytest.raises(TypeError):
        greedy_generate(tcfg, tp, {"tokens": first}, max_seq=16, gen_len=2,
                        device="cpu", temperature=0.8)
    with pytest.raises(TypeError):
        graphs.make_decode_tokens(tcfg)(tp, _clone(t_cache), first, 2,
                                        temperature=0.8)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_one_seed_one_burst_two_seeds_differ(arch, models):
    _, tcfg, _, tp, _, t_cache, first = models(arch)

    def burst(seed):
        toks, _ = lm.decode_tokens(tcfg, tp, _clone(t_cache), first, N,
                                   temperature=1.0, generator=_gen(seed))
        return toks
    a, b, c = burst(11), burst(11), burst(12)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert 0 <= int(a.min()) and int(a.max()) < tcfg.vocab_size


def test_padded_vocab_columns_are_never_drawn(models, monkeypatch):
    """The head's padded columns set to the largest logits: selection
    reads only the first ``vocab_size`` columns."""
    _, tcfg, _, tp, _, t_cache, first = models("hybrid")
    assert tcfg.padded_vocab > tcfg.vocab_size
    head = lm._head

    def loud_pad(cfg, params, x):
        logits = head(cfg, params, x).clone()
        logits[..., cfg.vocab_size:] = 1e4
        return logits
    monkeypatch.setattr(lm, "_head", loud_pad)
    for temperature in (0.0, 0.8, 50.0):
        toks, _ = lm.decode_tokens(tcfg, tp, _clone(t_cache), first, N,
                                   temperature=temperature,
                                   generator=_gen(4))
        assert int(toks.max()) < tcfg.vocab_size


DRAWS = 20000
LOGITS = np.array([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.5, -3.0], np.float32)


def _chi_square_p(draws, temperature):
    lg = LOGITS.astype(np.float64) / temperature
    p = np.exp(lg - lg.max())
    p /= p.sum()
    counts = np.bincount(np.asarray(draws), minlength=len(LOGITS))
    return stats.chisquare(counts, DRAWS * p).pvalue


@pytest.mark.parametrize("temperature", [0.7, 1.0, 2.5])
def test_chi_square_port_and_reference_against_softmax(temperature):
    lg = torch.from_numpy(np.tile(LOGITS, (DRAWS, 1)))
    port = lm._select(lg, temperature, _gen(0))[:, 0].numpy()
    ref = jax.random.categorical(jax.random.PRNGKey(0),
                                 jnp.asarray(LOGITS) / temperature,
                                 shape=(DRAWS,))
    # both Gumbel-max samplers from softmax(lg / T): a p-value this low
    # comes once in 10^4 runs of a right sampler; a wrong temperature
    # (T^2 in place of T, or none) gives ~0
    assert _chi_square_p(port, temperature) > 1e-4
    assert _chi_square_p(ref, temperature) > 1e-4
    if temperature != 1.0:
        assert _chi_square_p(port, temperature ** 2) < 1e-6


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sampled_burst_replays_through_the_reference(arch, models):
    """The port's sampled tokens, fed one by one through the reference's
    ``lm_decode_step``: the port's logits step for step and its final
    cache within 1e-4; each token is the Gumbel-max of the port's logits
    under the same generator's draws."""
    jcfg, tcfg, jp, tp, j_cache, t_cache, first = models(arch)
    toks, cache = lm.decode_tokens(tcfg, tp, _clone(t_cache), first, N,
                                   temperature=T, generator=_gen(9))
    replay = _gen(9)
    j_step = jax.jit(functools.partial(jlm.lm_decode_step, jcfg))
    tok, t_c, j_tok = first, _clone(t_cache), jnp.asarray(first.numpy())
    for i in range(N):
        t_lg, t_c = lm.lm_decode_step(tcfg, tp, tok, t_c)
        j_lg, j_cache = j_step(jp, j_tok, j_cache)
        _close(t_lg[..., :tcfg.vocab_size], j_lg[..., :jcfg.vocab_size],
               TOL)
        drawn = lm._select(t_lg[:, 0, :tcfg.vocab_size], T, replay)
        assert torch.equal(drawn[:, 0], toks[:, i]), i
        tok = toks[:, i:i + 1]
        j_tok = jnp.asarray(tok.numpy())
    assert cache["pos"].tolist() == np.asarray(j_cache["pos"]).tolist()
    _close_cache(cache["segments"], j_cache["segments"], TOL)
