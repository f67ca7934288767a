"""The decode burst's sentinel, state destinations and runner, on the CPU.

Reduced mamba2-2.7b, zamba2-2.7b (``mamba2+shared``), llama3-8b
(``dense``), mamba-130m (``mamba1``) and gemma3-1b (``local`` rings and
global layers), vocab 250 so the padded-vocab mask is live, fp32 compute
and fp32 caches on both sides (the reference's fp32 burst cannot carry a
bf16 Mamba-1 conv window, and reduced gemma3-1b's greedy steps sit on
near-ties; ROADMAP.md §3), the reference's params carried across by
``from_jax``.

* ``decode_tokens(..., with_sentinel=True)`` against the reference's:
  tokens equal and ``ok`` all True on a finite cache; with one row's
  first SSM state (or its first layer's K rows) set to NaN, ``ok`` equal
  to the reference's row for row, and the finite row's tokens equal.
* A burst with the spare state set (``_spare_states``) against the
  default path: tokens, ``ok``, ``pos`` and every cache leaf bit for bit,
  for even and odd ``n``, and the state leaves end at the cache's own
  addresses.
* ``make_decode_tokens(cfg)`` on a CPU cache is ``decode_tokens``; the
  engine keeps its cache's state leaves where they are across bursts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_1b as J_GEMMA
from repro.configs import llama3_8b as J_LLAMA
from repro.configs import mamba2_2p7b as J_MAMBA2
from repro.configs import reduced as j_reduced
from repro.configs import zamba2_2p7b as J_ZAMBA
from repro.configs.paper_models import MAMBA1_130M as J_MAMBA1
from repro.models import lm as jlm
from repro_torch.configs import gemma3_1b as T_GEMMA
from repro_torch.configs import llama3_8b as T_LLAMA
from repro_torch.configs import mamba2_2p7b as T_MAMBA2
from repro_torch.configs import mamba_130m as T_MAMBA1
from repro_torch.configs import reduced
from repro_torch.configs import zamba2_2p7b as T_ZAMBA
from repro_torch.convert import from_jax
from repro_torch.models import lm
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.serving import graphs
from repro_torch.serving.engine import Request, ServingEngine

ARCHS = {"mamba2": (J_MAMBA2, T_MAMBA2), "hybrid": (J_ZAMBA, T_ZAMBA),
         "dense": (J_LLAMA, T_LLAMA), "mamba1": (J_MAMBA1, T_MAMBA1),
         "local": (J_GEMMA, T_GEMMA)}
B, PROMPT, MAX_SEQ, N = 2, 11, 32, 5


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(arch):
        if arch not in built:
            jbase, tbase = ARCHS[arch]
            jcfg = dataclasses.replace(j_reduced(jbase, vocab=250),
                                       compute_dtype="float32")
            tcfg = dataclasses.replace(reduced(tbase, vocab=250),
                                       compute_dtype="float32")
            jp = jlm.init_lm_params(jcfg, jax.random.PRNGKey(0))
            tp = from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
            built[arch] = (jcfg, tcfg, jp, lm.prepare_params(tcfg, tp))
        return built[arch]
    return get


def _prefilled(arch, models):
    """Both sides prefilled with the same ``B`` x ``PROMPT`` prompt on fp32
    caches: (jcfg, tcfg, jp, tp, j_cache, t_cache, j_first, t_first)."""
    jcfg, tcfg, jp, tp = models(arch)
    toks = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    j_lg, j_cache = jlm.lm_prefill(
        jcfg, jp, {"tokens": jnp.asarray(toks)},
        jlm.init_lm_cache(jcfg, B, MAX_SEQ, dtype=jnp.float32))
    t_lg, t_cache = lm.lm_prefill(
        tcfg, tp, torch.from_numpy(toks),
        lm.init_lm_cache(tcfg, B, MAX_SEQ, dtype=torch.float32,
                         device="cpu"))
    j_first = jnp.argmax(j_lg[..., :jcfg.vocab_size], -1).astype(jnp.int32)
    t_first = torch.argmax(t_lg[..., :tcfg.vocab_size], -1).to(torch.int32)
    assert np.array_equal(np.asarray(j_first), t_first.numpy())
    return jcfg, tcfg, jp, tp, j_cache, t_cache, j_first, t_first


def _clone(cache):
    return {"segments": tree_map(torch.clone, cache["segments"]),
            "pos": cache["pos"].clone()}


def _poison(arch, j_cache, t_cache, row):
    """NaN into batch row ``row`` of the first layer's SSM state (or, for
    the attention-only kinds, its K rows), on both sides alike."""
    key = "k" if arch in ("dense", "local") else "ssm"
    t_cache["segments"][0][0][key][0, row] = float("nan")
    seg = list(j_cache["segments"])
    layer = dict(seg[0][0])
    layer[key] = layer[key].at[0, row].set(jnp.nan)
    seg[0] = (layer,) + tuple(seg[0][1:])
    return dict(j_cache, segments=seg)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sentinel_matches_reference_on_finite_cache(arch, models):
    jcfg, tcfg, jp, tp, j_cache, t_cache, j_first, t_first = _prefilled(
        arch, models)
    toks, cache, ok = lm.decode_tokens(tcfg, tp, t_cache, t_first, N,
                                       with_sentinel=True)
    j_toks, _, j_ok = jlm.decode_tokens(jcfg, jp, j_cache, j_first, N,
                                        with_sentinel=True)
    np.testing.assert_array_equal(np.asarray(j_toks), toks.numpy())
    assert ok.dtype == torch.bool and ok.shape == (B,)
    assert ok.tolist() == np.asarray(j_ok).tolist() == [True] * B
    assert cache["pos"].tolist() == [PROMPT + N] * B


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sentinel_flags_the_nonfinite_row_as_the_reference(arch, models):
    jcfg, tcfg, jp, tp, j_cache, t_cache, j_first, t_first = _prefilled(
        arch, models)
    j_cache = _poison(arch, j_cache, t_cache, row=1)
    toks, _, ok = lm.decode_tokens(tcfg, tp, t_cache, t_first, N,
                                   with_sentinel=True)
    j_toks, _, j_ok = jlm.decode_tokens(jcfg, jp, j_cache, j_first, N,
                                        with_sentinel=True)
    assert ok.tolist() == np.asarray(j_ok).tolist() == [True, False]
    np.testing.assert_array_equal(np.asarray(j_toks)[0], toks[0].numpy())


@pytest.mark.parametrize("n", [4, 5])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_spare_states_burst_is_bit_identical_in_place(arch, n, models):
    _, tcfg, _, tp, _, t_cache, _, t_first = _prefilled(arch, models)
    want_toks, want, want_ok = lm.decode_tokens(
        tcfg, tp, _clone(t_cache), t_first, n, kv_bucket=24,
        with_sentinel=True)
    cache = _clone(t_cache)
    own = [t.data_ptr() for t in tree_leaves(cache["segments"])]
    spare = lm.init_spare_states(cache)
    assert all(t.data_ptr() not in own for t in tree_leaves(spare))
    toks, got, ok = lm.decode_tokens(tcfg, tp, cache, t_first, n,
                                     kv_bucket=24, with_sentinel=True,
                                     _spare_states=spare)
    assert torch.equal(toks, want_toks) and torch.equal(ok, want_ok)
    assert torch.equal(got["pos"], want["pos"])
    assert [t.data_ptr() for t in tree_leaves(got["segments"])] == own
    for a, b in zip(tree_leaves(got["segments"]),
                    tree_leaves(want["segments"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_make_decode_tokens_on_cpu_is_decode_tokens(arch, models):
    _, tcfg, _, tp, _, t_cache, _, t_first = _prefilled(arch, models)
    decode_n = graphs.make_decode_tokens(tcfg)
    for sentinel in (False, True):
        want = lm.decode_tokens(tcfg, tp, _clone(t_cache), t_first, N,
                                kv_bucket=16, rope_len=MAX_SEQ,
                                with_sentinel=sentinel)
        cache = _clone(t_cache)
        for spare in (None, lm.init_spare_states(cache)):
            got = decode_n(tp, _clone(cache), t_first, N, kv_bucket=16,
                           rope_len=MAX_SEQ, with_sentinel=sentinel,
                           spare=spare)
            assert len(got) == len(want) == 2 + sentinel
            for a, b in zip(tree_leaves(got), tree_leaves(want)):
                assert torch.equal(a, b)
    assert decode_n.captures == decode_n.replays == 0


@pytest.mark.parametrize("arch", ["mamba2", "hybrid", "mamba1"])
def test_engine_keeps_state_leaves_in_place(arch, models):
    """Ragged requests through 2 slots with odd and even bursts: the
    engine's state leaves keep their addresses and every request ends
    ``ok``."""
    _, tcfg, _, tp = models(arch)
    rng = np.random.default_rng(7)
    eng = ServingEngine(tcfg, tp, slots=2, max_seq=48, decode_block=3,
                        chunk_size=8, device="cpu")
    own = [t.data_ptr() for t in tree_leaves(eng.cache["segments"])]
    for i, n in enumerate((9, 14, 5)):
        eng.submit(Request(rid=i, prompt=rng.integers(2, 250, n),
                           max_new=7))
    done = eng.run()
    assert [r.status for r in done] == ["ok"] * 3
    assert [len(r.out) for r in done] == [7] * 3
    assert [t.data_ptr() for t in tree_leaves(eng.cache["segments"])] == own
