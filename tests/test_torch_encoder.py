"""Encoder layers and the audio and vision frontends against the
reference, on the CPU.

* reduced(hubert-xlarge) (2 bidirectional ``encoder`` layers, 4 heads of
  16, gelu, an audio frontend of 32-d frame features): ``lm_forward``
  and ``make_encode_step`` against the reference's (``train=False``),
  logits of every frame; attention reaches later frames; the encoder
  refusals (``kv_bucket``, ``ServingEngine``) as the reference words
  them; ``operator_costs`` class FLOPs of the forward.
* reduced(llava-next-mistral-7b) (2 ``dense`` layers, a vision frontend
  of 32-d patch features): ``lm_prefill`` with 5 features before an
  11-token prompt (decoding starts at 16), ``lm_forward`` with them,
  ``greedy_generate`` with them, and token-only serving through the
  engine against the reference engine's streams.
* Param trees (``frontend_proj``), ``prepare_params``'s cast of it, and
  ``supports_chunked_prefill`` of every registered config against the
  reference's.

Both models in fp32 with seeded params of the port's initializer on both
sides.  Tolerances: 1e-4 of max(1, max |reference|) on logits and cache
leaves (fp32), greedy tokens equal.  The reference's calls run under
``jax.jit``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.serving.engine as j_engine_mod
import repro.serving.prefill as j_prefill_mod
import repro_torch.configs as tconfigs
import repro_torch.serving.engine as t_engine_mod
import repro_torch.serving.prefill as t_prefill_mod
from repro.core import registry as jregistry
from repro.models import lm as jlm
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.engine import greedy_generate as j_greedy
from repro.serving.engine import make_encode_step as j_make_encode_step
from repro.serving.prefill import supports_chunked_prefill as j_supports
from repro.serving.telemetry import operator_costs as j_operator_costs
from repro_torch.convert import from_jax, to_numpy
from repro_torch.core import registry as tregistry
from repro_torch.models import lm
from repro_torch.models.params import tree_leaves
from repro_torch.serving.engine import (Request, ServingEngine,
                                        greedy_generate, make_encode_step)
from repro_torch.serving.prefill import supports_chunked_prefill
from repro_torch.serving.telemetry import operator_costs

TOL = 1e-4
MODELS = {"hubert": "hubert-xlarge", "llava": "llava-next-mistral-7b"}
B, FRAMES, PATCHES, PROMPT, MS = 2, 13, 5, 11, 48

_JITTED = {}


def _jit(fn, *bound, **static):
    key = (fn, tuple(id(b) for b in bound), tuple(sorted(static.items())))
    if key not in _JITTED:
        _JITTED[key] = jax.jit(functools.partial(fn, *bound, **static))
    return _JITTED[key]


def _close(got, want, tol=TOL):
    g, w = to_numpy(got), np.asarray(want, np.float32)
    assert g.shape == w.shape
    err = float(np.abs(g - w).max())
    assert err <= tol * max(1.0, float(np.abs(w).max())), err


def _build(arch):
    """reduced(``arch``) in fp32 on both sides, and seeded params from the
    port's initializer (the reference's distributions) carried into the
    reference's tree, whose structure, shapes and dtypes
    ``jax.eval_shape`` of its initializer gives (tracing its initializer
    compiles nothing)."""
    jcfg = dataclasses.replace(jconfigs.reduced(
        jregistry.get(arch), vocab=250), compute_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.reduced(
        tregistry.get(arch), vocab=250), compute_dtype="float32")
    tp = lm.init_lm_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, to_numpy(tp))
    want = jax.eval_shape(lambda k: jlm.init_lm_params(jcfg, k),
                          jax.random.PRNGKey(0))
    assert (jax.tree_util.tree_structure(jp)
            == jax.tree_util.tree_structure(want))
    for got, w in zip(jax.tree_util.tree_leaves(jp),
                      jax.tree_util.tree_leaves(want)):
        assert (got.shape, got.dtype) == (w.shape, w.dtype)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(name):
        if name not in built:
            built[name] = _build(MODELS[name])
        return built[name]
    return get


def _features(b, n, f, seed):
    return np.random.default_rng(seed).standard_normal((b, n, f)).astype(
        np.float32)


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("name", list(MODELS))
def test_param_trees_carry_the_frontend(name, models):
    """``frontend_proj`` ([F, D]) in the reference's tree, carried across
    by ``from_jax``; ``prepare_params`` casts it to the compute dtype."""
    jcfg, tcfg, jp, tp = models(name)
    shapes = jax.eval_shape(lambda k: jlm.init_lm_params(jcfg, k),
                            jax.random.PRNGKey(0))
    carried = from_jax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), "cpu")
    assert (jax.tree_util.tree_structure(to_numpy(carried))
            == jax.tree_util.tree_structure(to_numpy(tp)))
    assert carried["frontend_proj"].shape == tp["frontend_proj"].shape
    assert tuple(tp["frontend_proj"].shape) == (
        tcfg.frontend_feature_dim, tcfg.d_model)
    cfg = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    assert lm.prepare_params(cfg, tp)["frontend_proj"].dtype == \
        torch.bfloat16


# ----------------------------------------------------------------- hubert

def test_encoder_forward_matches_reference(models):
    """Audio frames through 2 bidirectional layers: every frame's logits,
    by ``lm_forward`` and by ``make_encode_step`` on both sides."""
    jcfg, tcfg, jp, tp = models("hubert")
    feats = _features(B, FRAMES, tcfg.frontend_feature_dim, seed=1)
    want = _jit(jlm.lm_forward, jcfg, train=False)(
        jp, {"features": jnp.asarray(feats)})
    got = lm.lm_forward(tcfg, tp, features=torch.from_numpy(feats))
    assert got.shape == (B, FRAMES, tcfg.padded_vocab)
    _close(got, want)
    j_step = jax.jit(j_make_encode_step(jcfg))
    t_step = make_encode_step(tcfg, device="cpu")
    _close(t_step(tp, {"features": torch.from_numpy(feats)}),
           j_step(jp, {"features": jnp.asarray(feats)}))


def test_encoder_attends_later_frames(models):
    """Changing the last frame changes the first frame's logits (no causal
    mask), as on the reference."""
    jcfg, tcfg, jp, tp = models("hubert")
    feats = _features(B, FRAMES, tcfg.frontend_feature_dim, seed=2)
    moved = feats.copy()
    moved[:, -1] += 1.0
    a = lm.lm_forward(tcfg, tp, features=torch.from_numpy(feats))
    b = lm.lm_forward(tcfg, tp, features=torch.from_numpy(moved))
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-3
    want = _jit(jlm.lm_forward, jcfg, train=False)(
        jp, {"features": jnp.asarray(moved)})
    _close(b, want)


def test_encoder_refusals_match_reference(models):
    """A KV bucket and the slot engine are refused with the reference's
    words; the cache of an encoder layer is empty."""
    jcfg, tcfg, jp, tp = models("hubert")
    with pytest.raises(ValueError) as jerr:
        jlm._check_kv_bucket(jcfg, 16)
    cache = lm.init_lm_cache(tcfg, B, MS, device="cpu")
    assert cache["segments"][0] == ({},)
    with pytest.raises(ValueError) as terr:
        lm.lm_prefill_chunk(tcfg, tp, torch.zeros((B, 4), dtype=torch.int32),
                            cache, kv_bucket=16)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        JEngine(jcfg, jp, slots=2, max_seq=MS)
    with pytest.raises(ValueError) as terr:
        ServingEngine(tcfg, tp, slots=2, max_seq=MS, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_supports_chunked_prefill_matches_reference():
    for name in tregistry.list_archs():
        assert supports_chunked_prefill(tregistry.get(name)) == j_supports(
            jregistry.get(name)), name


def test_encoder_operator_costs_match_reference(models):
    """``operator_costs`` of the forward at reduced(hubert) (one unit):
    the same classes with non-zero FLOPs, ``gemm`` FLOPs within 1%."""
    arch = MODELS["hubert"]
    jcfg = dataclasses.replace(jconfigs.reduced(
        jregistry.get(arch), vocab=250, n_units=1), compute_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.reduced(
        tregistry.get(arch), vocab=250, n_units=1), compute_dtype="float32")
    feats = _features(B, FRAMES, tcfg.frontend_feature_dim, seed=3)
    jp = jax.eval_shape(lambda k: jlm.init_lm_params(jcfg, k),
                        jax.random.PRNGKey(0))
    compiled = jax.jit(lambda p, f: jlm.lm_forward(
        jcfg, p, {"features": f}, train=False)).lower(
        jp, jnp.asarray(feats)).compile()
    tp = lm.prepare_params(tcfg, lm.init_lm_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu"))
    want = j_operator_costs(compiled)
    got = operator_costs(lm.lm_forward, tcfg, tp,
                         features=torch.from_numpy(feats))
    nz = lambda c: {k for k, v in c["by_class"].items() if v["flops"] > 0}
    assert nz(got) == nz(want)
    assert got["by_class"]["gemm"]["flops"] == pytest.approx(
        want["by_class"]["gemm"]["flops"], rel=0.01)


# ------------------------------------------------------------------ llava

def _close_cache(t_segs, j_segs):
    t_leaves = tree_leaves(t_segs)
    j_leaves = jax.tree_util.tree_leaves(j_segs)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        _close(t, j)


def test_vision_prefill_matches_reference(models):
    """5 patch features before an 11-token prompt: last logits, ``pos`` at
    16 and every cache leaf; the full-sequence forward's logits too."""
    jcfg, tcfg, jp, tp = models("llava")
    toks = _tokens(B, PROMPT, tcfg.vocab_size, seed=4)
    feats = _features(B, PATCHES, tcfg.frontend_feature_dim, seed=5)
    inputs = {"tokens": jnp.asarray(toks), "features": jnp.asarray(feats)}
    lg, cache = lm.lm_prefill(
        tcfg, tp, torch.from_numpy(toks),
        lm.init_lm_cache(tcfg, B, MS, dtype=torch.float32, device="cpu"),
        features=torch.from_numpy(feats))
    j_lg, j_cache = _jit(jlm.lm_prefill, jcfg)(
        jp, inputs, jlm.init_lm_cache(jcfg, B, MS, dtype=jnp.float32))
    _close(lg, j_lg)
    assert cache["pos"].tolist() == [PATCHES + PROMPT] * B
    assert np.asarray(j_cache["pos"]).tolist() == [PATCHES + PROMPT] * B
    _close_cache(cache["segments"], j_cache["segments"])
    full = lm.lm_forward(tcfg, tp, torch.from_numpy(toks),
                         features=torch.from_numpy(feats))
    _close(full, _jit(jlm.lm_forward, jcfg, train=False)(jp, inputs))


def test_vision_greedy_generate_matches_reference(models):
    jcfg, tcfg, jp, tp = models("llava")
    toks = _tokens(B, PROMPT, tcfg.vocab_size, seed=6)
    feats = _features(B, PATCHES, tcfg.frontend_feature_dim, seed=7)
    j_out, j_cache = j_greedy(
        jcfg, jp, {"tokens": jnp.asarray(toks),
                   "features": jnp.asarray(feats)}, MS, 6)
    out, cache = greedy_generate(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                                 MS, 6, features=torch.from_numpy(feats),
                                 device="cpu")
    np.testing.assert_array_equal(np.asarray(j_out), out.numpy())
    assert cache["pos"].tolist() == [PATCHES + PROMPT + 5] * B


def test_vision_engine_serves_tokens_like_reference(models, monkeypatch):
    """A vision model served token-only: 4 ragged requests through 2
    slots, streams equal the reference engine's (fp32 caches)."""
    jcfg, tcfg, jp, tp = models("llava")
    for mod in (j_engine_mod, j_prefill_mod):
        monkeypatch.setattr(mod, "init_lm_cache", functools.partial(
            jlm.init_lm_cache, dtype=jnp.float32))
    for mod in (t_engine_mod, t_prefill_mod):
        monkeypatch.setattr(mod, "init_lm_cache", functools.partial(
            lm.init_lm_cache, dtype=torch.float32))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(2, tcfg.vocab_size, n).astype(np.int32)
               for n in (9, 17, 12, 20)]
    kw = dict(slots=2, max_seq=64, decode_block=4, chunk_size=8)
    jeng = JEngine(jcfg, jp, **kw)
    teng = ServingEngine(tcfg, tp, device="cpu", **kw)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=p, max_new=8))
        teng.submit(Request(rid=i, prompt=p, max_new=8))
    j_out = {r.rid: r.out for r in jeng.run()}
    t_done = teng.run()
    assert [r.status for r in t_done] == ["ok"] * len(prompts)
    assert {r.rid: r.out for r in t_done} == j_out
