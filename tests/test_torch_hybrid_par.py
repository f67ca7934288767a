"""The ``hybrid_par`` kind (Falcon-H1, Hymba) against the reference, on the CPU.

Two models: the reference's own ``hybrid_par`` test config
(``tests/test_chunked_prefill.py``, ``tests/test_models.py``: 2 layers,
d_model 64, 4 heads on 2 KV heads of 16, d_state 16, chunk 8, vocab 97)
and reduced(falcon-h1-0.5b) (2 layers, d_model 64, vocab 250), fp32
compute, the reference's params carried across by ``from_jax``, the
reference on its ``ref`` backend, each of its calls under ``jax.jit`` (op
by op it compiles every operation apart, several times slower here).

* The layer: param and cache trees; one ``apply_layer`` as a one-shot
  prefill, a ragged chunk at offsets and a decode step, outputs and every
  cache leaf.
* One-shot and ragged chunked prefill, logits and every cache leaf;
  ``decode_tokens`` with and without the sentinel; the engine's streams.
* The spare state set: bursts of 4 and 5 bit for bit against the default
  path, the state leaves ending at the cache's addresses.
* bf16 compute against the reference's.

Tolerances: fp32 caches 1e-4 of max(1, max |reference|) on logits and
cache leaves, and greedy tokens equal; bf16 2e-2 (one bf16 rounding of
each projection, placed differently on the two sides).  Also the plain
decode attention at 16 query heads per KV head (glm4-9b's group) against
the reference's oracle and its Pallas kernel in interpret mode.
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
from repro.configs import reduced as j_reduced
from repro.configs.paper_models import FALCON_H1_05B as J_FALCON
from repro.core.config import AttnConfig as JAttn
from repro.core.config import ModelConfig as JModel
from repro.core.config import SSMConfig as JSSM
from repro.kernels.attn_decode.kernel import decode_attention_pallas
from repro.kernels.flash.ref import decode_attention_ref as j_dec
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models.rope import rope_tables as j_rope_tables
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.prefill import chunked_prefill as j_chunked_prefill
from repro_torch.configs import falcon_h1_05b as T_FALCON
from repro_torch.configs import reduced
from repro_torch.convert import from_jax, to_numpy
from repro_torch.core.config import AttnConfig, ModelConfig, SSMConfig
from repro_torch.kernels.attn_decode import ops as dec_ops
from repro_torch.kernels.attn_decode import ref as dec_ref
from repro_torch.models import blocks, lm, mamba2
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.rope import rope_at, rope_tables
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.prefill import chunked_prefill


def _par_cfg(model, attn, ssm, **kw):
    """The reference's ``hybrid_par`` test config, on either side."""
    return model(name="hybrid_par", family="hybrid", n_layers=2, d_model=64,
                 d_ff=128, vocab_size=97,
                 attn=attn(n_heads=4, n_kv_heads=2, head_dim=16),
                 ssm=ssm(d_state=16, headdim=16, chunk=8),
                 layer_pattern=("hybrid_par",), vocab_pad_multiple=16, **kw)


MODELS = ("par", "falcon")
# one batch, prompt and cache size for most cases: the reference runs op by
# op and compiles each operation once per shape
B, PROMPT, MS = 2, 11, 32


_JITTED = {}


def _jit(fn, cfg, **static):
    """``fn`` of the reference with ``cfg`` (and ``static`` keywords)
    bound, under ``jax.jit``; one compiled function per binding."""
    key = (fn, id(cfg), tuple(sorted(static.items())))
    if key not in _JITTED:
        _JITTED[key] = jax.jit(functools.partial(fn, cfg, **static))
    return _JITTED[key]


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(name, compute="float32"):
        if (name, compute) not in built:
            if name == "par":
                jcfg = _par_cfg(JModel, JAttn, JSSM, compute_dtype=compute)
                tcfg = _par_cfg(ModelConfig, AttnConfig, SSMConfig,
                                compute_dtype=compute)
            else:
                jcfg = dataclasses.replace(j_reduced(J_FALCON, vocab=250),
                                           compute_dtype=compute)
                tcfg = dataclasses.replace(reduced(T_FALCON, vocab=250),
                                           compute_dtype=compute)
            if compute == "float32":
                jp = _jit(jlm.init_lm_params, jcfg)(jax.random.PRNGKey(0))
                tp = from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
            else:   # the same fp32 params (param_dtype), cast per use
                jp, tp = get(name)[2], built[(name, "float32")][4]
            built[(name, compute)] = (jcfg, tcfg, jp,
                                      lm.prepare_params(tcfg, tp), tp)
        return built[(name, compute)][:4]
    return get


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _t_cache(cfg, b, max_seq):
    return lm.init_lm_cache(cfg, b, max_seq, dtype=torch.float32,
                            device="cpu")


def _j_cache(cfg, b, max_seq):
    return jlm.init_lm_cache(cfg, b, max_seq, dtype=jnp.float32)


def _close(got, want, tol):
    """max |got - want| within ``tol`` times max(1, max |want|)."""
    g, w = to_numpy(got), np.asarray(want, np.float32)
    assert g.shape == w.shape
    err = float(np.abs(g - w).max())
    assert err <= tol * max(1.0, float(np.abs(w).max())), err


def _close_layer(t, j, tol):
    """One layer's cache dicts, leaf by leaf by key."""
    assert set(t) == set(j) == {"conv", "ssm", "k", "v"}
    for key in t:
        _close(t[key], j[key], tol)


def _close_cache(t_segs, j_segs, tol):
    assert len(t_segs) == len(j_segs)
    for ts, js in zip(t_segs, j_segs):
        assert len(ts) == len(js)
        for t, j in zip(ts, js):
            _close_layer(t, j, tol)


def _clone(cache):
    return {"segments": tree_map(torch.clone, cache["segments"]),
            "pos": cache["pos"].clone()}


# ------------------------------------------------------------- the layer

@pytest.mark.parametrize("name", MODELS)
def test_layer_trees_match_reference(name, models):
    """``layer_param_defs`` builds the kind (it raised before the port
    served it); params and caches have the reference's trees and shapes,
    the layer's cache one flat dict of Mamba-2 and KV leaves."""
    jcfg, tcfg, jp, tp = models(name)
    defs = blocks.layer_param_defs(tcfg, "hybrid_par")
    assert set(defs) == {"ln1", "attn", "mamba", "ln2", "mlp"}
    assert (jax.tree_util.tree_structure(jax.tree_util.tree_map(
        np.asarray, jp)) == jax.tree_util.tree_structure(to_numpy(tp)))
    jc = jax.tree_util.tree_map(np.asarray, jlm.init_lm_cache(jcfg, B, MS))
    tc = lm.init_lm_cache(tcfg, B, MS, device="cpu")
    assert (jax.tree_util.tree_structure(jc)
            == jax.tree_util.tree_structure(to_numpy(tc)))
    for a, b in zip(jax.tree_util.tree_leaves(jc),
                    jax.tree_util.tree_leaves(to_numpy(tc))):
        assert a.shape == b.shape
    assert set(tc["segments"][0][0]) == {"conv", "ssm", "k", "v"}
    assert lm.cache_kv_extent(tc) == MS
    assert [set(s) for s in lm._state_leaves(tc)[0]] == [{"conv", "ssm"}]


@pytest.mark.parametrize("name", MODELS)
def test_prepare_params_casts_both_halves(name, models):
    """One ``hybrid_par`` layer gets both casts: its attention and MLP
    weights and its four Mamba-2 projections in the compute dtype; norm
    scales, conv and SSM parameters stay fp32."""
    _, tcfg, _, _ = models(name)
    cfg = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    layer = lm.prepare_params(cfg, lm.init_lm_params(cfg, device="cpu"))[
        "segments"][0][0]
    for key, val in layer["mamba"].items():
        want = torch.bfloat16 if key in mamba2.PROJ_KEYS else torch.float32
        assert val.dtype == want, key
    assert {v.dtype for v in layer["attn"].values()} == {torch.bfloat16}
    assert {v.dtype for v in layer["mlp"].values()} == {torch.bfloat16}
    assert layer["ln1"].dtype == layer["ln2"].dtype == torch.float32


def _layer_inputs(tcfg, jcfg, jp, tp, b, s, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["segments"][0][0])
    tl = tree_map(lambda t: t[0], tp["segments"][0][0])
    return x, jl, tl


def _layer_cache(tc, jc):
    """Layer 0's cache on both sides, filled with the same random numbers
    (the conv window in the cache's dtype)."""
    rng = np.random.default_rng(11)
    t = {k: v[0].clone() for k, v in tc["segments"][0][0].items()}
    j = {}
    for k in t:
        a = rng.standard_normal(tuple(t[k].shape)).astype(np.float32)
        t[k].copy_(torch.from_numpy(a))
        j[k] = jnp.asarray(a)
    return t, j


@pytest.mark.parametrize("mode", ["prefill", "chunk", "decode"])
@pytest.mark.parametrize("name", MODELS)
def test_layer_matches_reference(name, mode, models):
    """``apply_layer`` on the kind: a one-shot prefill into a zero cache,
    a ragged chunk at per-row offsets over a filled cache (row 1 has 3
    valid tokens of 6), and a decode step; the output and every leaf of
    the new cache (the KV leaves written in place)."""
    jcfg, tcfg, jp, tp = models(name)
    b, ms = B, MS
    s = {"prefill": PROMPT, "chunk": 6, "decode": 1}[mode]
    x, jl, tl = _layer_inputs(tcfg, jcfg, jp, tp, b, s, seed=3)
    tc = _t_cache(tcfg, b, ms)
    jc = _j_cache(jcfg, b, ms)
    a = tcfg.attn
    jrope = j_rope_tables(ms, a.head_dim, a.rope_theta)
    tables = rope_tables(ms, a.head_dim, a.rope_theta)
    kw, jkw = {}, {}
    if mode == "prefill":
        t_layer = {k: v[0].clone() for k, v in tc["segments"][0][0].items()}
        j_layer = {k: v[0] for k, v in jc["segments"][0][0].items()}
        rope = rope_at(tables, None, s, torch.float32)
    else:
        t_layer, j_layer = _layer_cache(tc, jc)
        pos = np.array([6, 9], np.int32)
        tpos = torch.from_numpy(pos)
        kw["pos"], jkw["pos"] = tpos, jnp.asarray(pos)
        rope = rope_at(tables, tpos, s, torch.float32)
        if mode == "chunk":
            lens = np.array([6, 3], np.int32)
            mask = np.arange(s)[None, :] < lens[:, None]
            kw.update(chunk_mask=torch.from_numpy(mask),
                      chunk_lengths=torch.from_numpy(lens))
            jkw["chunk_mask"] = jnp.asarray(mask)
    y, new = blocks.apply_layer(tcfg, "hybrid_par", tl, torch.from_numpy(x),
                                rope=rope, cache=t_layer, **kw)
    jy, jnew = _jit(jblocks.apply_layer, jcfg, kind="hybrid_par")(
        p=jl, x=jnp.asarray(x), rope=jrope, cache=j_layer, **jkw)
    _close(y, jy, 1e-4)
    _close_layer(new, jnew, 1e-4)
    assert new["k"] is t_layer["k"] and new["v"] is t_layer["v"]


# ---------------------------------------------------- prefill and decode

@pytest.mark.parametrize("name", MODELS)
def test_prefill_matches_reference(name, models):
    jcfg, tcfg, jp, tp = models(name)
    toks = _tokens(B, PROMPT, tcfg.vocab_size, seed=2)
    lg, cache = lm.lm_prefill(tcfg, tp, torch.from_numpy(toks),
                              _t_cache(tcfg, B, MS))
    j_lg, j_cache = _jit(jlm.lm_prefill, jcfg)(
        jp, {"tokens": jnp.asarray(toks)}, _j_cache(jcfg, B, MS))
    _close(lg, j_lg, 1e-4)
    assert cache["pos"].tolist() == np.asarray(j_cache["pos"]).tolist()
    _close_cache(cache["segments"], j_cache["segments"], 1e-4)


@pytest.mark.parametrize("name", MODELS)
def test_ragged_chunked_prefill_matches_reference(name, models):
    """Rows of 21 and 9 tokens in chunks of 6, KV buckets on both sides:
    logits of each row's last token, pos and every cache leaf."""
    jcfg, tcfg, jp, tp = models(name)
    lens = [21, 9]
    toks = _tokens(B, max(lens), tcfg.vocab_size, seed=4)
    lg, cache = chunked_prefill(tcfg, tp, torch.from_numpy(toks),
                                _t_cache(tcfg, B, MS), chunk_size=6,
                                lengths=lens)
    j_lg, j_cache = j_chunked_prefill(jcfg, jp, jnp.asarray(toks),
                                      _j_cache(jcfg, B, MS), chunk_size=6,
                                      lengths=lens)
    _close(lg, j_lg, 1e-4)
    assert cache["pos"].tolist() == lens
    assert np.asarray(j_cache["pos"]).tolist() == lens
    _close_cache(cache["segments"], j_cache["segments"], 1e-4)


def _prefilled(name, models):
    jcfg, tcfg, jp, tp = models(name)
    toks = _tokens(B, PROMPT, tcfg.vocab_size, seed=5)
    lg, cache = lm.lm_prefill(tcfg, tp, torch.from_numpy(toks),
                              _t_cache(tcfg, B, MS))
    j_lg, j_cache = _jit(jlm.lm_prefill, jcfg)(
        jp, {"tokens": jnp.asarray(toks)}, _j_cache(jcfg, B, MS))
    first = torch.argmax(lg[..., :tcfg.vocab_size], -1).to(torch.int32)
    j_first = jnp.argmax(j_lg[..., :jcfg.vocab_size], -1).astype(jnp.int32)
    assert np.array_equal(np.asarray(j_first), first.numpy())
    return jcfg, tcfg, jp, tp, cache, j_cache, first, j_first


@pytest.mark.parametrize("sentinel", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_decode_tokens_match_reference(name, sentinel, models):
    """Greedy streams equal the reference's, with and without the
    divergence sentinel (``ok`` all True on a finite cache); the final
    caches agree."""
    jcfg, tcfg, jp, tp, cache, j_cache, first, j_first = _prefilled(
        name, models)
    got = lm.decode_tokens(tcfg, tp, cache, first, 6, with_sentinel=sentinel)
    want = _jit(jlm.decode_tokens, jcfg, n=6, with_sentinel=sentinel)(
        jp, j_cache, j_first)
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    _close_cache(got[1]["segments"], want[1]["segments"], 1e-4)
    if sentinel:
        assert got[2].tolist() == np.asarray(want[2]).tolist() == [True] * 2


@pytest.mark.parametrize("name", MODELS)
def test_sentinel_flags_a_nonfinite_state_row(name, models):
    """Row 1's first SSM state set to NaN on both sides: ``ok`` flags that
    row as the reference does, and row 0's tokens are unchanged."""
    jcfg, tcfg, jp, tp, cache, j_cache, first, j_first = _prefilled(
        name, models)
    cache["segments"][0][0]["ssm"][0, 1] = float("nan")
    seg = list(j_cache["segments"])
    layer = dict(seg[0][0])
    layer["ssm"] = layer["ssm"].at[0, 1].set(jnp.nan)
    seg[0] = (layer,) + tuple(seg[0][1:])
    j_cache = dict(j_cache, segments=seg)
    toks, _, ok = lm.decode_tokens(tcfg, tp, cache, first, 5,
                                   with_sentinel=True)
    j_toks, _, j_ok = _jit(jlm.decode_tokens, jcfg, n=5,
                           with_sentinel=True)(jp, j_cache, j_first)
    assert ok.tolist() == np.asarray(j_ok).tolist() == [True, False]
    np.testing.assert_array_equal(np.asarray(j_toks)[0], toks[0].numpy())


@pytest.mark.parametrize("n", [4, 5])
@pytest.mark.parametrize("name", MODELS)
def test_spare_states_burst_is_bit_identical_in_place(name, n, models):
    """A burst with the spare state set against the default path: tokens,
    ``ok``, ``pos`` and every leaf bit for bit; the KV leaves and the
    state leaves end at the cache's own addresses."""
    _, tcfg, _, tp, cache, _, first, _ = _prefilled(name, models)
    want_toks, want, want_ok = lm.decode_tokens(
        tcfg, tp, _clone(cache), first, n, kv_bucket=16, with_sentinel=True)
    cache = _clone(cache)
    own = [t.data_ptr() for t in tree_leaves(cache["segments"])]
    spare = lm.init_spare_states(cache)
    # conv and ssm of each layer of the unit, stacked over its repeats
    assert len(tree_leaves(spare)) == 2 * len(tcfg.layer_pattern)
    toks, got, ok = lm.decode_tokens(tcfg, tp, cache, first, n,
                                     kv_bucket=16, with_sentinel=True,
                                     _spare_states=spare)
    assert torch.equal(toks, want_toks) and torch.equal(ok, want_ok)
    assert torch.equal(got["pos"], want["pos"])
    assert [t.data_ptr() for t in tree_leaves(got["segments"])] == own
    for a, b in zip(tree_leaves(got["segments"]),
                    tree_leaves(want["segments"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", MODELS)
def test_engine_streams_match_reference_engine(name, models, monkeypatch):
    """5 ragged requests through 2 slots (fifo), chunked prefill, the last
    three admitted mid-flight: per-request streams equal the reference
    engine's, both on fp32 caches; the engine's state leaves keep their
    addresses."""
    jcfg, tcfg, jp, tp = models(name)
    for mod in (j_engine_mod, j_prefill_mod):
        monkeypatch.setattr(mod, "init_lm_cache", functools.partial(
            jlm.init_lm_cache, dtype=jnp.float32))
    for mod in (t_engine_mod, t_prefill_mod):
        monkeypatch.setattr(mod, "init_lm_cache", functools.partial(
            lm.init_lm_cache, dtype=torch.float32))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, tcfg.vocab_size, n).astype(np.int32)
               for n in (9, 17, 12, 9, 23)]
    kw = dict(slots=2, max_seq=64, decode_block=4, chunk_size=8)
    jeng = JEngine(jcfg, jp, **kw)
    teng = ServingEngine(tcfg, tp, device="cpu", **kw)
    own = [t.data_ptr() for t in tree_leaves(teng.cache["segments"])]
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=p, max_new=10))
        teng.submit(Request(rid=i, prompt=p, max_new=10))
    j_out = {r.rid: r.out for r in jeng.run()}
    t_done = teng.run()
    assert [r.status for r in t_done] == ["ok"] * len(prompts)
    assert {r.rid: r.out for r in t_done} == j_out
    assert [t.data_ptr() for t in tree_leaves(teng.cache["segments"])] == own


@pytest.mark.parametrize("name", MODELS)
def test_bf16_prefill_and_decode_match_reference(name, models):
    """bf16 compute and caches on both sides: prefill logits and a decode
    step's logits within 2e-2 of max(1, max |logit|)."""
    jcfg, tcfg, jp, tp = models(name, "bfloat16")
    toks = _tokens(B, PROMPT, tcfg.vocab_size, seed=6)
    lg, cache = lm.lm_prefill(tcfg, tp, torch.from_numpy(toks),
                              lm.init_lm_cache(tcfg, B, MS, device="cpu"))
    j_lg, j_cache = _jit(jlm.lm_prefill, jcfg)(
        jp, {"tokens": jnp.asarray(toks)}, jlm.init_lm_cache(jcfg, B, MS))
    _close(lg, j_lg, 2e-2)
    tok = np.array([[3], [5]], np.int32)
    lg, _ = lm.lm_decode_step(tcfg, tp, torch.from_numpy(tok), cache)
    j_lg, _ = _jit(jlm.lm_decode_step, jcfg)(jp, jnp.asarray(tok), j_cache)
    _close(lg, j_lg, 2e-2)


# ------------------------------------------- decode attention at G = 16

@pytest.mark.parametrize("d", [16, 128])
def test_decode_attention_ref_at_group_16(d):
    """glm4-9b's group (32 query heads on 2 KV heads): the plain decode
    attention, and the kernel's split form, against the reference's
    oracle and its Pallas kernel in interpret mode."""
    b, h, kvh, s = 2, 32, 2, 200
    rng = np.random.default_rng(12)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, h, d), (b, kvh, s, d), (b, kvh, s, d)))
    vl = np.array([1, 137], np.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = dec_ops.decode_attention(tq, tk, tv, valid_len=torch.from_numpy(vl))
    split = dec_ref.decode_attention_split_ref(
        tq, tk, tv, valid_len=torch.from_numpy(vl), split_len=64)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for want in (j_dec(jq, jk, jv, valid_len=jnp.asarray(vl)),
                 decode_attention_pallas(jq, jk, jv,
                                         valid_len=jnp.asarray(vl),
                                         block_s=64, split_k=2,
                                         interpret=True)):
        for out in (got, split):
            np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                       rtol=2e-4, atol=2e-4)
