"""The MoE layers (``models/moe.py``) and the two MoE configs against the
reference, on the CPU.

* The layer at the reference's own test shapes (``tests/test_moe_paths.py``:
  8 experts, top 2, expert d_ff 32, d_model 16, 2 x 12 tokens), the
  reference's params carried across by ``from_jax``: ``moe_gshard`` and
  ``moe_ragged`` with and without the shared expert, at 1 and 4 dispatch
  groups; a capacity factor of 1.0 with a router skewed toward two
  experts, so that choices drop: the same y, and the same outputs where
  the router alone is compared (top-k indices and gates); gshard equal
  to ragged where nothing drops; ``_capacity`` equal to the reference's.
* reduced(qwen3-moe-235b-a22b) (2 ``moe`` layers, qk-norm, top 2 of 8)
  and reduced(llama4-maverick-400b-a17b) (``dense_moe`` + ``moe`` twice,
  top 1 with the shared expert) in fp32, seeded params of the port's
  initializer on both sides (``from_jax`` of the reference's tree checked
  apart): ``lm_prefill``, ragged chunked
  prefill, ``decode_tokens`` with the sentinel, and the engine's streams
  against the reference engine's on the same batch (a MoE prefill
  depends on its batch mates: they share the experts' capacity).
* The four configs this slice adds, field for field, and ``ASSIGNED``;
  ``memmodel`` counts; ``operator_costs`` class FLOPs at
  reduced(qwen3-moe).

Tolerances: 1e-4 of max(1, max |reference|) on outputs, logits and cache
leaves (fp32, sums in another order), greedy tokens equal.  The
reference's calls run under ``jax.jit``.
"""
import dataclasses
import functools
import re

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
from repro.core import memmodel as jmem
from repro.core import registry as jregistry
from repro.core.config import MoEConfig as JMoE
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models.params import init_params as j_init_params
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.prefill import chunked_prefill as j_chunked_prefill
from repro.serving.telemetry import operator_costs as j_operator_costs
from repro_torch.convert import from_jax, to_numpy
from repro_torch.core import memmodel as tmem
from repro_torch.core import registry as tregistry
from repro_torch.core.classify import KNOWN_SCOPES
from repro_torch.core.config import MoEConfig
from repro_torch.core.op_analysis import analyze
from repro_torch.models import lm, moe
from repro_torch.models.params import tree_leaves
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.prefill import chunked_prefill
from repro_torch.serving.telemetry import operator_costs

TOL = 1e-4
NEW = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b", "hubert-xlarge",
       "llava-next-mistral-7b")
MODELS = {"qwen3": "qwen3-moe-235b-a22b",
          "llama4": "llama4-maverick-400b-a17b"}
B, PROMPT, MS = 2, 11, 32

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


# ------------------------------------------------------------- the layer

def _layer(shared=False, cf=8.0, skew=0.0, impl="gshard", shape=(2, 12)):
    """The reference's test layer on both sides: params from its
    initializer, a router column bias of ``skew`` on experts 0 and 1,
    ``shape`` tokens."""
    kw = dict(n_experts=8, experts_per_token=2, d_ff_expert=32,
              capacity_factor=cf, shared_expert=shared, impl=impl)
    jm, tm = JMoE(**kw), MoEConfig(**kw)
    d = 16
    jp = j_init_params(jmoe.moe_param_defs(d, jm), jax.random.PRNGKey(0))
    if skew:
        jp = dict(jp, router=jp["router"].at[:, :2].add(skew))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), shape + (d,),
                                     jnp.float32))
    tp = from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, tm, jp, tp, x


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("impl,groups", [("gshard", 1), ("gshard", 4),
                                         ("ragged", 1)])
def test_moe_layer_matches_reference(impl, groups, shared):
    """Both paths (the ragged one has no groups) against the
    reference's, and ``moe`` dispatching by ``impl``."""
    jm, tm, jp, tp, x = _layer(shared=shared, impl=impl)
    if impl == "ragged":
        want = _jit(jmoe.moe_ragged, m=jm)(jp, jnp.asarray(x))
        got = moe.moe_ragged(tp, torch.from_numpy(x), tm)
    else:
        want = _jit(jmoe.moe_gshard, m=jm, n_groups=groups)(
            jp, jnp.asarray(x))
        got = moe.moe_gshard(tp, torch.from_numpy(x), tm, groups)
    _close(got, want)
    # the dispatcher picks the path by impl
    via = moe.moe(tp, torch.from_numpy(x), tm, groups)
    assert torch.equal(via, got)


def _dropped(tm, tp, x, groups):
    """Choices past their expert's capacity, from the router's indices
    and the reference's cumulative-sum order ([g, tg, k] bool)."""
    t = x.shape[0] * x.shape[1]
    tg = t // groups
    _, idx = moe._router(tp, torch.from_numpy(x).reshape(groups, tg, -1), tm)
    oh = moe._one_hot(idx, tm.n_experts)
    pos = torch.cumsum(oh.reshape(groups, -1, tm.n_experts), 1).reshape(
        oh.shape) - 1
    return (pos * oh).sum(-1) >= moe._capacity(tg, tm)


@pytest.mark.parametrize("groups", [1, 4])
def test_capacity_drops_match_reference(groups):
    """4 x 32 tokens, capacity factor 1.0 and a router skewed toward
    experts 0 and 1: choices drop (differently per group count), and y
    equals the reference's, so the same choices dropped."""
    jm, tm, jp, tp, x = _layer(cf=1.0, skew=2.0, shape=(4, 32))
    drops = _dropped(tm, tp, x, groups)
    assert 0 < int(drops.sum()) < drops.numel()
    want = _jit(jmoe.moe_gshard, m=jm, n_groups=groups)(jp, jnp.asarray(x))
    got = moe.moe_gshard(tp, torch.from_numpy(x), tm, groups)
    _close(got, want)
    # a token whose every choice dropped gets no routed output at all
    gone = drops.reshape(-1, tm.experts_per_token).all(-1)
    y = got.reshape(-1, x.shape[-1])
    assert torch.all(y[gone] == 0)
    assert torch.all(y[~gone].abs().amax(-1) > 0)
    # and no drop at ample capacity: a different y
    _, tm8, _, tp8, _ = _layer(cf=8.0, skew=2.0, shape=(4, 32))
    assert not _dropped(tm8, tp8, x, groups).any()
    assert not torch.allclose(moe.moe_gshard(tp8, torch.from_numpy(x), tm8,
                                             groups), got)


def test_router_topk_matches_reference():
    jm, tm, jp, tp, x = _layer(skew=0.5)
    jg, ji = _jit(jmoe._router, m=jm)(jp, jnp.asarray(x))
    tg, ti = moe._router(tp, torch.from_numpy(x), tm)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    _close(tg, jg)


@pytest.mark.parametrize("shared", [False, True])
def test_gshard_matches_ragged_no_drop(shared):
    _, tm, _, tp, x = _layer(shared=shared)
    xt = torch.from_numpy(x)
    _close(moe.moe_gshard(tp, xt, tm, 1), moe.moe_ragged(tp, xt, tm).numpy())


def test_capacity_matches_reference():
    for e, k, cf in ((8, 2, 1.25), (128, 8, 1.25), (128, 1, 1.25),
                     (8, 2, 1.0), (16, 4, 8.0)):
        jm = JMoE(n_experts=e, experts_per_token=k, d_ff_expert=8,
                  capacity_factor=cf)
        tm = MoEConfig(n_experts=e, experts_per_token=k, d_ff_expert=8,
                       capacity_factor=cf)
        for tg in (1, 4, 7, 64, 100, 1024, 4096):
            assert moe._capacity(tg, tm) == jmoe._capacity(tg, jm)


# ------------------------------------------------------------ the models

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


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _t_cache(cfg, b, ms):
    return lm.init_lm_cache(cfg, b, ms, dtype=torch.float32, device="cpu")


def _j_cache(cfg, b, ms):
    return jlm.init_lm_cache(cfg, b, ms, dtype=jnp.float32)


def _close_cache(t_segs, j_segs):
    t_leaves = tree_leaves(t_segs)
    j_leaves = jax.tree_util.tree_leaves(j_segs)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        _close(t, j)


def _carries_the_reference_tree(jcfg, tp):
    """``from_jax`` of the reference's tree (zeros of its initializer's
    shapes) gives the port's tree: the same structure, shapes, dtypes."""
    shapes = jax.eval_shape(lambda k: jlm.init_lm_params(jcfg, k),
                            jax.random.PRNGKey(0))
    carried = to_numpy(from_jax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), "cpu"))
    own = to_numpy(tp)
    assert (jax.tree_util.tree_structure(carried)
            == jax.tree_util.tree_structure(own))
    for c, o in zip(jax.tree_util.tree_leaves(carried),
                    jax.tree_util.tree_leaves(own)):
        assert (c.shape, c.dtype) == (o.shape, o.dtype)


@pytest.mark.parametrize("name", list(MODELS))
def test_param_trees_and_prepare_params(name, models):
    """The port's params carry the reference's tree (the ``moe`` subtree
    with the router and the experts, and the shared expert's at llama4);
    ``prepare_params`` casts the experts to the compute dtype and leaves
    the router fp32."""
    jcfg, tcfg, jp, tp = models(name)
    _carries_the_reference_tree(jcfg, tp)
    defs = lm.model_param_defs(tcfg)
    kinds = tcfg.layer_pattern
    moe_layer = defs["segments"][0][kinds.index("moe")]["moe"]
    want = {"router", "wi", "wg", "wo"} | (
        {"shared_wi", "shared_wg", "shared_wo"}
        if tcfg.moe.shared_expert else set())
    assert set(moe_layer) == want
    cfg = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    prep = lm.prepare_params(cfg, tp)["segments"][0][kinds.index("moe")]
    assert prep["moe"]["router"].dtype == torch.float32
    assert {prep["moe"][k].dtype for k in want - {"router"}} == {
        torch.bfloat16}


@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_matches_reference(name, models):
    jcfg, tcfg, jp, tp = models(name)
    toks = _tokens(B, PROMPT, tcfg.vocab_size, seed=2)
    lg, cache = lm.lm_prefill(tcfg, tp, torch.from_numpy(toks),
                              _t_cache(tcfg, B, MS))
    j_lg, j_cache = _jit(jlm.lm_prefill, jcfg)(
        jp, {"tokens": jnp.asarray(toks)}, _j_cache(jcfg, B, MS))
    _close(lg, j_lg)
    assert cache["pos"].tolist() == np.asarray(j_cache["pos"]).tolist()
    _close_cache(cache["segments"], j_cache["segments"])


@pytest.mark.parametrize("name", list(MODELS))
def test_ragged_chunked_prefill_matches_reference(name, models):
    """Rows of 21 and 9 tokens in chunks of 6 (padded tokens compete for
    capacity on both sides alike): each row's last logits, pos, every
    cache leaf."""
    jcfg, tcfg, jp, tp = models(name)
    lens = [21, 9]
    toks = _tokens(B, max(lens), tcfg.vocab_size, seed=4)
    lg, cache = chunked_prefill(tcfg, tp, torch.from_numpy(toks),
                                _t_cache(tcfg, B, MS), chunk_size=6,
                                lengths=lens)
    j_lg, j_cache = j_chunked_prefill(jcfg, jp, jnp.asarray(toks),
                                      _j_cache(jcfg, B, MS), chunk_size=6,
                                      lengths=lens)
    _close(lg, j_lg)
    assert cache["pos"].tolist() == lens
    _close_cache(cache["segments"], j_cache["segments"])


@pytest.mark.parametrize("name", list(MODELS))
def test_decode_tokens_match_reference(name, models):
    jcfg, tcfg, jp, tp = models(name)
    toks = _tokens(B, PROMPT, tcfg.vocab_size, seed=5)
    lg, cache = lm.lm_prefill(tcfg, tp, torch.from_numpy(toks),
                              _t_cache(tcfg, B, MS))
    j_lg, j_cache = _jit(jlm.lm_prefill, jcfg)(
        jp, {"tokens": jnp.asarray(toks)}, _j_cache(jcfg, B, MS))
    first = torch.argmax(lg[..., :tcfg.vocab_size], -1).to(torch.int32)
    j_first = jnp.argmax(j_lg[..., :jcfg.vocab_size], -1).astype(jnp.int32)
    assert np.array_equal(np.asarray(j_first), first.numpy())
    got = lm.decode_tokens(tcfg, tp, cache, first, 6, with_sentinel=True)
    want = _jit(jlm.decode_tokens, jcfg, n=6, with_sentinel=True)(
        jp, j_cache, j_first)
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    _close_cache(got[1]["segments"], want[1]["segments"])
    assert got[2].tolist() == np.asarray(want[2]).tolist() == [True] * B


@pytest.mark.parametrize("name", list(MODELS))
def test_engine_streams_match_reference_engine(name, models, monkeypatch):
    """5 ragged requests through 2 slots, chunks of 8, the last three
    admitted mid-flight, both on fp32 caches: per-request streams equal
    the reference engine's on the same batches."""
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
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=p, max_new=8))
        teng.submit(Request(rid=i, prompt=p, max_new=8))
    j_out = {r.rid: r.out for r in jeng.run()}
    t_done = teng.run()
    assert [r.status for r in t_done] == ["ok"] * len(prompts)
    assert {r.rid: r.out for r in t_done} == j_out


# ----------------------------------------------- configs, memory, costs

def _fields(cfg):
    return {f.name: (_fields(getattr(cfg, f.name))
                     if dataclasses.is_dataclass(getattr(cfg, f.name))
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", NEW)
def test_config_matches_reference_field_for_field(arch):
    """Every field of the port's config equals the reference's, ``remat``
    (the training step's rematerialisation) included; the reference's
    only extra field is the sharding knob ``scan_layers`` (the port has
    no layer scan).  The registry tags too."""
    got = _fields(tregistry.get(arch))
    want = _fields(jregistry.get(arch))
    assert set(want) - set(got) == {"scan_layers"}
    assert got["remat"] == want["remat"]
    for key, val in got.items():
        if isinstance(val, dict):
            assert val == {k: want[key][k] for k in val}, key
        else:
            assert val == want[key], key
    assert tregistry._TAGS[arch] == jregistry._TAGS[arch]
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED


@pytest.mark.parametrize("arch", NEW)
def test_memmodel_counts_match_reference(arch):
    tcfg = tregistry.get(arch)
    jcfg = jregistry.get(arch)
    assert tmem.param_count(tcfg) == jcfg.param_count()
    assert tmem.active_param_count(tcfg) == jcfg.active_param_count()
    for b, s in ((1, 4096), (4, 32768)):
        assert dataclasses.asdict(tmem.inference_memory(tcfg, b, s)) == \
            dataclasses.asdict(jmem.inference_memory(jcfg, b, s))


def _cost_calls(which):
    """reduced(qwen3-moe) at one unit: the reference compiled on abstract
    params and cache, the port's call on seeded ones."""
    arch = MODELS["qwen3"]
    jcfg = dataclasses.replace(jconfigs.reduced(
        jregistry.get(arch), vocab=250, n_units=1),
        compute_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.reduced(
        tregistry.get(arch), vocab=250, n_units=1),
        compute_dtype="float32")
    jp = jax.eval_shape(lambda k: jlm.init_lm_params(jcfg, k),
                        jax.random.PRNGKey(0))
    j_cache = jax.eval_shape(
        lambda: jlm.init_lm_cache(jcfg, B, MS, dtype=jnp.float32))
    tp = lm.prepare_params(tcfg, lm.init_lm_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu"))
    t_cache = dict(_t_cache(tcfg, B, MS),
                   pos=torch.tensor([3, 5], dtype=torch.int32))
    if which == "decode":
        tok = np.array([[7], [11]], np.int32)
        compiled = jax.jit(
            lambda p, c, t: jlm.lm_decode_step(jcfg, p, t, c)).lower(
            jp, j_cache, jnp.asarray(tok)).compile()
        return compiled, (lm.lm_decode_step,
                          (tcfg, tp, torch.from_numpy(tok), t_cache), {})
    toks = np.arange(B * 8, dtype=np.int32).reshape(B, 8) % 250
    lens = np.array([8, 5], np.int32)
    compiled = jax.jit(
        lambda p, c, t, n: jlm.lm_prefill_chunk(
            jcfg, p, {"tokens": t}, c, lengths=n)).lower(
        jp, j_cache, jnp.asarray(toks), jnp.asarray(lens)).compile()
    return compiled, (lm.lm_prefill_chunk,
                      (tcfg, tp, torch.from_numpy(toks), t_cache),
                      {"lengths": torch.from_numpy(lens)})


@pytest.mark.parametrize("which", ["decode", "chunk"])
def test_operator_costs_match_reference(which):
    """``operator_costs`` of a decode step and a ragged chunk at
    reduced(qwen3-moe): the same classes with non-zero FLOPs, ``gemm``
    FLOPs (the attention, the router and every gshard product) within
    1%, and the reference's ``named_scope`` names.  One name differs by
    XLA's rewriting: the compiled reference leaves the gshard products
    of ``moe_dispatch`` and ``moe_combine`` with no scope metadata (they
    stay ``gemm`` by opcode), so no op carries ``moe_combine`` there,
    where the port records it."""
    compiled, (fn, args, kwargs) = _cost_calls(which)
    want = j_operator_costs(compiled)
    got = operator_costs(fn, *args, **kwargs)
    nz = lambda c: {k for k, v in c["by_class"].items() if v["flops"] > 0}
    assert nz(got) == nz(want)
    assert got["by_class"]["gemm"]["flops"] == pytest.approx(
        want["by_class"]["gemm"]["flops"], rel=0.01)
    scopes = analyze(fn, *args, **kwargs).scopes
    hlo = set()
    for match in re.finditer(r'op_name="([^"]*)"', compiled.as_text()):
        hlo.update(p for p in match.group(1).split("/")
                   if p in KNOWN_SCOPES)
    assert {"moe_route", "moe_dispatch", "moe_expert"} <= hlo
    assert scopes == hlo | {"moe_combine"}


@pytest.mark.parametrize("impl", ["gshard", "ragged"])
def test_full_width_meta_walk_of_the_moe_decode_step(impl):
    """qwen3-moe-235b-a22b at full width, 8 layers, on ``meta`` (as phase
    8 walks it): a decode step at B = 4 counts as ``gemm`` the attention
    and the head, the router, and every expert product of the path: all
    128 experts' rows of capacity 8 plus the one-hot dispatch and
    combine products for gshard, each token's 8 routed rows for ragged;
    one decode-attention kernel a layer."""
    from repro_torch.core.op_analysis import meta_like, meta_params
    cfg = dataclasses.replace(tregistry.get(MODELS["qwen3"]), n_layers=8)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           impl=impl))
    b, d, m, a = 4, cfg.d_model, cfg.moe, cfg.attn
    params = meta_params(cfg, torch.bfloat16)
    cache = meta_like(lm.init_lm_cache(cfg, b, 4096, device="meta"))
    tok = torch.zeros((b, 1), dtype=torch.int32, device="meta")
    s = analyze(lm.lm_decode_step, cfg, params, tok, cache, kv_bucket=2048)
    q, kv = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
    e, k, f = m.n_experts, m.experts_per_token, m.d_ff_expert
    cap = moe._capacity(b, m)
    attn = 2 * b * (d * (q + 2 * kv) + q * d)
    if impl == "gshard":
        experts = (3 * 2 * e * cap * d * f + 2 * b * e * cap * k
                   + 2 * 2 * b * e * cap * d)
    else:
        experts = 3 * 2 * b * k * d * f
    want = (cfg.n_layers * (attn + 2 * b * d * e + experts)
            + 2 * b * d * cfg.padded_vocab)
    assert s.by_class()["gemm"]["flops"] == pytest.approx(want, rel=0.01)
    kernels = [x.name for x in s.kernels if x.opcode == "kernel"]
    assert kernels == ["decode_attention"] * cfg.n_layers


def test_huge_leaves_are_drawn_piece_by_piece(monkeypatch):
    """A normal leaf past ``DRAW_LIMIT`` elements is drawn along its
    leading axes straight into its dtype, from the normal it would have
    had; a leaf within the limit is the one draw it always was."""
    from repro_torch.models import params as tparams
    d = tparams.ParamDef((3, 4, 50), (None, None, None), fan_in=4)
    monkeypatch.setattr(tparams, "DRAW_LIMIT", 120)
    small = tparams.ParamDef((2, 60), (None, None), fan_in=4)
    assert torch.equal(
        tparams._init_leaf(small, torch.Generator().manual_seed(3),
                           torch.float32, torch.device("cpu")),
        torch.randn((2, 60), generator=torch.Generator().manual_seed(3))
        / 2.0)
    got = tparams._init_leaf(d, torch.Generator().manual_seed(3),
                             torch.bfloat16, torch.device("cpu"))
    assert got.dtype == torch.bfloat16 and got.shape == (3, 4, 50)
    # rows of 50 (the first pieces within the limit), one after another
    gen = torch.Generator().manual_seed(3)
    rows = [torch.randn((50,), generator=gen) / 2.0 for _ in range(12)]
    assert torch.equal(got, torch.stack(rows).reshape(d.shape).to(
        torch.bfloat16))
