"""The sliding-window slice against the reference, on the CPU.

The same numpy inputs, made from a seed, go through the reference's JAX
function and the port's counterpart; params are the reference's, carried
across by ``from_jax``.

* The ring layout of the flash kernel (the port's CPU path, the plain
  ``attention_ref``) against the reference's ``attention_ref`` ring mode,
  its Pallas kernel in interpret mode, and windowed attention over the
  linear key sequence, at the cases of the reference's
  ``test_flash_kernel_ring`` plus a chunk longer than the window: 2e-4 of
  max |o| in fp32 (the reference's kernel tolerance), 2e-2 in bf16.
* The port's windowed ``attention_ref`` against the reference's
  ``_local_banded_attention``, which the port does not carry: 1e-5.
* The attention module's ring chunk (chunk <, = and > the window, with a
  ragged and a zero-length row, on a full and a bucket-sliced ring), its
  one-shot rolling prefill and its rolling decode against the reference's
  ``attention()`` (``ref`` backend, fp32 compute): outputs 1e-4, ring
  contents after each write 1e-2 (bf16 leaves: one rounding of values
  that agree to 1e-4), and slots a write must leave alone bit for bit.
* reduced(gemma3-1b) (5:1 local:global, GQA 4:1) and the reference's
  ``local_pure`` and ``local_hybrid`` configs (``tests/test_chunked_prefill
  .py``), in fp32 compute as the reference pins them, with prompts past
  the window so the rings wrap: ``chunked_prefill`` logits 1e-4 and
  caches; ``decode_tokens`` under a bucket, token streams equal to the
  reference's and bit-identical to the unbucketed port; the engine's
  token streams equal to the reference engine's.  reduced(gemma3-1b) ties
  its embeddings at std 0.02, so its logits are ~0.4 and greedy steps can
  hang on top-2 gaps of ~3e-5, below the ~1e-4 that one flipped bf16
  rounding of a KV row moves them; its engine comparison runs both
  engines on fp32 caches, where only the order of sums differs (the
  other two configs keep the default bf16 caches).
* A decode past the window on the mixed model under a bucket larger than
  the window: every layer is handed ``valid_len <= `` its own extent.
* ``from_jax`` on a ``local`` layer's tree, and gemma3-1b's config,
  field for field.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.engine as j_engine
import repro.serving.prefill as j_prefill
from repro.configs import gemma3_1b as J_GEMMA
from repro.configs import reduced as j_reduced
from repro.core.config import AttnConfig as JAttnConfig
from repro.core.config import ModelConfig as JModelConfig
from repro.core.config import SSMConfig as JSSMConfig
from repro.kernels import dispatch
from repro.kernels.flash.kernel import flash_attention_pallas
from repro.kernels.flash.ref import attention_ref as j_attn
from repro.models import attention as jattention
from repro.models import lm as jlm
from repro.models import rope as jrope
import repro_torch.serving.engine as t_engine
import repro_torch.serving.prefill as t_prefill
from repro_torch.configs import gemma3_1b as T_GEMMA
from repro_torch.configs import reduced
from repro_torch.convert import from_jax, to_numpy
from repro_torch.core.config import AttnConfig
from repro_torch.core.config import ModelConfig
from repro_torch.core.config import SSMConfig
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.flash import ref as flash_ref
from repro_torch.models import attention, blocks, lm, rope
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.serving.prefill import chunked_prefill

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str = "float32"):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(got, want) -> float:
    """The reference kernel tests' measure: max error over max |o|."""
    g, w = _np(got), _np(want)
    return float(np.abs(g - w).max()) / (float(np.abs(w).max()) + 1e-6)


# ------------------------------------------------------ the ring layout
def _ring_from_linear(lin, wrap, window, ring_len):
    """The last ``window`` keys before each row's cursor in ring slots:
    slot j <- the newest position p < wrap with p % window == j."""
    ring = np.zeros(lin.shape[:2] + (ring_len,) + lin.shape[3:], lin.dtype)
    for bi, w in enumerate(wrap):
        for p in range(max(0, w - window), w):
            if p % window < ring_len:
                ring[bi, :, p % window] = lin[bi, :, p]
    return ring


@pytest.mark.parametrize("wrap,window,ring_len,sq,dtype", [
    ([0, 5, 19], 8, 8, 4, "float32"),      # cursors before/at/after the wrap
    ([0, 5, 19], 8, 8, 4, "bfloat16"),
    ([13, 64], 16, 16, 8, "float32"),
    ([3, 8], 16, 12, 4, "float32"),        # sliced ring: wrap + sq <= 12
    ([21, 40], 32, 32, 16, "float32"),
    ([0, 5, 19], 8, 8, 20, "float32"),     # a chunk longer than the window
])
def test_ring_plain_matches_reference(wrap, window, ring_len, sq, dtype):
    b, t = len(wrap), max(wrap) + sq
    r = np.random.default_rng(0)
    q, k_lin, v_lin = (r.standard_normal(s).astype(np.float32)
                       for s in ((b, 4, sq, 32), (b, 2, t, 32),
                                 (b, 2, t, 32)))
    ks, vs = ([np.concatenate([_ring_from_linear(lin, wrap, window,
                                                  ring_len),
                               np.stack([lin[bi, :, w:w + sq]
                                         for bi, w in enumerate(wrap)])],
                              axis=2) for lin in (k_lin, v_lin)])
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, ks, vs))
    off = np.asarray(wrap, np.int32)
    got = flash_ops.flash_attention(
        tq, tk, tv, causal=True, window=window,
        q_offset=torch.from_numpy(off), kv_wrap=torch.from_numpy(off),
        ring_len=ring_len)
    assert got.dtype == tq.dtype
    kw = dict(causal=True, window=window, ring_len=ring_len)
    joff = jnp.asarray(off)
    tol = 2e-4 if dtype == "float32" else 2e-2
    want = jax.jit(functools.partial(j_attn, **kw))(
        jq, jk, jv, q_offset=joff, kv_wrap=joff)
    assert _err(got, want) < tol
    pallas = jax.jit(functools.partial(
        flash_attention_pallas, block_q=8, block_k=8, interpret=True, **kw))
    assert _err(got, pallas(jq, jk, jv, q_offset=joff, kv_wrap=joff)) < tol
    # the ring unrolled: windowed attention over the linear keys
    jl = [_pair(a, dtype)[0] for a in (k_lin, v_lin)]
    lin = jax.jit(functools.partial(j_attn, causal=True, window=window))
    assert _err(got, lin(jq, *jl, q_offset=joff)) < tol


@pytest.mark.parametrize("s", [40, 37])
def test_windowed_ref_matches_banded(s):
    """The reference lowers a long windowed prompt (S > 2 * window) to its
    two-block banded attention; the port's one plain version computes the
    same function."""
    w, b, kv, g, hd = 8, 2, 2, 2, 16
    r = np.random.default_rng(1)
    q = r.standard_normal((b, s, kv, g, hd)).astype(np.float32)
    k, v = (r.standard_normal((b, s, kv, hd)).astype(np.float32)
            for _ in range(2))
    want = jattention._local_banded_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=w)
    got = flash_ops.flash_attention(
        torch.from_numpy(q).reshape(b, s, kv * g, hd).transpose(1, 2),
        torch.from_numpy(k).transpose(1, 2),
        torch.from_numpy(v).transpose(1, 2), causal=True, window=w)
    got = got.transpose(1, 2).reshape(b, s, kv, g, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------- the attention module
A_CFG = dict(n_heads=4, n_kv_heads=2, head_dim=16)
D_MODEL, W = 32, 8


def _attn_params(seed=2):
    r = np.random.default_rng(seed)
    h, kv, hd = A_CFG["n_heads"], A_CFG["n_kv_heads"], A_CFG["head_dim"]
    p = {"wq": r.standard_normal((D_MODEL, h, hd)) / np.sqrt(D_MODEL),
         "wk": r.standard_normal((D_MODEL, kv, hd)) / np.sqrt(D_MODEL),
         "wv": r.standard_normal((D_MODEL, kv, hd)) / np.sqrt(D_MODEL),
         "wo": r.standard_normal((h, hd, D_MODEL)) / np.sqrt(h * hd) / 2}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _run_module(s, pos, lens, rows, seed=3):
    """One ``attention()`` call of ``s`` tokens per row on both sides over
    a ring of ``rows`` slots holding random bf16 rows (window W), rope
    theta 1e4 from tables of 64 positions.  ``pos`` None is a one-shot
    prefill.  Returns ((jy, j_ring), (ty, t_ring), ring before)."""
    b = 3 if pos is None else len(pos)
    r = np.random.default_rng(seed)
    p = _attn_params()
    x = r.standard_normal((b, s, D_MODEL)).astype(np.float32)
    ring = r.standard_normal((2, b, rows, A_CFG["n_kv_heads"],
                              A_CFG["head_dim"])).astype(np.float32)
    ring = torch.from_numpy(ring).to(torch.bfloat16)
    ja, ta = JAttnConfig(**A_CFG), AttnConfig(**A_CFG)
    jc = {"k": jnp.asarray(ring[0].float().numpy(), jnp.bfloat16),
          "v": jnp.asarray(ring[1].float().numpy(), jnp.bfloat16)}
    tc = {"k": ring[0].clone(), "v": ring[1].clone()}
    j_rope = jrope.rope_tables(64, A_CFG["head_dim"], 10_000.0)
    t_tab = rope.rope_tables(64, A_CFG["head_dim"], 10_000.0, "cpu")
    jpos = tpos = mask = None
    if pos is not None:
        jpos = jnp.asarray(pos, jnp.int32)
        tpos = torch.tensor(pos, dtype=torch.int32)
        if lens is not None:
            mask = np.arange(s)[None, :] < np.asarray(lens)[:, None]
    with dispatch.use_backend("ref"):
        jy, jnc = jax.jit(lambda p_, x_, c_, pos_, m_: jattention.attention(
            p_, x_, ja, rope=j_rope, window=W, cache=c_, pos=pos_,
            eps=1e-5, chunk_mask=m_))(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jc,
            jpos, None if mask is None else jnp.asarray(mask))
    ty, tnc = attention.attention(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        ta, rope=rope.rope_at(t_tab, tpos, s, torch.float32), window=W,
        cache=tc, pos=tpos, eps=1e-5,
        chunk_mask=None if mask is None else torch.from_numpy(mask))
    assert tnc["k"] is tc["k"] and tnc["v"] is tc["v"]      # in place
    return (jy, jnc), (ty, tnc), ring


def _check_ring(t_ring, j_ring, before, keep):
    """Ring contents within one bf16 rounding of the reference's; slots
    ``keep`` (a [B, R] bool mask) untouched, bit for bit."""
    for i, key in enumerate(("k", "v")):
        got = t_ring[key]
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(j_ring[key]), rtol=1e-2,
                                   atol=1e-2)
        kept = torch.from_numpy(keep)
        assert torch.equal(got[kept], before[i][kept])


@pytest.mark.parametrize("s", [5, 8, 13], ids=["lt", "eq", "gt"])
def test_ring_chunk_matches_reference(s):
    """A chunk against the full ring at cursors before, at and after the
    wrap; row 1 is ragged (s - 2 valid), row 2 inert (0 valid): only the
    slots of valid tokens change."""
    pos, lens = [3, 8, 21], [s, s - 2, 0]
    (jy, jnc), (ty, tnc), before = _run_module(s, pos, lens, W)
    assert float(np.abs(_np(ty) - _np(jy)).max()) < 1e-4
    keep = np.ones((3, W), bool)
    for bi, (p_, n) in enumerate(zip(pos, lens)):
        for i in range(n):
            keep[bi, (p_ + i) % W] = False
    _check_ring(tnc, jnc, before, keep)


def test_sliced_ring_chunk_matches_reference():
    """A ring a bucket sliced to 6 < W rows before it wrapped."""
    pos, lens = [0, 1], [4, 3]
    (jy, jnc), (ty, tnc), before = _run_module(4, pos, lens, 6)
    assert float(np.abs(_np(ty) - _np(jy)).max()) < 1e-4
    keep = np.ones((2, 6), bool)
    keep[0, 0:4] = keep[1, 1:4] = False
    _check_ring(tnc, jnc, before, keep)


@pytest.mark.parametrize("s", [5, 8, 13], ids=["lt", "eq", "gt"])
def test_rolling_prefill_matches_reference(s):
    """One-shot prefill into a ring: the last W tokens rolled into their
    slots, a short prompt padded with zeros."""
    (jy, jnc), (ty, tnc), before = _run_module(s, None, None, W)
    assert float(np.abs(_np(ty) - _np(jy)).max()) < 1e-4
    _check_ring(tnc, jnc, before, np.zeros((3, W), bool))


def test_rolling_decode_matches_reference():
    """Decode at pos 3 (before the wrap), 8 (at it) and 21: the write lands
    at pos % W and the step attends min(pos + 1, W) slots."""
    pos = [3, 8, 21]
    (jy, jnc), (ty, tnc), before = _run_module(1, pos, None, W)
    assert float(np.abs(_np(ty) - _np(jy)).max()) < 1e-4
    keep = np.ones((3, W), bool)
    for bi, p_ in enumerate(pos):
        keep[bi, p_ % W] = False
    _check_ring(tnc, jnc, before, keep)


# ------------------------------------------------------------ the models
def _local_cfgs(M, A, S):
    """The reference's rolling-window test configs
    (tests/test_chunked_prefill.py), fp32 compute."""
    a = A(n_heads=4, n_kv_heads=2, head_dim=16, sliding_window=8)
    return {
        "local_pure": M(name="local_pure", family="dense", n_layers=2,
                        d_model=64, d_ff=128, vocab_size=97,
                        compute_dtype="float32", attn=a,
                        layer_pattern=("local",), vocab_pad_multiple=16),
        "local_hybrid": M(name="local_hybrid", family="hybrid", n_layers=2,
                          d_model=64, d_ff=128, vocab_size=97,
                          compute_dtype="float32", attn=a,
                          ssm=S(d_state=16, headdim=16, chunk=8),
                          layer_pattern=("local", "mamba2"),
                          vocab_pad_multiple=16),
    }


ARCHS = ("gemma3", "local_pure", "local_hybrid")


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(arch):
        if arch not in built:
            if arch == "gemma3":
                jcfg = dataclasses.replace(j_reduced(J_GEMMA, vocab=250),
                                           compute_dtype="float32")
                tcfg = dataclasses.replace(reduced(T_GEMMA, vocab=250),
                                           compute_dtype="float32")
            else:
                jcfg = _local_cfgs(JModelConfig, JAttnConfig,
                                   JSSMConfig)[arch]
                tcfg = _local_cfgs(ModelConfig, AttnConfig, SSMConfig)[arch]
            jp = jlm.init_lm_params(jcfg, jax.random.PRNGKey(0))
            tp = from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
            built[arch] = (jcfg, tcfg, jp, tp)
        return built[arch]
    return get


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _clone(cache):
    return {"segments": tree_map(torch.clone, cache["segments"]),
            "pos": cache["pos"].clone()}


@pytest.mark.parametrize("arch,chunk", [
    ("gemma3", 5), ("gemma3", 8), ("gemma3", 13), ("local_pure", 5),
    ("local_hybrid", 13)])
def test_chunked_prefill_and_decode_match_reference(arch, chunk, models):
    """A 21-token prompt (the ring wraps twice) and a ragged 15-token one
    in chunks smaller than (5), equal to (8) and larger than (13) the
    window, the last wrapping inside one chunk: logits
    1e-4 of max(1, max |logit|), pos, every cache leaf (bf16 leaves 1e-2);
    then 6 greedy tokens under a 32-row bucket equal the reference's and
    the unbucketed port's, and the bucketed cache is bit-identical."""
    jcfg, tcfg, jp, tp = models(arch)
    B, L, MS = 2, 21, 40
    toks = _tokens(B, L, tcfg.vocab_size, seed=2)
    lens = [L, 15]
    t_lg, t_cache = chunked_prefill(
        tcfg, tp, torch.from_numpy(toks),
        lm.init_lm_cache(tcfg, B, MS, device="cpu"), chunk_size=chunk,
        lengths=lens)
    j_lg, j_cache = j_prefill.chunked_prefill(
        jcfg, jp, jnp.asarray(toks), jlm.init_lm_cache(jcfg, B, MS),
        chunk_size=chunk, lengths=lens)
    w = np.asarray(j_lg, np.float32)
    assert (float(np.abs(to_numpy(t_lg) - w).max())
            <= 1e-4 * max(1.0, float(np.abs(w).max())))
    assert t_cache["pos"].tolist() == np.asarray(j_cache["pos"]).tolist()
    for a, b in zip(jax.tree_util.tree_leaves(j_cache["segments"]),
                    tree_leaves(t_cache["segments"])):
        tol = 1e-2 if b.dtype == torch.bfloat16 else 1e-4
        np.testing.assert_allclose(to_numpy(b), np.asarray(a, np.float32),
                                   rtol=tol, atol=tol)
    first = torch.argmax(t_lg[..., :tcfg.vocab_size], -1).to(torch.int32)
    j_first = jnp.argmax(j_lg[..., :jcfg.vocab_size], -1).astype(jnp.int32)
    assert np.array_equal(np.asarray(j_first), first.numpy())
    full, full_cache = lm.decode_tokens(tcfg, tp, _clone(t_cache), first, 6)
    bucketed, b_cache = lm.decode_tokens(tcfg, tp, _clone(t_cache), first, 6,
                                         kv_bucket=32)
    assert torch.equal(full, bucketed)
    for a, b in zip(tree_leaves(full_cache["segments"]),
                    tree_leaves(b_cache["segments"])):
        assert torch.equal(a, b)
    j_toks, _ = jlm.decode_tokens(jcfg, jp, j_cache, j_first, 6,
                                  kv_bucket=32)
    np.testing.assert_array_equal(np.asarray(j_toks), bucketed.numpy())


def test_decode_past_window_clamps_valid_len_per_layer(models,
                                                       monkeypatch):
    """The mixed model decodes at pos > window under a bucket larger than
    the window: the global layers attend min(pos + 1, bucket) rows, the
    rings min(pos + 1, window) slots, and the tokens equal the
    reference's."""
    jcfg, tcfg, jp, tp = models("gemma3")
    toks = _tokens(2, 19, tcfg.vocab_size, seed=4)
    cache = lm.init_lm_cache(tcfg, 2, 64, device="cpu")
    lg, cache = chunked_prefill(tcfg, tp, torch.from_numpy(toks), cache,
                                chunk_size=8)
    seen = []
    real = blocks.attention

    def spy(p, x, a, *, cache=None, valid_len=None, window=None, **kw):
        if valid_len is not None:
            seen.append((window, cache["k"].shape[1], valid_len.tolist()))
        return real(p, x, a, cache=cache, valid_len=valid_len,
                    window=window, **kw)
    monkeypatch.setattr(blocks, "attention", spy)
    first = torch.argmax(lg[..., :tcfg.vocab_size], -1).to(torch.int32)
    got, _ = lm.decode_tokens(tcfg, tp, cache, first, 3, kv_bucket=32)
    assert {(w, rows) for w, rows, _ in seen} == {(8, 8), (None, 32)}
    for w, rows, vl in seen:
        # positions 19, 20, 21: the rings attend all 8 slots
        assert vl == ([8, 8] if w else [vl[0]] * 2) and max(vl) <= rows
        assert w or 20 <= vl[0] <= 22
    j_lg, j_cache = j_prefill.chunked_prefill(
        jcfg, jp, jnp.asarray(toks), jlm.init_lm_cache(jcfg, 2, 64),
        chunk_size=8)
    j_first = jnp.argmax(j_lg[..., :jcfg.vocab_size], -1).astype(jnp.int32)
    want, _ = jlm.decode_tokens(jcfg, jp, j_cache, j_first, 3, kv_bucket=32)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_reference_engine(arch, models, monkeypatch):
    """5 ragged requests (prompts past the window) through 2 slots:
    per-request streams equal the reference engine's.  reduced(gemma3-1b)
    runs both engines on fp32 caches (module docstring)."""
    jcfg, tcfg, jp, tp = models(arch)
    if arch == "gemma3":
        j_init = functools.partial(jlm.init_lm_cache, dtype=jnp.float32)
        t_init = functools.partial(lm.init_lm_cache, dtype=torch.float32)
        for mod, fn in ((j_engine, j_init), (j_prefill, j_init),
                        (t_engine, t_init), (t_prefill, t_init)):
            monkeypatch.setattr(mod, "init_lm_cache", fn)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, tcfg.vocab_size, n).astype(np.int32)
               for n in (9, 17, 12, 9, 23)]
    kw = dict(slots=2, max_seq=64, decode_block=4, chunk_size=8)
    jeng = j_engine.ServingEngine(jcfg, jp, **kw)
    teng = t_engine.ServingEngine(tcfg, tp, device="cpu", **kw)
    for i, p in enumerate(prompts):
        jeng.submit(j_engine.Request(rid=i, prompt=p, max_new=10))
        teng.submit(t_engine.Request(rid=i, prompt=p, max_new=10))
    j_out = {r.rid: r.out for r in jeng.run()}
    t_done = teng.run()
    assert [r.status for r in t_done] == ["ok"] * len(prompts)
    assert {r.rid: r.out for r in t_done} == j_out


def test_local_trees_match_reference(models):
    """``from_jax`` carries a ``local`` layer's params across: the port's
    own param and cache trees have the reference's structure and shapes,
    and a ``local`` layer's param keys are a ``dense`` layer's."""
    jcfg, tcfg, jp, tp = models("gemma3")
    own = lm.init_lm_params(tcfg, device="cpu")
    for a, b in ((jax.tree_util.tree_map(np.asarray, jp), to_numpy(own)),
                 (to_numpy(tp), to_numpy(own)),
                 (jax.tree_util.tree_map(np.asarray,
                                         jlm.init_lm_cache(jcfg, 2, 40)),
                  to_numpy(lm.init_lm_cache(tcfg, 2, 40, device="cpu")))):
        assert (jax.tree_util.tree_structure(a)
                == jax.tree_util.tree_structure(b))
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            assert x.shape == y.shape
    unit = tp["segments"][0]
    assert blocks.layer_param_defs(tcfg, "local").keys() == unit[5].keys()
    assert unit[0].keys() == unit[5].keys()


def test_gemma3_config_matches_reference():
    """gemma3-1b field for field: 26 layers of which 22 ``local`` over
    512-slot rings and 4 global, head_dim 256, GQA 4:1, tied embeddings;
    its caches hold 512-slot rings and max_seq-row global leaves."""
    want, got = J_GEMMA, T_GEMMA
    for f in dataclasses.fields(got):
        val = getattr(got, f.name)
        if dataclasses.is_dataclass(val):
            for g in dataclasses.fields(val):
                assert getattr(val, g.name) == getattr(
                    getattr(want, f.name), g.name), (f.name, g.name)
        else:
            assert val == getattr(want, f.name), f.name
    assert got.segments() == want.segments() == (
        (("local",) * 5 + ("dense",), 4), (("local", "local"), 1))
    assert got.layer_kinds.count("local") == 22
    cfg = reduced(got)
    cache = lm.init_lm_cache(cfg, 2, 40, device="cpu")
    rows = {leaf.shape[2] for leaf in tree_leaves(cache["segments"])}
    assert rows == {cfg.attn.sliding_window, 40}
    assert lm.cache_kv_extent(cache) == 40
