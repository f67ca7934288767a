"""The Mamba-1 slice against the reference, on the CPU.

Same numpy inputs (or the reference's params, carried across with
``from_jax``) on both sides; reduced(mamba-130m) is d_model 64, d_inner
128, d_state 16, dt_rank 4, 2 layers, vocab 250 (so the padded-vocab
mask is live).  Tolerances:

* The plain selective scan against the reference's oracle
  (``scan1/ref.py``), its Pallas kernel in interpret mode and its
  in-model associative scan: y within 2e-4 (fp32) or 3e-2 (bf16) of
  max |y|, the final state within 1e-3 — the reference's own scan-kernel
  tolerances (``tests/test_scan1_kernel.py``).
* The plain Mamba-1 decode step against the reference's oracle
  (``decode_fused/ref.py``, not the Pallas kernel, whose fp32 output is
  itself 1.14x outside its test's budget): 1e-5 (fp32) or 2e-2 (bf16)
  of max |output|, per output; |y| reaches ~1e4 on these inputs.
* ``mamba1_block`` (masked and unmasked) and ``mamba1_decode`` against
  the reference's: 1e-4 (fp32) or 2e-2 (bf16) of max |output|; with the
  cache's slots (and the chunk's lengths handed down), bit for bit
  against the same calls without them, the conv state bit for bit
  against the reference's ``masked_conv_state``.
* Model level, fp32 compute: chunked prefill against the reference's
  (bf16 conv cache on both sides, so both round the carried window at the
  same chunk boundaries), logits 1e-4 of max(1, max |logit|) and cache
  leaves 1e-4 (bf16 leaves 1e-2); greedy token streams, ``decode_tokens``
  and the engine's, exactly.
* Chunked against one-shot prefill and mixed lengths against solo rows,
  port only, on fp32 caches: logits 1e-5 and greedy continuations
  exactly.  On a bf16 cache the chunked path rounds the conv window at
  every chunk boundary and the one-shot path does not; at this size the
  top two logits of a greedy step can lie 1e-2 apart, so a continuation
  may flip there without any fault.

The reference's fp32 ``decode_tokens`` cannot carry a bf16 conv cache
for Mamba-1 (its decode returns the window promoted to fp32, and
``lax.scan`` refuses the changed carry), so the tests that decode on both
sides use fp32 caches on both sides.
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
from repro.configs.paper_models import MAMBA1_130M as J_CFG
from repro.core.config import SSMConfig as JSSM
from repro.kernels.decode_fused.ref import mamba1_decode_fused_ref as j_dec
from repro.kernels.scan1.kernel import selective_scan_pallas
from repro.kernels.scan1.ref import selective_scan_ref as j_scan
from repro.models import lm as jlm
from repro.models import mamba1 as jm1
from repro.models import mamba2 as jm2
from repro.models.params import init_params as j_init_params
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.prefill import chunked_prefill as j_chunked_prefill
from repro_torch.configs import mamba_130m as T_CFG
from repro_torch.configs import reduced
from repro_torch.convert import from_jax, to_numpy
from repro_torch.core.config import SSMConfig
from repro_torch.kernels.decode_fused import ops as dec_ops
from repro_torch.kernels.scan1 import ops as scan_ops
from repro_torch.kernels.scan1 import ref as scan_ref
from repro_torch.kernels.ssd.ref import softplus
from repro_torch.models import lm
from repro_torch.models import mamba1 as m1
from repro_torch.models import mamba2 as m2
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.prefill import chunked_prefill

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SCAN_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
DEC_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BLOCK_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
D_MODEL = 64
KW = dict(d_state=16, variant="mamba1", conv_kernel=4)


def _pair(a, dtype):
    """The same numbers on both sides, rounded to ``dtype`` alike."""
    jd, td = DT[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want):
    """max |got - want| over max(1e-6, max |want|)."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    return float(np.abs(g - w).max()) / max(1e-6, float(np.abs(w).max()))


# ------------------------------------------------------------------ scan
def _scan_inputs(b, s, c, n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa
    dt = np.log1p(np.exp(f(b, s, c)))                      # post-softplus
    return (f(b, s, c), dt.astype(np.float32), -np.exp(f(c, n)), f(b, s, n),
            f(b, s, n), f(c), f(b, c, n))


@pytest.mark.parametrize("s", [32, 13])
@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_scan_plain_matches_reference(dtype, with_state, s):
    """The plain loop against the reference's oracle, its Pallas kernel
    (interpret mode; block_seq 16, or the whole sequence where 16 does not
    divide it) and its associative in-model scan."""
    b, c, n = 2, 128, 16
    x, dt, A, Bm, Cm, D, h0 = _scan_inputs(b, s, c, n, seed=s)
    jx, tx = _pair(x, dtype)
    jb, tb = _pair(Bm, dtype)
    jc, tc = _pair(Cm, dtype)
    jh0 = jnp.asarray(h0) if with_state else None
    th0 = torch.from_numpy(h0) if with_state else None
    got = scan_ops.selective_scan(tx, torch.from_numpy(dt),
                                  torch.from_numpy(A), tb, tc,
                                  torch.from_numpy(D), initial_state=th0)
    assert got[0].dtype == DT[dtype][1] and got[1].dtype == torch.float32
    jargs = (jx, jnp.asarray(dt), jnp.asarray(A), jb, jc, jnp.asarray(D))
    wants = {
        "oracle": j_scan(*jargs, initial_state=jh0),
        "pallas": selective_scan_pallas(
            *jargs, initial_state=jh0, block_seq=16 if s % 16 == 0 else s,
            block_ch=128, interpret=True),
        "associative": jm1.selective_scan(*jargs, initial_state=jh0,
                                          chunk=16),
    }
    for name, (wy, wh) in wants.items():
        assert _rel(got[0], wy) < SCAN_TOL[dtype], name
        np.testing.assert_allclose(_np(got[1]), _np(wh), rtol=1e-3,
                                   atol=1e-3, err_msg=name)


@pytest.mark.parametrize("s", [64, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_scale_scan_inputs_match_reference(dtype, s):
    """``scan1.ref.model_scale_inputs`` (the draws the card's checks use
    to see a dropped carry), handed to both sides as numpy: the plain
    scan against the reference's oracle, its Pallas kernel in interpret
    mode (block_seq 16, or the whole sequence where 16 does not divide
    it) and its associative in-model scan, at the scan tolerances.  The
    draws are at the model's scales: exp(dt * A) within [0.1, 1), so a
    state outlives many steps, and a warmed-up initial state."""
    b, c, n = 2, 128, 16
    td = DT[dtype][1]
    gen = torch.Generator().manual_seed(s)
    (x, dt, A, Bm, Cm, D), h0 = scan_ref.model_scale_inputs(gen, b, s, c, n,
                                                            td)
    da = torch.exp(dt[..., None] * A)
    assert float(da.min()) > 0.1 and float(da.max()) < 1.0
    assert x.dtype == Bm.dtype == Cm.dtype == td
    assert float(h0.abs().mean()) > 1e-3
    got = scan_ops.selective_scan(x, dt, A, Bm, Cm, D, initial_state=h0)
    j = {k: jnp.asarray(_np(v)).astype(DT[dtype][0] if k in "xBC"
                                        else jnp.float32)
         for k, v in dict(x=x, dt=dt, A=A, B=Bm, C=Cm, D=D).items()}
    jargs = (j["x"], j["dt"], j["A"], j["B"], j["C"], j["D"])
    jh0 = jnp.asarray(h0.numpy())
    wants = {
        "oracle": j_scan(*jargs, initial_state=jh0),
        "pallas": selective_scan_pallas(
            *jargs, initial_state=jh0, block_seq=16 if s % 16 == 0 else s,
            block_ch=128, interpret=True),
        "associative": jm1.selective_scan(*jargs, initial_state=jh0,
                                          chunk=16),
    }
    for name, (wy, wh) in wants.items():
        assert _rel(got[0], wy) < SCAN_TOL[dtype], name
        np.testing.assert_allclose(_np(got[1]), _np(wh), rtol=1e-3,
                                   atol=1e-3, err_msg=name)


def test_selective_scan_inert_tokens_keep_the_state():
    """dt = softplus(-30) (a masked token) leaves the state as it was."""
    b, s, c, n = 1, 5, 8, 16
    x, _, A, Bm, Cm, D, h0 = _scan_inputs(b, s, c, n, seed=7)
    inert = softplus(torch.full((b, s, c), m2.INERT_DT))
    _, h = scan_ops.selective_scan(
        torch.from_numpy(x), inert, torch.from_numpy(A), torch.from_numpy(Bm),
        torch.from_numpy(Cm), torch.from_numpy(D),
        initial_state=torch.from_numpy(h0))
    np.testing.assert_allclose(h.numpy(), h0, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------- decode step
def _decode_inputs(b, di, n, dtr, k, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa
    return (f(b, k - 1, di), f(b, di, n), f(b, di), f(di, k), f(di),
            f(di, dtr + 2 * n), f(dtr, di), f(di), f(di, n), f(di))


@pytest.mark.parametrize("b,di,n,dtr", [(2, 128, 16, 4), (1, 96, 8, 6)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba1_decode_plain_matches_reference(dtype, b, di, n, dtr):
    """Against the reference's oracle, per output, relative to its max."""
    conv, ssm, xi, w, cb, xp, dtp, dtb, al, D = _decode_inputs(
        b, di, n, dtr, 4, seed=di)
    jconv, tconv = _pair(conv, dtype)
    jxi, txi = _pair(xi, dtype)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    kw = dict(d_state=n, dt_rank=dtr)
    got = dec_ops.mamba1_decode_fused(tconv, t(ssm), txi, t(w), t(cb), t(xp),
                                      t(dtp), t(dtb), t(al), t(D), **kw)
    want = j_dec(jconv, jnp.asarray(ssm), jxi, *map(jnp.asarray, (
        w, cb, xp, dtp, dtb, al, D)), **kw)
    assert got[0].dtype == torch.float32 and got[2].dtype == torch.float32
    assert got[1].dtype == DT[dtype][1]
    for g, w_ in zip(got, want):
        assert _rel(g, w_) < DEC_TOL[dtype]


# ------------------------------------------------------------ the block
def _params():
    defs = jm1.mamba1_param_defs(D_MODEL, JSSM(**KW))
    jp = dict(j_init_params(defs, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    jp["conv_b"] = jnp.asarray(rng.standard_normal(jp["conv_b"].shape) * .1,
                               jnp.float32)
    return jp, from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _cache(b, rng, dtype):
    s = SSMConfig(**KW)
    di = s.d_inner(D_MODEL)
    conv = rng.standard_normal((b, s.conv_kernel - 1, di)).astype(np.float32)
    ssm = rng.standard_normal((b, di, s.d_state)).astype(np.float32)
    jconv, tconv = _pair(conv, dtype)
    return ({"conv": jconv, "ssm": jnp.asarray(ssm)},
            {"conv": tconv, "ssm": torch.from_numpy(ssm)})


def test_param_defs_match_reference():
    jd = jm1.mamba1_param_defs(D_MODEL, JSSM(**KW))
    td = m1.mamba1_param_defs(D_MODEL, SSMConfig(**KW))
    assert jd.keys() == td.keys()
    for k in jd:
        assert tuple(jd[k]) == tuple(td[k]), k
    assert m1.dt_rank(768, SSMConfig(**KW)) == jm1.dt_rank(768, JSSM(**KW))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba1_block_matches_reference(dtype, masked):
    """Prefill block with carried states; ``masked`` gives ragged rows
    (lengths 13, 5, 0)."""
    jp, tp = _params()
    b, s = 3, 13
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.standard_normal((b, s, D_MODEL)).astype(np.float32),
                   dtype)
    jc, tc = _cache(b, rng, dtype)
    lens = np.array([13, 5, 0], np.int32)
    mask = np.arange(s)[None, :] < lens[:, None]
    j_out, j_new = jm1.mamba1_block(jp, jx, JSSM(**KW), D_MODEL, cache=jc,
                                    mask=jnp.asarray(mask) if masked else None)
    t_out, t_new = m1.mamba1_block(tp, tx, SSMConfig(**KW), D_MODEL,
                                   cache=tc,
                                   mask=torch.from_numpy(mask) if masked
                                   else None,
                                   lengths=torch.from_numpy(lens) if masked
                                   else None)
    assert t_out.dtype == DT[dtype][1]
    assert _rel(t_out, j_out) < BLOCK_TOL[dtype]
    for key in ("conv", "ssm"):
        assert _rel(t_new[key], j_new[key]) < BLOCK_TOL[dtype], key
        assert t_new[key].dtype == tc[key].dtype
    if masked:   # a zero-length row passes both states through
        assert torch.equal(t_new["conv"][2], tc["conv"][2])
        np.testing.assert_allclose(t_new["ssm"][2].numpy(),
                                   tc["ssm"][2].numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba1_block_writes_conv_slot(dtype):
    """Ragged rows (lengths 13, 5, 0) with ``lengths`` handed down beside
    the mask, as ``lm_prefill_chunk`` does, and the conv state's slot: the
    conv state lands in the slot and is the reference's
    ``masked_conv_state`` bit for bit; the outputs and states equal those
    of the call without the slot, bit for bit; the cache is unchanged."""
    jp, tp = _params()
    b, s = 3, 13
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.standard_normal((b, s, D_MODEL)).astype(np.float32),
                   dtype)
    jc, tc = _cache(b, rng, dtype)
    before = {k: v.clone() for k, v in tc.items()}
    lens = np.array([13, 5, 0], np.int32)
    mask = np.arange(s)[None, :] < lens[:, None]
    slot = torch.full_like(tc["conv"], 7.0)
    out, new = m1.mamba1_block(tp, tx, SSMConfig(**KW), D_MODEL, cache=tc,
                               mask=torch.from_numpy(mask),
                               lengths=torch.from_numpy(lens),
                               slots={"conv": slot})
    want_out, want = m1.mamba1_block(tp, tx, SSMConfig(**KW), D_MODEL,
                                     cache=tc, mask=torch.from_numpy(mask),
                                     lengths=torch.from_numpy(lens))
    assert new["conv"].data_ptr() == slot.data_ptr()
    assert torch.equal(out, want_out)
    for key in ("conv", "ssm"):
        assert torch.equal(new[key], want[key]), key
        assert torch.equal(tc[key], before[key]), key
    xi = jx @ jp["wx"].astype(jx.dtype)
    j_conv = jm2.masked_conv_state(jc["conv"], xi, jnp.asarray(mask),
                                   KW["conv_kernel"])
    np.testing.assert_array_equal(_np(new["conv"]), _np(j_conv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba1_decode_writes_slots(dtype):
    """A decode step with the layer's slots: the new window and state land
    there, equal the step without slots bit for bit, and the cache is
    unchanged."""
    jp, tp = _params()
    b = 2
    rng = np.random.default_rng(2)
    _, tx = _pair(rng.standard_normal((b, 1, D_MODEL)).astype(np.float32),
                  dtype)
    _, tc = _cache(b, rng, dtype)
    before = {k: v.clone() for k, v in tc.items()}
    slots = {k: torch.full_like(v, 7.0) for k, v in tc.items()}
    out, new = m1.mamba1_decode(tp, tx, SSMConfig(**KW), D_MODEL, cache=tc,
                                slots=slots)
    want_out, want = m1.mamba1_decode(tp, tx, SSMConfig(**KW), D_MODEL,
                                      cache=tc)
    assert torch.equal(out, want_out)
    for key in ("conv", "ssm"):
        assert new[key].data_ptr() == slots[key].data_ptr(), key
        assert torch.equal(new[key], want[key]), key
        assert torch.equal(tc[key], before[key]), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba1_decode_matches_reference(dtype):
    jp, tp = _params()
    b = 2
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng.standard_normal((b, 1, D_MODEL)).astype(np.float32),
                   dtype)
    jc, tc = _cache(b, rng, dtype)
    j_out, j_new = jm1.mamba1_decode(jp, jx, JSSM(**KW), D_MODEL, cache=jc)
    t_out, t_new = m1.mamba1_decode(tp, tx, SSMConfig(**KW), D_MODEL,
                                    cache=tc)
    assert t_out.shape == (b, 1, D_MODEL) and t_out.dtype == DT[dtype][1]
    assert _rel(t_out, j_out) < BLOCK_TOL[dtype]
    for key in ("conv", "ssm"):
        assert _rel(t_new[key], j_new[key]) < BLOCK_TOL[dtype], key
        assert t_new[key].dtype == tc[key].dtype


# ---------------------------------------------------------- model level
@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(j_reduced(J_CFG, vocab=250),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(reduced(T_CFG, vocab=250),
                               compute_dtype="float32")
    jp = jlm.init_lm_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                    "cpu")


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _close(got, want, tol):
    g, w = to_numpy(got), np.asarray(want, np.float32)
    assert g.shape == w.shape
    err = float(np.abs(g - w).max())
    assert err <= tol * max(1.0, float(np.abs(w).max())), err


def _close_tree(got, want, tol):
    g = tree_leaves(got)
    w = [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        t = max(tol, 1e-2) if a.dtype == torch.bfloat16 else tol
        np.testing.assert_allclose(to_numpy(a), b, rtol=t, atol=t)


def test_cache_and_params_layout_match_reference(model):
    jcfg, tcfg, jp, tp = model
    assert tcfg.ssm.d_inner(tcfg.d_model) == 128
    assert m1.dt_rank(tcfg.d_model, tcfg.ssm) == 4
    jc = jax.tree_util.tree_map(np.asarray, jlm.init_lm_cache(jcfg, 2, 40))
    tc = lm.init_lm_cache(tcfg, 2, 40, device="cpu")
    assert (jax.tree_util.tree_structure(jc)
            == jax.tree_util.tree_structure(to_numpy(tc)))
    for a, b in zip(jax.tree_util.tree_leaves(jc),
                    jax.tree_util.tree_leaves(to_numpy(tc))):
        assert a.shape == b.shape
    tinit = lm.init_lm_params(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, jp)),
            jax.tree_util.tree_leaves(to_numpy(tinit))):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_chunked_prefill_matches_reference(model):
    """Ragged last chunk (21 = 7 + 7 + 7 at chunk 7, then 21 at 8)."""
    jcfg, tcfg, jp, tp = model
    B, L, MS = 2, 21, 40
    toks = _tokens(B, L, tcfg.vocab_size, seed=2)
    for chunk in (7, 8):
        t_lg, t_cache = chunked_prefill(
            tcfg, tp, torch.from_numpy(toks),
            lm.init_lm_cache(tcfg, B, MS, device="cpu"), chunk_size=chunk)
        j_lg, j_cache = j_chunked_prefill(jcfg, jp, jnp.asarray(toks),
                                          jlm.init_lm_cache(jcfg, B, MS),
                                          chunk_size=chunk)
        _close(t_lg, j_lg, 1e-4)
        assert t_cache["pos"].tolist() == np.asarray(j_cache["pos"]).tolist()
        _close_tree(t_cache["segments"], j_cache["segments"], 1e-4)


def _f32_cache(cfg, b, max_seq):
    return lm.init_lm_cache(cfg, b, max_seq, device="cpu",
                            dtype=torch.float32)


def test_chunked_matches_one_shot(model):
    _, tcfg, _, tp = model
    B, L, MS = 2, 21, 40
    toks = torch.from_numpy(_tokens(B, L, tcfg.vocab_size, seed=3))
    ref_lg, ref_cache = lm.lm_prefill(tcfg, tp, toks,
                                      _f32_cache(tcfg, B, MS))
    lg, cache = chunked_prefill(tcfg, tp, toks, _f32_cache(tcfg, B, MS),
                                chunk_size=7)
    _close(lg, to_numpy(ref_lg), 1e-5)
    assert torch.equal(cache["pos"], ref_cache["pos"])
    first = torch.argmax(ref_lg[..., :tcfg.vocab_size], -1).to(torch.int32)
    a, _ = lm.decode_tokens(tcfg, tp, ref_cache, first, 8)
    b, _ = lm.decode_tokens(tcfg, tp, cache, first, 8)
    assert torch.equal(a, b)


def test_mixed_lengths_match_solo(model):
    """One padded batch of lengths 5/17/9: each row equals a batch-1
    prefill of its own prompt, and decodes the same continuation."""
    _, tcfg, _, tp = model
    MS, lens = 40, [5, 17, 9]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, tcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    padded = np.zeros((3, max(lens)), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
    lg, cache = chunked_prefill(tcfg, tp, torch.from_numpy(padded),
                                _f32_cache(tcfg, 3, MS), chunk_size=6,
                                lengths=lens)
    assert cache["pos"].tolist() == lens
    for i, p in enumerate(prompts):
        solo_lg, solo_cache = lm.lm_prefill(
            tcfg, tp, torch.from_numpy(p[None]), _f32_cache(tcfg, 1, MS))
        _close(lg[i], to_numpy(solo_lg[0]), 1e-5)
        row = {"segments": tree_map(lambda t: t[:, i:i + 1].clone(),
                                    cache["segments"]),
               "pos": cache["pos"][i:i + 1].clone()}
        first = torch.argmax(solo_lg[..., :tcfg.vocab_size], -1).to(
            torch.int32)
        a, _ = lm.decode_tokens(tcfg, tp, solo_cache, first, 6)
        b, _ = lm.decode_tokens(tcfg, tp, row, first, 6)
        assert torch.equal(a, b)


def test_decode_tokens_match_sequential_and_reference(model):
    """Greedy streams equal n sequential steps and the reference's
    ``decode_tokens`` exactly (fp32 caches on both sides)."""
    jcfg, tcfg, jp, tp = model
    toks = _tokens(2, 8, tcfg.vocab_size, seed=4)
    lg, cache = lm.lm_prefill(tcfg, tp, torch.from_numpy(toks),
                              _f32_cache(tcfg, 2, 32))
    first = torch.argmax(lg[..., :tcfg.vocab_size], -1).to(torch.int32)
    seq, c, tok = [], cache, first
    for _ in range(6):
        lg1, c = lm.lm_decode_step(tcfg, tp, tok, c)
        tok = torch.argmax(lg1[..., :tcfg.vocab_size], -1).to(torch.int32)
        seq.append(tok[:, 0])
    fused, f_cache = lm.decode_tokens(tcfg, tp, cache, first, 6)
    assert torch.equal(fused, torch.stack(seq, 1))
    for a, b in zip(tree_leaves(f_cache["segments"]),
                    tree_leaves(c["segments"])):
        assert torch.equal(a, b)
    j_lg, j_cache = jlm.lm_prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                   jlm.init_lm_cache(jcfg, 2, 32,
                                                     dtype=jnp.float32))
    _close(lg, j_lg, 1e-4)
    j_first = jnp.argmax(j_lg[..., :jcfg.vocab_size], -1).astype(jnp.int32)
    assert np.array_equal(np.asarray(j_first), first.numpy())
    j_toks, j_cache = jlm.decode_tokens(jcfg, jp, j_cache, j_first, 6)
    np.testing.assert_array_equal(np.asarray(j_toks), fused.numpy())
    _close_tree(f_cache["segments"], j_cache["segments"], 1e-4)


def test_engine_streams_match_reference_engine(model, monkeypatch):
    """5 ragged requests through 2 slots (fifo), chunked prefill: the last
    three are admitted mid-flight.  Per-request streams equal the
    reference engine's, both engines on fp32 caches."""
    jcfg, tcfg, jp, tp = model
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
        jeng.submit(JRequest(rid=i, prompt=p, max_new=10))
        teng.submit(Request(rid=i, prompt=p, max_new=10))
    j_out = {r.rid: r.out for r in jeng.run()}
    t_done = teng.run()
    assert [r.status for r in t_done] == ["ok"] * len(prompts)
    assert teng.cache["segments"][0][0]["conv"].dtype == torch.float32
    assert {r.rid: r.out for r in t_done} == j_out


@pytest.mark.parametrize("arch", ["mamba-130m", "mamba2-2.7b", "zamba2-2.7b"])
def test_prepare_params_casts_by_layer_kind(arch):
    """A mamba1 layer's five projections come out in bf16 and its conv and
    SSM parameters stay fp32; a mamba2 layer keeps its own set."""
    from repro_torch.core.registry import get
    cfg = reduced(get(arch))
    params = lm.prepare_params(cfg, lm.init_lm_params(cfg, device="cpu"))
    for (kinds, _), seg in zip(cfg.segments(), params["segments"]):
        for kind, layer in zip(kinds, seg):
            proj = m1.PROJ_KEYS if kind == "mamba1" else (
                "wz", "wxBC", "wdt", "out_proj")
            for key, val in layer["mamba"].items():
                want = torch.bfloat16 if key in proj else torch.float32
                assert val.dtype == want, (kind, key)
    if arch == "mamba-130m":
        assert set(layer["mamba"]) - set(m1.PROJ_KEYS) == {
            "A_log", "D", "dt_bias", "conv_w", "conv_b"}


# -------------------------------------------------------------- configs
def _port_archs():
    from repro_torch.core.registry import list_archs
    return list_archs()


def _fields(cfg):
    """A config's fields, nested configs as dicts of their own fields."""
    return {f.name: (_fields(getattr(cfg, f.name))
                     if dataclasses.is_dataclass(getattr(cfg, f.name))
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", _port_archs())
def test_registered_config_matches_reference(arch):
    """Every field of the port's config equals the reference's field of
    the same name (the reference's extra fields are sharding and
    training knobs the port does not have)."""
    from repro.core.registry import get as j_get
    from repro_torch.core.registry import get
    want = j_get(arch)
    got = get(arch)

    def same(g, w):
        for key, val in g.items():
            wv = getattr(w, key)
            if isinstance(val, dict):
                same(val, wv)
            else:
                assert val == wv, (arch, key)
    same(_fields(got), want)
    assert got.padded_vocab == want.padded_vocab
    assert got.layer_kinds == want.layer_kinds


def test_served_paper_configs_are_registered():
    """Each of the reference's paper models whose layer kinds the port
    serves is registered in the port."""
    from repro.core.registry import get as j_get
    from repro.core.registry import list_archs as j_list
    served = {"dense", "mamba1", "mamba2", "mamba2+shared", "hybrid_par"}
    want = {a for a in j_list("paper")
            if set(j_get(a).layer_kinds) <= served}
    assert want == {"qwen2.5-0.5b", "qwen2.5-1.5b", "llama3.2-1b",
                    "phi-3-mini", "mamba-130m", "mamba2-130m", "mamba2-780m",
                    "zamba2-1.2b", "falcon-h1-0.5b", "hymba-1.5b"}
    assert want <= set(_port_archs())
