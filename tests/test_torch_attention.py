"""The port's attention modules against the reference, on the CPU.

The same numpy inputs, made from a seed, go through the reference's JAX
function and the port's counterpart:

* ``rope_tables`` / ``apply_rope`` / ``rope_at``, ``mlp`` and the qk-norm
  (the reference's ``head_rms_norm``, the port's ``rms_norm``) — fp32 at
  1e-5 (elementwise math and small matmuls), bf16 at 2e-2;
* the plain attention versions (``flash.ref``, ``attn_decode.ref``)
  against the reference's oracles and its Pallas kernels run with
  ``interpret=True``, at the cases of the reference's own kernel tests —
  2e-4 in fp32 (its tolerance), 2e-2 of max |o| in bf16;
* the attention module in each ported cache mode against the reference's
  ``attention()``: in fp32 compute against its ``ref`` backend at 1e-4 (the
  port's plain path keeps fp32 probabilities, which the ``ref`` backend
  does in fp32 too), and in bf16 against its ``interpret`` backend, the
  Pallas semantics (fp32 probabilities), at 2e-2.  The ``ref`` backend
  rounds bf16 probabilities before P.V, so bf16 is not held against it.

The ring layout and sliding windows are held against the reference in
``tests/test_torch_local.py``; here only the kinds still unported raise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import AttnConfig as JAttnConfig
from repro.kernels import dispatch
from repro.kernels.attn_decode.kernel import decode_attention_pallas
from repro.kernels.flash.kernel import flash_attention_pallas
from repro.kernels.flash.ref import attention_ref as j_attn
from repro.kernels.flash.ref import decode_attention_ref as j_dec
from repro.kernels.flash.ref import ring_kv_positions as j_ring_pos
from repro.models import attention as jattention
from repro.models import mlp as jmlp
from repro.models import norms as jnorms
from repro.models import rope as jrope
from repro_torch.configs import reduced, zamba2_2p7b
from repro_torch.core.config import AttnConfig
from repro_torch.kernels.attn_decode import ops as dec_ops
from repro_torch.kernels.attn_decode import ref as dec_ref
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.flash import ref as flash_ref
from repro_torch.models import attention, blocks, mlp, norms, rope

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same numbers on both sides, rounded to ``dtype`` alike."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    g, w = _np(got), _np(want)
    return float(np.abs(g - w).max()) / max(1.0, float(np.abs(w).max()))


def _rng(seed=0):
    return np.random.default_rng(seed)


# ------------------------------------------------- rope, mlp, head norm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    j_sin, j_cos = jrope.rope_tables(40, 16, 500_000.0)
    t_sin, t_cos = rope.rope_tables(40, 16, 500_000.0, "cpu")
    assert t_sin.dtype == torch.float32
    np.testing.assert_allclose(t_sin.numpy(), np.asarray(j_sin), atol=1e-5)
    np.testing.assert_allclose(t_cos.numpy(), np.asarray(j_cos), atol=1e-5)
    # one table per (length, head_dim, theta, device)
    assert rope.rope_tables(40, 16, 500_000.0, "cpu")[0] is t_sin
    x = _rng(1).standard_normal((2, 7, 3, 16)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    # [S, half] tables, and per-row [B, S, half] gathers
    got = rope.apply_rope(tx, t_sin[:7], t_cos[:7])
    assert got.dtype == tx.dtype
    assert _rel(got, jrope.apply_rope(jx, j_sin[:7], j_cos[:7])) < tol
    idx = np.array([[0, 1, 2, 3, 4, 5, 6], [9, 10, 11, 12, 13, 14, 15]])
    got = rope.apply_rope(tx, t_sin[torch.from_numpy(idx)],
                          t_cos[torch.from_numpy(idx)])
    assert _rel(got, jrope.apply_rope(jx, j_sin[idx], j_cos[idx])) < tol
    # rope_at: the same rows from per-row offsets, cast once; a row that
    # runs past the table is clipped to its last row, as in the reference
    at = rope.rope_at((t_sin, t_cos), torch.tensor([0, 9], dtype=torch.int32),
                      7, tx.dtype)
    assert at[0].dtype == tx.dtype
    got_at = rope.apply_rope(tx, *at)
    assert torch.equal(got_at, got)
    s_at, _ = rope.rope_at((t_sin, t_cos), torch.tensor([36]), 7,
                           torch.float32)
    np.testing.assert_array_equal(s_at[0, 3:].numpy(),
                                  t_sin[39].expand(4, -1).numpy())
    np.testing.assert_array_equal(
        rope.rope_at((t_sin, t_cos), None, 7, torch.float32)[1].numpy(),
        t_cos[:7].numpy())


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_reference(dtype, act):
    r = _rng(2)
    p = {"wi": r.standard_normal((32, 64)) / 6, "wg": r.standard_normal(
        (32, 64)) / 6, "wo": r.standard_normal((64, 32)) / 8}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = r.standard_normal((2, 5, 32)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    want = jmlp.mlp({k: jnp.asarray(v) for k, v in p.items()}, jx, act)
    got = mlp.mlp({k: torch.from_numpy(v) for k, v in p.items()}, tx, act)
    assert got.dtype == tx.dtype
    assert _rel(got, want) < (1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_rms_norm_matches_reference(dtype):
    """The reference's qk-norm ``head_rms_norm`` is ``rms_norm`` over
    head_dim with eps 1e-6; the port calls ``rms_norm`` for it."""
    r = _rng(3)
    x = r.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = (r.standard_normal(16) * 0.1).astype(np.float32)
    jx, tx = _pair(x, dtype)
    want = jnorms.head_rms_norm(jx, jnp.asarray(scale))
    got = norms.rms_norm(tx, torch.from_numpy(scale), 1e-6)
    assert got.dtype == tx.dtype
    assert _rel(got, want) < (1e-5 if dtype == "float32" else 2e-2)


# ------------------------------------------- plain versions vs the oracles
def _err(got, want) -> float:
    """The reference kernel tests' measure: max error over max |o|."""
    g, w = _np(got), _np(want)
    return float(np.abs(g - w).max()) / (float(np.abs(w).max()) + 1e-6)


def _qkv(shape_q, shape_kv, dtype, seed):
    r = _rng(seed)
    return [_pair(r.standard_normal(s).astype(np.float32), dtype)
            for s in (shape_q, shape_kv, shape_kv)]


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_matches_reference(causal, window, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv((2, 8, 80, 32), (2, 2, 80, 32),
                                        dtype, 4)
    got = flash_ref.attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype
    assert torch.equal(flash_ops.flash_attention(tq, tk, tv, causal=causal,
                                                 window=window), got)
    tol = 2e-4 if dtype == "float32" else 2e-2
    assert _err(got, j_attn(jq, jk, jv, causal=causal, window=window)) < tol
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                    block_q=32, block_k=32, interpret=True)
    assert _err(got, pallas) < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_q_offset_matches_reference(dtype):
    """A short query chunk at per-row offsets against a longer KV prefix."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv((3, 4, 16, 32), (3, 2, 80, 32),
                                        dtype, 5)
    off = np.array([0, 13, 64], np.int32)
    got = flash_ops.flash_attention(tq, tk, tv, q_offset=torch.from_numpy(off))
    tol = 2e-4 if dtype == "float32" else 2e-2
    assert _err(got, j_attn(jq, jk, jv, q_offset=jnp.asarray(off))) < tol
    pallas = flash_attention_pallas(jq, jk, jv, q_offset=jnp.asarray(off),
                                    block_q=8, block_k=32, interpret=True)
    assert _err(got, pallas) < tol


def test_ring_positions_and_ring_ref_match_reference():
    """The ring layout's plain math (ref.py), the CPU path of the ring
    mode."""
    wrap = np.array([0, 3, 8, 13], np.int32)
    got = flash_ref.ring_kv_positions(torch.from_numpy(wrap), 8, 8, 12)
    want = j_ring_pos(jnp.asarray(wrap), 8, 8, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    (jq, tq), (jk, tk), (jv, tv) = _qkv((4, 4, 4, 16), (4, 2, 12, 16),
                                        "float32", 6)
    kw = dict(causal=True, window=8, ring_len=8)
    got = flash_ref.attention_ref(tq, tk, tv, q_offset=torch.from_numpy(wrap),
                                  kv_wrap=torch.from_numpy(wrap), **kw)
    want = j_attn(jq, jk, jv, q_offset=jnp.asarray(wrap),
                  kv_wrap=jnp.asarray(wrap), **kw)
    assert _err(got, want) < 2e-4


@pytest.mark.parametrize("split_k", [1, 2])
def test_decode_ref_matches_reference(split_k):
    b, h, kvh, s, d = 2, 8, 4, 200, 32
    (jq, tq), (jk, tk), (jv, tv) = _qkv((b, h, d), (b, kvh, s, d),
                                        "float32", 7)
    vl = _rng(0).integers(1, s, b).astype(np.int32)
    got = dec_ops.decode_attention(tq, tk, tv, valid_len=torch.from_numpy(vl))
    want = j_dec(jq, jk, jv, valid_len=jnp.asarray(vl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    pallas = decode_attention_pallas(jq, jk, jv, valid_len=jnp.asarray(vl),
                                     block_s=64, split_k=split_k,
                                     interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("edge", [1, 32, 33, 255, 256])
def test_decode_ref_split_edges_match_reference(edge):
    """valid_len on block and split edges (block 32, splits of 2 and 8)."""
    b, h, kvh, s, d = 2, 4, 2, 256, 16
    (jq, tq), (jk, tk), (jv, tv) = _qkv((b, h, d), (b, kvh, s, d),
                                        "float32", 8)
    vl = np.array([edge, s - edge + 1], np.int32)
    got = dec_ref.decode_attention_ref(tq, tk, tv,
                                       valid_len=torch.from_numpy(vl))
    for want in [j_dec(jq, jk, jv, valid_len=jnp.asarray(vl))] + [
            decode_attention_pallas(jq, jk, jv, valid_len=jnp.asarray(vl),
                                    block_s=32, split_k=sk, interpret=True)
            for sk in (2, 8)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)


# ------------------------------------------------- the attention module
A_CFG = dict(n_heads=4, n_kv_heads=2, head_dim=16)
D_MODEL, SKV = 32, 24


def _attn_params(qk_norm: bool, seed=9):
    r = _rng(seed)
    h, kv, hd = A_CFG["n_heads"], A_CFG["n_kv_heads"], A_CFG["head_dim"]
    p = {"wq": r.standard_normal((D_MODEL, h, hd)) / np.sqrt(D_MODEL),
         "wk": r.standard_normal((D_MODEL, kv, hd)) / np.sqrt(D_MODEL),
         "wv": r.standard_normal((D_MODEL, kv, hd)) / np.sqrt(D_MODEL),
         "wo": r.standard_normal((h, hd, D_MODEL)) / np.sqrt(h * hd) / 2}
    if qk_norm:
        p["q_norm"] = r.standard_normal(hd) * 0.1
        p["k_norm"] = r.standard_normal(hd) * 0.1
    return {k: v.astype(np.float32) for k, v in p.items()}


MODES = {
    # (tokens per row, cache rows pre-filled, pos)
    "none": (12, None, None),
    "prefill": (12, 0, None),
    # rows at offsets 3 and 20: the second writes rows 20..23 and drops
    # the two rows past the cache
    "chunk": (6, SKV, [3, 20]),
    # the last row sits past the cache (a retired slot): it writes nothing
    "decode": (1, SKV, [5, 23, 30]),
}


def _run_both(mode, dtype, qk_norm, backend):
    s, filled, pos = MODES[mode]
    b = 3 if mode == "decode" else 2
    r = _rng(10)
    p = _attn_params(qk_norm)
    x = r.standard_normal((b, s, D_MODEL)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    ja = JAttnConfig(qk_norm=qk_norm, **A_CFG)
    ta = AttnConfig(qk_norm=qk_norm, **A_CFG)
    j_rope = jrope.rope_tables(SKV, A_CFG["head_dim"], ja.rope_theta)
    t_rope = rope.rope_tables(SKV, A_CFG["head_dim"], ta.rope_theta, "cpu")
    jc = tc = None
    if filled is not None:
        kv = r.standard_normal((2, b, SKV, A_CFG["n_kv_heads"],
                                A_CFG["head_dim"])).astype(np.float32)
        kv[:, :, filled:] = 0.0
        jc = {"k": jnp.asarray(kv[0], jnp.bfloat16),
              "v": jnp.asarray(kv[1], jnp.bfloat16)}
        tc = {"k": torch.from_numpy(kv[0]).to(torch.bfloat16),
              "v": torch.from_numpy(kv[1]).to(torch.bfloat16)}
    jpos = tpos = mask = None
    if pos is not None:
        jpos = jnp.asarray(pos, jnp.int32)
        tpos = torch.tensor(pos, dtype=torch.int32)
        if s > 1:
            lens = np.array([s, s - 2])
            mask = np.arange(s)[None, :] < lens[:, None]
    with dispatch.use_backend(backend):
        jy, jnc = jattention.attention(
            {k: jnp.asarray(v) for k, v in p.items()}, jx, ja, rope=j_rope,
            cache=jc, pos=jpos, eps=1e-5,
            chunk_mask=None if mask is None else jnp.asarray(mask))
    # the port takes the tables at the call's positions (rope_at), as a
    # model builds them once for all its layers; the reference gathers them
    # inside attention()
    t_rope = rope.rope_at(t_rope, tpos if tc is not None else None, s,
                          tx.dtype)
    ty, tnc = attention.attention(
        {k: torch.from_numpy(v) for k, v in p.items()}, tx, ta, rope=t_rope,
        cache=tc, pos=tpos, eps=1e-5)
    return (jy, jnc), (ty, tnc, tc)


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_attention_module_fp32_matches_reference(mode, qk_norm):
    (jy, jnc), (ty, tnc, tc) = _run_both(mode, "float32", qk_norm, "ref")
    assert ty.dtype == torch.float32
    assert _rel(ty, jy) < 1e-4
    if mode == "none":
        assert tnc is None and jnc is None
        return
    # written in place: the returned leaves are the ones passed in
    assert tnc["k"] is tc["k"] and tnc["v"] is tc["v"]
    for key in ("k", "v"):
        assert tnc[key].dtype == torch.bfloat16
        # bf16 leaves: one rounding of values that agree to 1e-4
        np.testing.assert_allclose(_np(tnc[key]), _np(jnc[key]), rtol=1e-2,
                                   atol=1e-2)


@pytest.mark.parametrize("mode", list(MODES))
def test_attention_module_bf16_matches_pallas_semantics(mode):
    (jy, _), (ty, _, _) = _run_both(mode, "bfloat16", False, "interpret")
    assert ty.dtype == torch.bfloat16
    assert _rel(ty, jy) < 2e-2


def test_unported_attention_paths_raise():
    """Every layer kind of the reference is ported, so an unknown kind
    raises ``ValueError`` as in the reference, from the param defs, the
    cache and the layer alike; a ring without a window breaks the Pallas
    contract and raises."""
    z = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="ring KV layout requires"):
        flash_ops.flash_attention(z, z, z, kv_wrap=torch.zeros(1),
                                  ring_len=8)
    cfg = reduced(zamba2_2p7b)
    with pytest.raises(ValueError, match="unknown layer kind 'conv'"):
        blocks.layer_param_defs(cfg, "conv")
    with pytest.raises(ValueError, match="unknown layer kind 'conv'"):
        blocks.init_layer_cache(cfg, "conv", 1, 8, dtype=torch.float32,
                                device="cpu")
    with pytest.raises(ValueError, match="unknown layer kind 'conv'"):
        blocks.apply_layer(cfg, "conv", {}, torch.zeros(1, 2, 64))
