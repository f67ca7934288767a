"""The sharded decode step's kernel modes, on the CPU, with no ranks.

Each new mode's plain version, cut as a plan's ranks cut its inputs and
combined as the collective combines them, against the whole plain call
and against the reference's oracle on the same seeded numpy inputs:

* decode attention's partials mode over 2 and 4 shards of the cache's
  rows, each shard's live keys ``clamp(valid_len - first_row, 0, rows)``
  (rows past ``valid_len`` give a shard no live key), merged in fp32:
  within 1e-6 of the whole plain call and of the reference's
  ``decode_attention_ref`` in fp32 (2e-2 of max |o| in bf16, the
  reference's own bf16 limit);
* the Mamba-2 step's head-slice mode over 2 and 4 head shards (one group,
  and two groups that split with the heads): the shards' y and state
  equal to the whole plain call's bit for bit, and within 1e-5 of the
  reference's ``mamba2_decode_fused_ref``;
* the Mamba-1 step's two launches over 2 and 4 channel shards, the fp32
  x_proj shares summed between them: y and the state within 1e-5 of the
  whole plain call and of the reference's ``mamba1_decode_fused_ref`` in
  fp32, the new window bit for bit.

The CUDA modes are held against the unsharded kernels on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``; the DTensor paths
that call them by ``tests/test_torch_distributed.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attn_decode.ref import decode_attention_ref as j_attn
from repro.kernels.decode_fused.ref import mamba1_decode_fused_ref as j_m1
from repro.kernels.decode_fused.ref import mamba2_decode_fused_ref as j_m2
from repro_torch.kernels.attn_decode import ops as attn_ops
from repro_torch.kernels.attn_decode import ref as attn_ref
from repro_torch.kernels.decode_fused import ops as dec_ops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str = "float32"):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _attn_inputs(b, h, kvh, s, d, seed=0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.standard_normal((b, h, d), f32),
            rng.standard_normal((b, kvh, s, d), f32),
            rng.standard_normal((b, kvh, s, d), f32))


def _merged(q, k, v, valid, shards):
    """Each shard's partials over its rows, merged as the DTensor path
    merges them."""
    s = k.shape[2]
    rows = s // shards
    parts = []
    for r in range(shards):
        sl = slice(r * rows, (r + 1) * rows)
        vl = torch.clamp(valid - r * rows, 0, rows).to(torch.int32)
        parts.append(attn_ops.decode_attention_partials(
            q, k[:, :, sl], v[:, :, sl], valid_len=vl))
    acc, m, l = (torch.stack(t) for t in zip(*parts))
    return attn_ref.merge_partials(acc, m, l), parts


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_partials_merge_to_the_whole_call(shards, dtype):
    b, h, kvh, s, d = 4, 8, 2, 64, 16
    qn, kn, vn = _attn_inputs(b, h, kvh, s, d)
    (jq, q), (jk, k), (jv, v) = (_pair(a, dtype) for a in (qn, kn, vn))
    # row 0 ends in the first shard (every later shard has no live key),
    # row 1 on a shard edge, row 3 covers the cache
    valid_np = np.array([3, s // shards, 40, s], np.int32)
    valid = torch.from_numpy(valid_np)
    got, parts = _merged(q, k, v, valid, shards)
    # the shards past row 0's valid length: no live key, no weight
    for acc, m, l in parts[1:]:
        assert float(m[0].max()) == np.float32(-1e30)
        assert float(l[0].abs().max()) == 0
        assert float(acc[0].abs().max()) == 0
    whole = attn_ref.decode_attention_ref(q, k, v, valid_len=valid)
    want = j_attn(jq, jk, jv, valid_len=jnp.asarray(valid_np))
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(whole), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                   atol=1e-6)
    else:
        for ref in (whole, want):
            r = _np(ref)
            assert np.abs(_np(got.to(q.dtype)) - r).max() < 2e-2 * max(
                1.0, np.abs(r).max())


def test_attention_partials_of_the_whole_cache_are_the_kernel_split():
    """One shard's partials, normalised, are the plain call; its (m, l)
    those of the split reference at one split."""
    b, h, kvh, s, d = 2, 4, 1, 96, 32
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs(b, h, kvh, s, d, 1))
    valid = torch.tensor([96, 17], dtype=torch.int32)
    acc, m, l = attn_ops.decode_attention_partials(q, k, v, valid_len=valid)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    torch.testing.assert_close(
        acc / l[..., None],
        attn_ref.decode_attention_ref(q, k, v, valid_len=valid),
        rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(
        attn_ref.merge_partials(acc[None], m[None], l[None]),
        attn_ref.decode_attention_split_ref(q, k, v, valid_len=valid,
                                            split_len=s),
        rtol=1e-6, atol=1e-6)


def _m2_inputs(b, h, p, g, n, k, seed=3):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    c = h * p + 2 * g * n
    return (rng.standard_normal((b, k - 1, c), f32),
            rng.standard_normal((b, h, p, n), f32),
            rng.standard_normal((b, c), f32),
            rng.standard_normal((c, k), f32), rng.standard_normal((c,), f32),
            rng.standard_normal((b, h), f32),
            *(rng.standard_normal((h,), f32) for _ in range(3)))


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("groups", [1, 2])
def test_mamba2_head_slices_are_the_whole_step(shards, groups):
    b, h, p, n, k = 2, 8, 16, 16, 4
    args = _m2_inputs(b, h, p, groups, n, k)
    conv, ssm, xbc, w, bias, dt_raw, dtb, al, D = map(torch.from_numpy, args)
    kw = dict(n_groups=groups, d_state=n, headdim=p)
    y, _, st = dec_ops.mamba2_decode_fused(conv, ssm, xbc, w, bias, dt_raw,
                                           dtb, al, D, **kw)
    hl = h // shards
    ys, sts = [], []
    for r in range(shards):
        sl = slice(r * hl, (r + 1) * hl)
        yr, sr = dec_ops.mamba2_decode_heads(
            conv, ssm[:, sl], xbc, w, bias, dt_raw[:, sl], dtb[sl], al[sl],
            D[sl], head_offset=r * hl, **kw)
        assert yr.shape == (b, hl, p) and sr.shape == (b, hl, p, n)
        ys.append(yr)
        sts.append(sr)
    assert torch.equal(torch.cat(ys, 1), y)
    assert torch.equal(torch.cat(sts, 1), st)
    jy, _, jst = j_m2(*map(jnp.asarray, args), **kw)
    np.testing.assert_allclose(_np(torch.cat(ys, 1)), _np(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(torch.cat(sts, 1)), _np(jst), rtol=1e-5,
                               atol=1e-5)


def _m1_inputs(b, c, n, r, k, seed=5):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.standard_normal((b, k - 1, c), f32),
            rng.standard_normal((b, c, n), f32),
            rng.standard_normal((b, c), f32),
            rng.standard_normal((c, k), f32), rng.standard_normal((c,), f32),
            0.1 * rng.standard_normal((c, r + 2 * n), f32),
            0.1 * rng.standard_normal((r, c), f32),
            rng.standard_normal((c,), f32),
            rng.standard_normal((c, n), f32), rng.standard_normal((c,), f32))


@pytest.mark.parametrize("shards", [2, 4])
def test_mamba1_channel_split_is_the_whole_step(shards):
    b, c, n, r, k = 3, 64, 16, 4, 4
    args = _m1_inputs(b, c, n, r, k)
    (conv, ssm, xi, w, bias, xp, dtp, dtb, al, D) = map(torch.from_numpy,
                                                         args)
    kw = dict(d_state=n, dt_rank=r)
    y, nconv, st = dec_ops.mamba1_decode_fused(conv, ssm, xi, w, bias, xp,
                                               dtp, dtb, al, D, **kw)
    cl = c // shards
    cuts = [slice(i * cl, (i + 1) * cl) for i in range(shards)]
    firsts = [dec_ops.mamba1_decode_conv_proj(conv[..., sl], xi[:, sl],
                                              w[sl], bias[sl], xp[sl])
              for sl in cuts]
    proj = sum(part for _, _, part in firsts)        # the all-reduce
    assert proj.dtype == torch.float32 and proj.shape == (b, r + 2 * n)
    outs = [dec_ops.mamba1_decode_state(ssm[:, sl], xs, proj, dtp[:, sl],
                                        dtb[sl], al[sl], D[sl], **kw)
            for sl, (xs, _, _) in zip(cuts, firsts)]
    gy = torch.cat([o[0] for o in outs], 1)
    gst = torch.cat([o[1] for o in outs], 1)
    assert torch.equal(torch.cat([f[1] for f in firsts], 2), nconv)
    jy, jconv, jst = j_m1(*map(jnp.asarray, args), **kw)
    for got, whole, want in ((gy, y, jy), (gst, st, jst)):
        np.testing.assert_allclose(_np(got), _np(whole), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(_np(nconv), _np(jconv))
