"""The port's Mamba-2 block against the reference, on the CPU.

Same params (the reference's init, carried across with ``from_jax``), same
numpy inputs and carried conv/SSM states on both sides.  fp32 agrees to
1e-4 (relative to max |out|: matmul and SSD sums are taken in another
order); bf16 to 2e-2 (bf16 rounds at different points in each framework).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import SSMConfig as JSSM
from repro.models import mamba2 as jm2
from repro.models.params import init_params as j_init_params
from repro_torch.convert import from_jax, to_numpy
from repro_torch.core.config import SSMConfig
from repro_torch.kernels.conv1d.ref import window_at
from repro_torch.models import mamba2 as m2
from repro_torch.models.norms import gated_rms_norm, rms_norm

D_MODEL = 64
KW = dict(d_state=16, headdim=16, chunk=8)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _params():
    defs = jm2.mamba2_param_defs(D_MODEL, JSSM(**KW))
    jp = j_init_params(defs, jax.random.PRNGKey(0))
    # non-zero conv bias and norm scale so every term is exercised
    rng = np.random.default_rng(0)
    jp = dict(jp)
    jp["conv_b"] = jnp.asarray(rng.standard_normal(jp["conv_b"].shape) * .1,
                               jnp.float32)
    jp["norm_scale"] = jnp.asarray(
        rng.standard_normal(jp["norm_scale"].shape) * .1, jnp.float32)
    return jp, from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _close(got, want, tol):
    g = to_numpy(got)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    scale = float(np.abs(w).max()) + 1e-6
    assert float(np.abs(g - w).max()) / scale < tol, \
        float(np.abs(g - w).max()) / scale


def _cache(b, rng, cdt):
    s = SSMConfig(**KW)
    di, nh = s.d_inner(D_MODEL), s.n_ssm_heads(D_MODEL)
    conv = rng.standard_normal((b, s.conv_kernel - 1, di + 2 * s.d_state))
    ssm = rng.standard_normal((b, nh, s.headdim, s.d_state))
    jc = {"conv": jnp.asarray(conv, jnp.float32).astype(cdt[0]),
          "ssm": jnp.asarray(ssm, jnp.float32)}
    tc = {"conv": torch.from_numpy(conv.astype(np.float32)).to(cdt[1]),
          "ssm": torch.from_numpy(ssm.astype(np.float32))}
    return jc, tc


DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_block_matches_reference(dtype, masked):
    """Prefill block with carried states; ``masked`` gives ragged rows
    (lengths 13, 5, 0) and a sequence off the chunk grid (padding)."""
    jp, tp = _params()
    b, s = 3, 13
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, s, D_MODEL)).astype(np.float32)
    jx = jnp.asarray(x).astype(DT[dtype][0])
    tx = torch.from_numpy(x).to(DT[dtype][1])
    jc, tc = _cache(b, rng, DT[dtype])
    lens = np.array([13, 5, 0])
    mask = np.arange(s)[None, :] < lens[:, None]
    jmask = jnp.asarray(mask) if masked else None
    tmask = torch.from_numpy(mask) if masked else None
    tlens = torch.from_numpy(lens.astype(np.int32)) if masked else None
    j_out, j_new = jm2.mamba2_block(jp, jx, JSSM(**KW), D_MODEL, cache=jc,
                                    mask=jmask)
    t_out, t_new = m2.mamba2_block(tp, tx, SSMConfig(**KW), D_MODEL,
                                   cache=tc, mask=tmask, lengths=tlens)
    _close(t_out, j_out, TOL[dtype])
    for key in ("conv", "ssm"):
        _close(t_new[key], j_new[key], TOL[dtype])
        assert t_new[key].dtype == tc[key].dtype
    if masked:   # a zero-length row's conv window passes through unchanged
        assert torch.equal(t_new["conv"][2], tc["conv"][2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_matches_reference(dtype):
    jp, tp = _params()
    b = 2
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, 1, D_MODEL)).astype(np.float32)
    jc, tc = _cache(b, rng, DT[dtype])
    j_out, j_new = jm2.mamba2_decode(jp, jnp.asarray(x).astype(DT[dtype][0]),
                                     JSSM(**KW), D_MODEL, cache=jc)
    t_out, t_new = m2.mamba2_decode(tp, torch.from_numpy(x).to(DT[dtype][1]),
                                    SSMConfig(**KW), D_MODEL, cache=tc)
    _close(t_out, j_out, TOL[dtype])
    for key in ("conv", "ssm"):
        _close(t_new[key], j_new[key], TOL[dtype])


def test_masked_conv_state_matches_reference():
    """The conv state after a ragged chunk (the plain conv's ``lengths``
    window) is the reference's ``masked_conv_state`` bit for bit."""
    rng = np.random.default_rng(3)
    init = rng.standard_normal((3, 3, 6)).astype(np.float32)
    x_in = rng.standard_normal((3, 7, 6)).astype(np.float32)
    lens = np.array([7, 2, 0], np.int32)
    mask = np.arange(7)[None, :] < lens[:, None]
    want = jm2.masked_conv_state(jnp.asarray(init), jnp.asarray(x_in),
                                 jnp.asarray(mask), 4)
    src = torch.cat([torch.from_numpy(init), torch.from_numpy(x_in)], dim=1)
    got = window_at(src, torch.from_numpy(lens), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_norms_match_reference():
    from repro.models import norms as jn
    rng = np.random.default_rng(4)
    x, z = (rng.standard_normal((2, 5, 32)).astype(np.float32)
            for _ in range(2))
    scale = (rng.standard_normal((32,)) * .1).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, z, scale)]
    j = [jnp.asarray(a) for a in (x, z, scale)]
    _close(rms_norm(t[0], t[2]), jn.rms_norm(j[0], j[2]), 1e-6)
    _close(gated_rms_norm(*t), jn.gated_rms_norm(*j), 1e-6)
