"""The port's kernels against the reference, on the CPU.

Each plain PyTorch version is held against the reference's jnp oracle
(``ref``) and against its Pallas kernel run with ``interpret=True``, on
the same numpy inputs, in fp32 and bf16, with and without initial state.
Tolerances are the reference's own kernel-test tolerances: 1e-5 in fp32
for conv1d and the decode step, 1e-3 (relative to max |y|) for SSD in
fp32, 2e-2 in bf16 (one bf16 rounding is worth 2^-8 of a value, and the
two frameworks round at different points).

The plain conv1d's new state with ragged valid lengths is held against
the reference's ``masked_conv_state`` bit for bit (it is a copy).

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv1d.kernel import causal_conv1d_pallas
from repro.kernels.conv1d.ref import causal_conv1d_ref as j_conv
from repro.kernels.decode_fused.kernel import mamba2_decode_fused_pallas
from repro.kernels.decode_fused.ref import mamba2_decode_fused_ref as j_dec
from repro.kernels.ssd.kernel import ssd_pallas
from repro.kernels.ssd.ref import ssd_chunked_ref as j_ssd
from repro.kernels.ssd.ref import ssd_sequential as j_ssd_seq
from repro.models import mamba2 as jm2
from repro_torch.kernels.conv1d import ops as conv_ops
from repro_torch.kernels.decode_fused import ops as dec_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same numbers on both sides, rounded to ``dtype`` alike."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, scale_by_max=False):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    if scale_by_max:
        scale = float(np.abs(w).max()) + 1e-6
        assert float(np.abs(g - w).max()) / scale < tol
    else:
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


# ------------------------------------------------------------------ conv1d
@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_plain_matches_reference(dtype, with_state):
    b, s, c, k = 2, 64, 32, 4
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, s, c), np.float32)
    w = rng.standard_normal((c, k), np.float32)
    bias = rng.standard_normal((c,), np.float32)
    st = rng.standard_normal((b, k - 1, c), np.float32)
    jx, tx = _pair(x, dtype)
    jst, tst = _pair(st, dtype) if with_state else (None, None)
    y_t, s_t = conv_ops.causal_conv1d(tx, torch.from_numpy(w),
                                      torch.from_numpy(bias),
                                      initial_state=tst)
    y_j, s_j = j_conv(jx, jnp.asarray(w), jnp.asarray(bias), jst)
    jst_k = jst if with_state else jnp.zeros((b, k - 1, c), jx.dtype)
    y_p, s_p = causal_conv1d_pallas(jx, jnp.asarray(w), jnp.asarray(bias),
                                    initial_state=jst_k, block_seq=32,
                                    block_ch=16, interpret=True)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    for want in (y_j, y_p):
        _close(y_t, want, tol)
    for want in (s_j, s_p):
        _close(s_t, want, 0.0)
    assert y_t.dtype == tx.dtype and s_t.dtype == tx.dtype


@pytest.mark.parametrize("s", [16, 2])
@pytest.mark.parametrize("with_out", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_plain_lengths_match_reference(dtype, with_out, s):
    """With ``lengths`` (0, 1, K-2, K-1 and S, clipped to S for a 2-token
    chunk) the new state is the reference's ``masked_conv_state`` bit for
    bit, y is the reference's conv, and ``out_state`` receives the state
    and is returned as it; the inputs stay as they were."""
    k, c = 4, 24
    lens = np.minimum(np.array([0, 1, k - 2, k - 1, s], np.int32), s)
    b = len(lens)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s, c), np.float32)
    w = rng.standard_normal((c, k), np.float32)
    bias = rng.standard_normal((c,), np.float32)
    st = rng.standard_normal((b, k - 1, c), np.float32)
    jx, tx = _pair(x, dtype)
    jst, tst = _pair(st, dtype)
    before = (tx.clone(), tst.clone())
    out = torch.full((b, k - 1, c), 7.0).to(tx.dtype) if with_out else None
    y_t, s_t = conv_ops.causal_conv1d(
        tx, torch.from_numpy(w), torch.from_numpy(bias), initial_state=tst,
        lengths=torch.from_numpy(lens), out_state=out)
    y_j, _ = j_conv(jx, jnp.asarray(w), jnp.asarray(bias), jst)
    mask = np.arange(s)[None, :] < lens[:, None]
    s_j = jm2.masked_conv_state(jst, jx, jnp.asarray(mask), k)
    _close(y_t, y_j, 2e-2 if dtype == "bfloat16" else 1e-5)
    _close(s_t, s_j, 0.0)
    assert s_t.dtype == tx.dtype
    if with_out:
        assert s_t is out
    assert torch.equal(tx, before[0]) and torch.equal(tst, before[1])
    # a full row's state is the trailing window, as without lengths
    _, s_full = conv_ops.causal_conv1d(tx, torch.from_numpy(w),
                                       torch.from_numpy(bias),
                                       initial_state=tst)
    full = lens == s
    assert torch.equal(s_t[full], s_full[full])


# --------------------------------------------------------------------- SSD
def _ssd_inputs(b, s, h, p, g, n, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt_raw = rng.standard_normal((b, s, h), np.float32)
    a_log = rng.standard_normal((h,), np.float32)
    bm = rng.standard_normal((b, s, g, n), np.float32)
    cm = rng.standard_normal((b, s, g, n), np.float32)
    d = rng.standard_normal((h,), np.float32)
    h0 = rng.standard_normal((b, h, p, n), np.float32)
    dt = np.log1p(np.exp(dt_raw)).astype(np.float32)
    A = -np.exp(a_log).astype(np.float32)
    return x, dt, A, bm, cm, d, h0


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_matches_reference(dtype, with_state):
    b, s, h, p, g, n, chunk = 2, 64, 4, 16, 2, 16, 16
    x, dt, A, bm, cm, d, h0 = _ssd_inputs(b, s, h, p, g, n, dtype)
    jx, tx = _pair(x, dtype)
    jb, tb = _pair(bm, dtype)
    jc, tc = _pair(cm, dtype)
    jh0 = jnp.asarray(h0) if with_state else None
    th0 = torch.from_numpy(h0) if with_state else None
    y_t, f_t = ssd_ops.ssd_chunked(tx, torch.from_numpy(dt),
                                   torch.from_numpy(A), tb, tc,
                                   torch.from_numpy(d), chunk=chunk,
                                   initial_state=th0)
    jargs = (jx, jnp.asarray(dt), jnp.asarray(A), jb, jc, jnp.asarray(d))
    y_j, f_j = j_ssd(*jargs, chunk=chunk, initial_state=jh0)
    y_p, f_p = ssd_pallas(*jargs, chunk=chunk, initial_state=jh0,
                          interpret=True)
    tol = 2e-2 if dtype == "bfloat16" else 1e-3
    for y_w, f_w in ((y_j, f_j), (y_p, f_p)):
        _close(y_t, y_w, tol, scale_by_max=True)
        _close(f_t, f_w, tol, scale_by_max=True)
    assert y_t.dtype == tx.dtype and f_t.dtype == torch.float32


def test_ssd_sequential_and_chunked_agree_with_reference():
    """The port's token-by-token oracle matches the reference's, and the
    chunked form matches it (fp32)."""
    x, dt, A, bm, cm, d, h0 = _ssd_inputs(1, 32, 2, 8, 1, 8, "float32")
    t = [torch.from_numpy(a) for a in (x, dt, A, bm, cm, d)]
    y_s, f_s = ssd_ref.ssd_sequential(*t, initial_state=torch.from_numpy(h0))
    y_j, f_j = j_ssd_seq(*[jnp.asarray(a) for a in (x, dt, A, bm, cm, d)],
                         initial_state=jnp.asarray(h0))
    _close(y_s, y_j, 1e-5, scale_by_max=True)
    _close(f_s, f_j, 1e-5, scale_by_max=True)
    y_c, f_c = ssd_ref.ssd_chunked_ref(*t, chunk=8,
                                       initial_state=torch.from_numpy(h0))
    _close(y_c, y_s, 1e-3, scale_by_max=True)
    _close(f_c, f_s, 1e-3, scale_by_max=True)


def test_preprocess_dt_A_matches_reference():
    from repro.kernels.ssd.ref import preprocess_dt_A as j_pre
    rng = np.random.default_rng(2)
    raw = (rng.standard_normal((3, 5, 4)) * 20).astype(np.float32)
    bias = rng.standard_normal((4,), np.float32)
    a_log = rng.standard_normal((4,), np.float32)
    dt_t, A_t = ssd_ref.preprocess_dt_A(*map(torch.from_numpy,
                                             (raw, bias, a_log)))
    dt_j, A_j = j_pre(*map(jnp.asarray, (raw, bias, a_log)))
    _close(dt_t, dt_j, 1e-6)
    _close(A_t, A_j, 1e-6)


# ------------------------------------------------------------ decode step
@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("b,h,p,g,n,k", [(2, 4, 16, 2, 16, 4),
                                         (1, 8, 8, 1, 32, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_plain_matches_reference(b, h, p, g, n, k, dtype,
                                               with_state):
    di = h * p
    c = di + 2 * g * n
    rng = np.random.default_rng(3)
    f32 = np.float32
    conv = rng.standard_normal((b, k - 1, c), f32)
    ssm = rng.standard_normal((b, h, p, n), f32)
    if not with_state:
        conv, ssm = np.zeros_like(conv), np.zeros_like(ssm)
    xbc = rng.standard_normal((b, c), f32)
    w = rng.standard_normal((c, k), f32)
    bias = rng.standard_normal((c,), f32)
    dt_raw = rng.standard_normal((b, h), f32)
    dtb, al, D = (rng.standard_normal((h,), f32) for _ in range(3))
    (jconv, tconv), (jxbc, txbc), (jdt, tdt) = (
        _pair(a, dtype) for a in (conv, xbc, dt_raw))
    kw = dict(n_groups=g, d_state=n, headdim=p)
    got = dec_ops.mamba2_decode_fused(
        tconv, torch.from_numpy(ssm), txbc,
        *map(torch.from_numpy, (w, bias)), tdt,
        *map(torch.from_numpy, (dtb, al, D)), **kw)
    jargs = (jconv, jnp.asarray(ssm), jxbc, jnp.asarray(w), jnp.asarray(bias),
             jdt, jnp.asarray(dtb), jnp.asarray(al), jnp.asarray(D))
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    for want in (j_dec(*jargs, **kw),
                 mamba2_decode_fused_pallas(*jargs, **kw, interpret=True)):
        for a, r in zip(got, want):
            _close(a, r, tol)
    assert got[0].dtype == txbc.dtype and got[1].dtype == tconv.dtype
    assert got[2].dtype == torch.float32
