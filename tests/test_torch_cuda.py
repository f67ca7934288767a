"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every case is marked ``cuda`` and skips where there is no card.  The file
imports neither JAX nor the reference package, so on a machine with a
card and no JAX it runs on its own:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Shapes are the reduced config's and widths off each kernel's tiles; the
full mamba2-2.7b shapes are held by ``chip_smoke.py``.  Tolerances: 1e-4 in
fp32 (sums in another order), 2e-2 in bf16 (one bf16 rounding).
"""
import pytest
import torch

from repro_torch.kernels.conv1d import ops as conv_ops
from repro_torch.kernels.conv1d import ref as conv_ref
from repro_torch.kernels.decode_fused import ops as dec_ops
from repro_torch.kernels.decode_fused import ref as dec_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol):
    """Every output within ``tol`` times max(1, max |reference|)."""
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        scale = max(1.0, float(b.float().abs().max()))
        assert float((a.float() - b.float()).abs().max()) <= tol * scale


def _rn(gen, dev):
    def rn(*shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dt)
    return rn


@pytest.mark.cuda
@pytest.mark.parametrize("s,c", [(200, 1000), (200, 1003), (2, 1000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_kernel(cuda, dtype, s, c):
    """Channel counts off the 128-channel tile; a 2-token input keeps one
    row of the old state in the new one."""
    rn = _rn(torch.Generator(device=cuda).manual_seed(0), cuda)
    td = DTYPES[dtype]
    b, k = 3, 4
    x, w, bias = rn(b, s, c, dt=td), rn(c, k), rn(c)
    st = rn(b, k - 1, c, dt=td)
    n0 = conv_ops.causal_conv1d.launches
    got = conv_ops.causal_conv1d(x, w, bias, initial_state=st)
    torch.cuda.synchronize()
    assert conv_ops.causal_conv1d.launches == n0 + 1
    _close(got, conv_ref.causal_conv1d_ref(x, w, bias, st), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel(cuda, dtype):
    rn = _rn(torch.Generator(device=cuda).manual_seed(1), cuda)
    td = DTYPES[dtype]
    b, s, h, p, g, n, q = 2, 64, 4, 16, 1, 16, 16
    args = (rn(b, s, h, p, dt=td), ssd_ref.softplus(rn(b, s, h)),
            -torch.exp(rn(h)), rn(b, s, g, n, dt=td), rn(b, s, g, n, dt=td),
            rn(h))
    h0 = rn(b, h, p, n)
    got = ssd_ops.ssd_chunked(*args, chunk=q, initial_state=h0)
    torch.cuda.synchronize()
    _close(got, ssd_ref.ssd_chunked_ref(*args, chunk=q, initial_state=h0),
           TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_kernel(cuda, dtype, n):
    rn = _rn(torch.Generator(device=cuda).manual_seed(2), cuda)
    td = DTYPES[dtype]
    b, h, p, g, k = 2, 4, 16, 2, 4
    c = h * p + 2 * g * n
    args = (rn(b, k - 1, c, dt=td), rn(b, h, p, n), rn(b, c, dt=td),
            rn(c, k), rn(c), rn(b, h, dt=td), rn(h), rn(h), rn(h))
    kw = dict(n_groups=g, d_state=n, headdim=p)
    got = dec_ops.mamba2_decode_fused(*args, **kw)
    torch.cuda.synchronize()
    _close(got, dec_ref.mamba2_decode_fused_ref(*args, **kw), TOL[dtype])
