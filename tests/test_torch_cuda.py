"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every case is marked ``cuda`` and skips where there is no card.  The file
imports neither JAX nor the reference package, so on a machine with a
card and no JAX it runs on its own:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Shapes are the reduced config's and widths off each kernel's tiles,
the flash kernel non-causal at hubert-xlarge's encoder shape (B=4, 16
heads of 80, 1500 frames), the MoE layer's gshard and ragged paths at
qwen3-moe-235b-a22b's expert shapes with 8 experts (against the CPU and
a plain per-expert loop), the decode burst's graph replays of reduced
qwen3-moe (both dispatch paths) and llama4-maverick,
gemma3-1b's head_dim 256, qwen2.5-0.5b's 64 and phi-3-mini's 96, decode
attention at glm4-9b's 16 query heads per KV head (and 10 at d=64, off
the tiles), and the
SSD scan at both served Mamba-2 models' (P, N) on 2 and 16 chunks at the
model's scales, SSD and the Mamba-2 decode step at the paper's
zamba2-1.2b's (64 heads, d_state 64), mamba2-780m's and mamba2-130m's
heads, flash and decode attention at zamba2-1.2b's 32 heads of 128 on
32, qwen2.5-1.5b's 12 on 2 and llama3.2-1b's 32 on 8 of 64, a sampled
decode burst (``temperature``, ``generator``) repeated bit for bit,
SSD, conv1d (with ragged valid lengths) and both decode
steps writing into slots of stacked cache leaves, and the wrappers'
refusals (unbuilt shapes, a destination that overlaps an input, a
Mamba-1 d_inner past a cluster of 8 blocks); the full mamba2-2.7b,
zamba2-2.7b, mamba-130m and gemma3-1b shapes are held by
``chip_smoke.py``.  The training path: each backward kernel (conv1d,
SSD at the reduced and zamba2-2.7b's (P, N), flash at d=16 GQA 3:1 and
smollm-135m's d=64 GQA 3:1, at d=256, in a window shorter than S and
non-causal off a tile on both routes, the selective scan at N = 16 and
8) against its plain backward and repeated bit for bit, the wrappers'
``ScanFn`` and ``FlashFn`` under grad, the MoE layer's gradients by both
dispatch paths against the CPU's, the refusal of calls with no backward
under grad, and a tiny train step through the kernels against autograd
through the plain path.
Tolerances: 1e-4 in fp32 (sums in another order), 2e-2 in bf16 (one bf16
rounding; the flash kernel also rounds its probabilities to bf16 for the
P.V product), of max(1, max |reference|) for the Mamba kernels and of
each query row's own max |o| for attention (and, on the model-scale SSD
cases, of each (token, head) row's own max |y|); the selective scan is held
to the reference's scan-kernel tolerances, 2e-4 (fp32) or 3e-2 (bf16) of
max |y| and 1e-3 on the state.  The attention kernels take
their K and V as
``transpose(1, 2)`` views of a ``[B, S, KV, d]`` cache, as the model
hands them over.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.kernels.attn_decode import ops as dec_attn_ops
from repro_torch.kernels.attn_decode import ref as dec_attn_ref
from repro_torch.kernels.conv1d import ops as conv_ops
from repro_torch.kernels.conv1d import ref as conv_ref
from repro_torch.kernels.decode_fused import ops as dec_ops
from repro_torch.kernels.decode_fused import ref as dec_ref
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.flash import ref as flash_ref
from repro_torch.kernels.scan1 import ops as scan_ops
from repro_torch.kernels.scan1 import ref as scan_ref
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


def _close_rows(got, want, tol):
    """Each attention query row (the last dim) within ``tol`` times that
    row's max |reference|: a row that attends many keys has a far smaller
    output than a one-key row, so a shared scale would hide its faults."""
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float(), want.float()
    err = (g - w).abs().amax(-1)
    assert bool((err <= tol * w.abs().amax(-1)).all()), float(
        (err / w.abs().amax(-1)).max())


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
@pytest.mark.parametrize("s,c", [(200, 1000), (200, 1003), (2, 1000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_kernel_lengths_and_destination(cuda, dtype, s, c):
    """Valid lengths 0, 1, 2, K-1, 150 and S across rows (clipped to S for
    a 2-token input), the new state written into a slot of a stacked
    leaf: y within the limit, the state equal to the plain version's bit
    for bit, the other slots and the inputs as they were."""
    rn = _rn(torch.Generator(device=cuda).manual_seed(14), cuda)
    td = DTYPES[dtype]
    k = 4
    lens = torch.tensor([0, 1, 2, k - 1, 150, s], dtype=torch.int32,
                        device=cuda).clamp(max=s)
    b = lens.numel()
    x, w, bias = rn(b, s, c, dt=td), rn(c, k), rn(c)
    st = rn(b, k - 1, c, dt=td)
    before = (x.clone(), st.clone())
    dst = torch.full((3, b, k - 1, c), 7.0, device=cuda).to(td)
    n0 = conv_ops.causal_conv1d.launches
    y, state = conv_ops.causal_conv1d(x, w, bias, initial_state=st,
                                      lengths=lens, out_state=dst[1])
    torch.cuda.synchronize()
    assert conv_ops.causal_conv1d.launches == n0 + 1
    assert state.data_ptr() == dst[1].data_ptr()
    wy, wstate = conv_ref.causal_conv1d_ref(x, w, bias, st, lengths=lens)
    _close([y], [wy], TOL[dtype])
    assert torch.equal(state, wstate)
    assert bool((dst[0] == 7.0).all() and (dst[2] == 7.0).all())
    assert torch.equal(x, before[0]) and torch.equal(st, before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 4, 16, 16, 16),
                                   (1, 256, 4, 64, 64, 128)],
                         ids=["reduced", "zamba2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel(cuda, dtype, shape):
    """The reduced shape and zamba2-2.7b's (P, N, chunk) = (64, 64, 128)."""
    rn = _rn(torch.Generator(device=cuda).manual_seed(1), cuda)
    td = DTYPES[dtype]
    b, s, h, p, n, q = shape
    g = 1
    args = (rn(b, s, h, p, dt=td), ssd_ref.softplus(rn(b, s, h)),
            -torch.exp(rn(h)), rn(b, s, g, n, dt=td), rn(b, s, g, n, dt=td),
            rn(h))
    h0 = rn(b, h, p, n)
    got = ssd_ops.ssd_chunked(*args, chunk=q, initial_state=h0)
    torch.cuda.synchronize()
    _close(got, ssd_ref.ssd_chunked_ref(*args, chunk=q, initial_state=h0),
           TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", [(128, 256), (64, 256), (128, 2048),
                                 (64, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_model_scales(cuda, dtype, n, s):
    """(P, chunk) = (64, 128) at both served d_states (mamba2-2.7b's 128,
    zamba2-2.7b's 64), on a 2-chunk and a 16-chunk sequence, inputs at
    the model's scales (bf16 on the tensor-core kernel, fp32 on CUDA
    cores); each (token, head) row of y held to its own max |y|, the
    final state to max(1, max |state|)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    args, h0 = ssd_ref.model_scale_inputs(gen, 2, s, 8, 64, n,
                                          DTYPES[dtype])
    n0 = ssd_ops.ssd_chunked.launches
    got = ssd_ops.ssd_chunked_cuda(*args, chunk=128, initial_state=h0)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_chunked.launches == n0 + 1
    want = ssd_ref.ssd_chunked_ref(*args, chunk=128, initial_state=h0)
    _close_rows(got[0], want[0], TOL[dtype])
    _close(got[1:], want[1:], TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_writes_destination(cuda, dtype):
    """``out_state`` a slot of a stacked [n_rep, ...] leaf: the final state
    lands there, the other slots and the initial state stay as they
    were."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    args, h0 = ssd_ref.model_scale_inputs(gen, 2, 256, 8, 64, 64,
                                          DTYPES[dtype])
    stacked = torch.full((3, 2, 8, 64, 64), 7.0, device=cuda)
    h0_before = h0.clone()
    y, fin = ssd_ops.ssd_chunked(*args, chunk=128, initial_state=h0,
                                 out_state=stacked[1])
    torch.cuda.synchronize()
    assert fin.data_ptr() == stacked[1].data_ptr()
    want = ssd_ref.ssd_chunked_ref(*args, chunk=128, initial_state=h0)
    _close([y, fin], want, TOL[dtype])
    assert bool((stacked[0] == 7.0).all() and (stacked[2] == 7.0).all())
    assert torch.equal(h0, h0_before)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_kernel_writes_destination(cuda, dtype):
    """``out_conv`` and ``out_ssm`` slots of stacked leaves, as a new cache
    hands them over: the new window and state land there and equal the
    plain version's; the old window and state and the other slots stay
    as they were."""
    rn = _rn(torch.Generator(device=cuda).manual_seed(13), cuda)
    td = DTYPES[dtype]
    b, h, p, g, n, k = 2, 8, 64, 1, 64, 4
    c = h * p + 2 * g * n
    args = (rn(b, k - 1, c, dt=td), rn(b, h, p, n), rn(b, c, dt=td),
            rn(c, k), rn(c), rn(b, h, dt=td), rn(h), rn(h), rn(h))
    before = [t.clone() for t in args[:2]]
    conv_dst = torch.full((3, b, k - 1, c), 7.0, device=cuda).to(td)
    ssm_dst = torch.full((3, b, h, p, n), 7.0, device=cuda)
    kw = dict(n_groups=g, d_state=n, headdim=p)
    got = dec_ops.mamba2_decode_fused(*args, **kw, out_conv=conv_dst[2],
                                      out_ssm=ssm_dst[1])
    torch.cuda.synchronize()
    assert got[1].data_ptr() == conv_dst[2].data_ptr()
    assert got[2].data_ptr() == ssm_dst[1].data_ptr()
    _close(got, dec_ref.mamba2_decode_fused_ref(*args, **kw), TOL[dtype])
    assert torch.equal(args[0], before[0]) and torch.equal(args[1], before[1])
    assert bool((conv_dst[:2] == 7.0).all() and (ssm_dst[0] == 7.0).all()
                and (ssm_dst[2] == 7.0).all())


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


@pytest.mark.cuda
@pytest.mark.parametrize("h,n", [(64, 64), (48, 128), (24, 128)],
                         ids=["zamba2-1.2b", "mamba2-780m", "mamba2-130m"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_kernels_at_paper_models(cuda, dtype, h, n):
    """The SSD scan on 2 chunks and the Mamba-2 decode step at the paper's
    models' heads and d_state (P = 64, one group, chunk 128), inputs at
    the model's scales: zamba2-1.2b's N = 64 over 64 heads (the
    tensor-core SSD instance (128, 64, 64) in bf16), mamba2-780m's 48
    and mamba2-130m's 24 heads at N = 128."""
    td = DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(14)
    args, h0 = ssd_ref.model_scale_inputs(gen, 2, 256, h, 64, n, td)
    got = ssd_ops.ssd_chunked_cuda(*args, chunk=128, initial_state=h0)
    torch.cuda.synchronize()
    want = ssd_ref.ssd_chunked_ref(*args, chunk=128, initial_state=h0)
    _close_rows(got[0], want[0], TOL[dtype])
    _close(got[1:], want[1:], TOL[dtype])
    rn = _rn(gen, cuda)
    b, p, g, k = 4, 64, 1, 4
    c = h * p + 2 * g * n
    dargs = (rn(b, k - 1, c, dt=td), rn(b, h, p, n), rn(b, c, dt=td),
             rn(c, k), rn(c), rn(b, h, dt=td), rn(h), rn(h), rn(h))
    kw = dict(n_groups=g, d_state=n, headdim=p)
    n0 = dec_ops.mamba2_decode_fused.launches
    dgot = dec_ops.mamba2_decode_fused(*dargs, **kw)
    torch.cuda.synchronize()
    assert dec_ops.mamba2_decode_fused.launches == n0 + 1
    _close(dgot, dec_ref.mamba2_decode_fused_ref(*dargs, **kw), TOL[dtype])


def _cache_view(rn, b, s, kvh, d, dt):
    """k or v as the model hands it over: [B,KVH,S,d] view of [B,S,KVH,d]."""
    return rn(b, s, kvh, d, dt=dt).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,kvh", [(80, 4, 4), (128, 8, 2), (16, 4, 2),
                                     (32, 8, 2), (256, 4, 1), (64, 14, 2),
                                     (96, 4, 4), (128, 32, 32),
                                     (128, 12, 2), (64, 32, 8)])
@pytest.mark.parametrize("mode", ["offsets", "causal", "full", "window"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel(cuda, dtype, mode, d, h, kvh):
    """Per-row q_offset against a longer KV prefix (chunked prefill), plain
    causal, non-causal and windowed, at head_dim 80, 128 (GQA 4:1), 256
    (gemma3-1b, GQA 4:1), 64 (qwen2.5-0.5b, GQA 7:1), 96 (phi-3-mini),
    zamba2-1.2b's shared block (32 heads of 128, no GQA), qwen2.5-1.5b's
    (12 on 2 of 128), llama3.2-1b's (32 on 8 of 64) and the reduced
    sizes; query and key counts off the 64-row tiles."""
    rn = _rn(torch.Generator(device=cuda).manual_seed(3), cuda)
    td = DTYPES[dtype]
    b, sq = 3, 70
    skv = 200 if mode == "offsets" else sq
    q = rn(b, sq, h, d, dt=td).transpose(1, 2)
    k = _cache_view(rn, b, skv, kvh, d, td)
    v = _cache_view(rn, b, skv, kvh, d, td)
    kw = dict(causal=mode != "full", window=16 if mode == "window" else None)
    if mode == "offsets":
        kw["q_offset"] = torch.tensor([0, 61, 130], dtype=torch.int32,
                                      device=cuda)
    n0 = flash_ops.flash_attention.launches
    got = flash_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches == n0 + 1
    want = flash_ref.attention_ref(q, k, v, **{**kw, "q_offset": kw.get(
        "q_offset", 0)})
    _close_rows(got, want, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_encoder_shape(cuda, dtype):
    """Non-causal attention at hubert-xlarge's encoder shape: B=4, 16 heads
    of 80 on 16 KV heads, 1500 frames (30 s of audio at 50 frames/s), off
    the 64-key and 128-row tiles; one launch."""
    rn = _rn(torch.Generator(device=cuda).manual_seed(31), cuda)
    td = DTYPES[dtype]
    b, h, s, d = 4, 16, 1500, 80
    q = rn(b, s, h, d, dt=td).transpose(1, 2)
    k = _cache_view(rn, b, s, h, d, td)
    v = _cache_view(rn, b, s, h, d, td)
    n0 = flash_ops.flash_attention.launches
    got = flash_ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches == n0 + 1
    _close_rows(got, flash_ref.attention_ref(q, k, v, causal=False),
                TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv", [(1500, 1500), (333, 333), (333, 1500)])
@pytest.mark.parametrize("d,h,kvh", [(80, 4, 4), (96, 8, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_noncausal_narrow_heads(cuda, dtype, d, h, kvh, sq,
                                             skv):
    """Non-causal attention at head_dim 80 and 96 (the wgmma route's P V
    at N = d, V in 16-column panels), with the query and key counts off
    the 64-key and 128-row tiles: 1500 frames, an odd 333, and 333
    queries over 1500 keys; each query row within TOL, one launch."""
    rn = _rn(torch.Generator(device=cuda).manual_seed(37), cuda)
    td = DTYPES[dtype]
    b = 2
    q = rn(b, sq, h, d, dt=td).transpose(1, 2)
    k = _cache_view(rn, b, skv, kvh, d, td)
    v = _cache_view(rn, b, skv, kvh, d, td)
    n0 = flash_ops.flash_attention.launches
    got = flash_ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches == n0 + 1
    _close_rows(got, flash_ref.attention_ref(q, k, v, causal=False),
                TOL[dtype])


# (window, ring_len, Sq, cursors): a full ring with cursors before, at and
# after the wrap; a ring sliced below the window (cursor + Sq <= ring_len,
# as a bucket slices it); a chunk longer than the window, which wraps
# inside itself.  Windows and ring lengths off the 64-key tile.
RING_CASES = {"wrap": (100, 100, 70, [0, 37, 100, 333]),
              "sliced": (128, 80, 40, [0, 17, 40, 3]),
              "long_chunk": (48, 48, 150, [0, 20, 48, 200])}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RING_CASES))
@pytest.mark.parametrize("d,h,kvh", [(32, 8, 2), (256, 4, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_ring(cuda, dtype, d, h, kvh, case):
    """The ring layout: [ring | chunk] keys with per-row cursors
    ``kv_wrap = q_offset``, each slot's position from the modular formula.
    The ring slots hold random rows, so a slot the mask should drop (never
    written, or outside the window) shows in the output if it is kept."""
    rn = _rn(torch.Generator(device=cuda).manual_seed(7), cuda)
    td = DTYPES[dtype]
    window, ring_len, sq, wraps = RING_CASES[case]
    b = len(wraps)
    q = rn(b, sq, h, d, dt=td).transpose(1, 2)
    k = _cache_view(rn, b, ring_len + sq, kvh, d, td)
    v = _cache_view(rn, b, ring_len + sq, kvh, d, td)
    wrap = torch.tensor(wraps, dtype=torch.int32, device=cuda)
    kw = dict(causal=True, window=window, q_offset=wrap, kv_wrap=wrap,
              ring_len=ring_len)
    n0 = flash_ops.flash_attention.ring_launches
    p0 = flash_ops.flash_attention.launches
    got = flash_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.ring_launches == n0 + 1
    assert flash_ops.flash_attention.launches == p0
    _close_rows(got, flash_ref.attention_ref(q, k, v, **kw), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,kvh", [(80, 32, 32), (128, 32, 8), (16, 4, 2),
                                     (64, 4, 1), (256, 4, 1), (64, 14, 2),
                                     (96, 4, 4), (128, 32, 2), (128, 12, 2),
                                     (128, 8, 4), (64, 9, 3), (128, 32, 32),
                                     (64, 32, 8)])
@pytest.mark.parametrize("split_k", [None, 1, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_kernel(cuda, dtype, split_k, d, h, kvh):
    """GQA groups of 1, 4, 2, 4, 4 (gemma3-1b's head_dim 256, whose fp32
    instance runs two warps a block), 7 (qwen2.5-0.5b, d=64), 1
    (phi-3-mini, d=96), 16 (glm4-9b: two N tiles of queries), 6
    (hymba-1.5b, qwen2.5-1.5b), 2 (falcon-h1-0.5b), 3 (smollm-135m, d=64),
    1 at 32 heads of 128 (zamba2-1.2b's shared block) and 4 at 32 heads
    of 64 (llama3.2-1b); valid_len
    of 1, on a tile edge (32, 64), one past it, and the whole cache; every
    split count gives the plain result."""
    rn = _rn(torch.Generator(device=cuda).manual_seed(4), cuda)
    td = DTYPES[dtype]
    b, s = 6, 300
    q = rn(b, h, d, dt=td)
    k = _cache_view(rn, b, s, kvh, d, td)
    v = _cache_view(rn, b, s, kvh, d, td)
    valid = torch.tensor([1, 32, 33, 64, 255, s], dtype=torch.int32,
                         device=cuda)
    n0 = dec_attn_ops.decode_attention.launches
    got = dec_attn_ops.decode_attention(q, k, v, valid_len=valid,
                                        split_k=split_k)
    torch.cuda.synchronize()
    assert dec_attn_ops.decode_attention.launches == n0 + 1
    _close_rows(got, dec_attn_ref.decode_attention_ref(q, k, v,
                                                       valid_len=valid),
                TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,kvh", [(128, 8, 2), (256, 4, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_ring_cache(cuda, dtype, d, h, kvh):
    """A local layer's 512-slot ring cache (gemma3-1b: ``Skv == window``,
    ``valid_len = min(pos + 1, 512)``): one live key, all but one, all."""
    rn = _rn(torch.Generator(device=cuda).manual_seed(8), cuda)
    td = DTYPES[dtype]
    b, s = 3, 512
    q = rn(b, h, d, dt=td)
    k = _cache_view(rn, b, s, kvh, d, td)
    v = _cache_view(rn, b, s, kvh, d, td)
    valid = torch.tensor([1, 511, 512], dtype=torch.int32, device=cuda)
    got = dec_attn_ops.decode_attention(q, k, v, valid_len=valid)
    torch.cuda.synchronize()
    _close_rows(got, dec_attn_ref.decode_attention_ref(q, k, v,
                                                       valid_len=valid),
                TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,kvh", [(128, 8, 2), (256, 4, 1), (80, 4, 4),
                                     (128, 32, 2), (64, 20, 2)])
@pytest.mark.parametrize("split_k", [None, 12, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_many_splits(cuda, dtype, split_k, d, h, kvh):
    """Split counts up to the rule's largest (16) on a 1100-row cache,
    valid lengths inside the first split, on a tile edge, mid-cache and
    the whole cache, so rows merge 1 to 16 live splits."""
    rn = _rn(torch.Generator(device=cuda).manual_seed(9), cuda)
    td = DTYPES[dtype]
    b, s = 4, 1100
    q = rn(b, h, d, dt=td)
    k = _cache_view(rn, b, s, kvh, d, td)
    v = _cache_view(rn, b, s, kvh, d, td)
    valid = torch.tensor([1, 64, 700, s], dtype=torch.int32, device=cuda)
    got = dec_attn_ops.decode_attention(q, k, v, valid_len=valid,
                                        split_k=split_k)
    torch.cuda.synchronize()
    _close_rows(got, dec_attn_ref.decode_attention_ref(q, k, v,
                                                       valid_len=valid),
                TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_graph_replays_agree(cuda, dtype):
    """One split decode call captured in a CUDA graph and replayed three
    times gives the eager call's output each time: the kernel leaves its
    merge tickets at zero."""
    rn = _rn(torch.Generator(device=cuda).manual_seed(10), cuda)
    td = DTYPES[dtype]
    b, h, kvh, d, s = 4, 4, 1, 256, 2048
    q = rn(b, h, d, dt=td)
    k = _cache_view(rn, b, s, kvh, d, td)
    v = _cache_view(rn, b, s, kvh, d, td)
    valid = torch.tensor([301, 701, 1001, 2048], dtype=torch.int32,
                         device=cuda)
    assert dec_attn_ops.split_layout(b, kvh, s)[0] > 1
    eager = dec_attn_ops.decode_attention(q, k, v, valid_len=valid)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dec_attn_ops.decode_attention(q, k, v, valid_len=valid)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    tickets = dec_attn_ops.ticket_counters(q.device, b * kvh)
    assert int(tickets.abs().sum()) == 0


# (heads packed, key splits) forced on the wgmma route
FORCED = [(None, 8), (1, 3), (None, 1), (2, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("packed,splits", FORCED)
@pytest.mark.parametrize("d,h,kvh", [(128, 8, 2), (256, 4, 1), (64, 8, 2),
                                     (96, 8, 2), (80, 8, 4), (32, 8, 2)])
@pytest.mark.parametrize("mode", ["offsets", "causal", "full", "window"]
                         + list(RING_CASES))
def test_flash_kernel_packing_and_splits(cuda, mode, d, h, kvh, packed,
                                         splits):
    """bf16 on the wgmma route (d=32 padded to 64, 64, 80 and 96 padded
    to 128, 128, 256) with head packing and key splits forced (the
    group's heads packed or not, up to 8 key splits merged in the
    kernel), in the plain layout's modes and every ring case."""
    rn = _rn(torch.Generator(device=cuda).manual_seed(11), cuda)
    td = torch.bfloat16
    if mode in RING_CASES:
        window, ring_len, sq, wraps = RING_CASES[mode]
        b, skv = len(wraps), ring_len + sq
        wrap = torch.tensor(wraps, dtype=torch.int32, device=cuda)
        kw = dict(causal=True, window=window, q_offset=wrap, kv_wrap=wrap,
                  ring_len=ring_len)
    else:
        b, sq = 3, 70
        skv = 200 if mode == "offsets" else sq
        kw = dict(causal=mode != "full",
                  window=16 if mode == "window" else None, q_offset=0)
        if mode == "offsets":
            kw["q_offset"] = torch.tensor([0, 61, 130], dtype=torch.int32,
                                          device=cuda)
    hp = packed or h // kvh
    q = rn(b, sq, h, d, dt=td).transpose(1, 2)
    k = _cache_view(rn, b, skv, kvh, d, td)
    v = _cache_view(rn, b, skv, kvh, d, td)
    got = flash_ops.flash_attention_cuda(q, k, v, heads_packed=hp,
                                         splits=splits, **kw)
    torch.cuda.synchronize()
    _close_rows(got, flash_ref.attention_ref(q, k, v, **kw), TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("packed,splits", FORCED)
@pytest.mark.parametrize("d,h,kvh", [(64, 8, 2), (96, 8, 2), (80, 8, 4)])
@pytest.mark.parametrize("mode", ["offsets", "causal", "full", "window"])
def test_flash_kernel_wide_blocks(cuda, mode, d, h, kvh, packed, splits):
    """bf16 blocks of 192 query rows (three consumer warpgroups) forced at
    every head dim built with them, in the plain layout's modes, with
    head packing and key splits forced; 500 queries (off the 192-row
    tile) and a longer KV prefix with offsets.  A ring, another head dim
    or another row count raises."""
    rn = _rn(torch.Generator(device=cuda).manual_seed(13), cuda)
    td = torch.bfloat16
    b, sq = 2, 500
    skv = 900 if mode == "offsets" else sq
    kw = dict(causal=mode != "full",
              window=100 if mode == "window" else None, q_offset=0)
    if mode == "offsets":
        kw["q_offset"] = torch.tensor([0, 400], dtype=torch.int32,
                                      device=cuda)
    hp = packed or h // kvh
    q = rn(b, sq, h, d, dt=td).transpose(1, 2)
    k = _cache_view(rn, b, skv, kvh, d, td)
    v = _cache_view(rn, b, skv, kvh, d, td)
    n0 = flash_ops.flash_attention.launches
    got = flash_ops.flash_attention_cuda(q, k, v, heads_packed=hp,
                                         splits=splits, rows=192, **kw)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches == n0 + 1
    _close_rows(got, flash_ref.attention_ref(q, k, v, **kw), TOL["bfloat16"])
    for bad in (dict(rows=256), dict(rows=192, causal=True, window=64,
                                     q_offset=0, kv_wrap=0, ring_len=64)):
        with pytest.raises(ValueError, match="rows"):
            flash_ops.flash_attention_cuda(q, k, v, **bad)


@pytest.mark.cuda
def test_wrappers_raise_on_shapes_not_built(cuda):
    """A head_dim, SSD shape or layout the kernels were not built for
    raises; nothing falls back to the plain version."""
    z = lambda *shape: torch.zeros(shape, device=cuda)  # noqa: E731
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.flash_attention(z(1, 2, 8, 48), z(1, 2, 8, 48),
                                  z(1, 2, 8, 48))
    with pytest.raises(ValueError, match="head_dim"):
        dec_attn_ops.decode_attention(z(1, 2, 48), z(1, 2, 8, 48),
                                      z(1, 2, 8, 48), valid_len=4)
    with pytest.raises(ValueError, match="strides"):
        flash_ops.flash_attention(z(1, 2, 16, 8).transpose(2, 3),
                                  z(1, 2, 8, 16), z(1, 2, 8, 16))
    with pytest.raises(ValueError, match="ring KV layout requires"):
        flash_ops.flash_attention(z(1, 2, 8, 16), z(1, 2, 8, 16),
                                  z(1, 2, 8, 16), kv_wrap=0, ring_len=4)
    with pytest.raises(ValueError, match="ssd kernel built"):
        ssd_ops.ssd_chunked(z(1, 128, 2, 64), z(1, 128, 2), z(2),
                            z(1, 128, 1, 32), z(1, 128, 1, 32), z(2),
                            chunk=128)


SCAN_TOL = {"float32": 2e-4, "bfloat16": 3e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c", [(2, 64, 128), (3, 200, 1000), (2, 7, 96)],
                         ids=["reduced", "off-tile", "short"])
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_scan_kernel(cuda, dtype, with_state, n, b, s, c):
    """The reduced width, S and C off the 32-step and channel tiles, and a
    sequence shorter than one tile."""
    rn = _rn(torch.Generator(device=cuda).manual_seed(5), cuda)
    td = DTYPES[dtype]
    args = (rn(b, s, c, dt=td), ssd_ref.softplus(rn(b, s, c)),
            -torch.exp(rn(c, n)), rn(b, s, n, dt=td), rn(b, s, n, dt=td),
            rn(c))
    h0 = rn(b, c, n) if with_state else None
    n0 = scan_ops.selective_scan.launches
    y, h = scan_ops.selective_scan(*args, initial_state=h0)
    torch.cuda.synchronize()
    assert scan_ops.selective_scan.launches == n0 + 1
    wy, wh = scan_ref.selective_scan_ref(*args, h0)
    assert y.dtype == wy.dtype and h.dtype == torch.float32
    err = float((y.float() - wy.float()).abs().max())
    assert err <= SCAN_TOL[dtype] * float(wy.float().abs().max())
    torch.testing.assert_close(h, wh, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c", [(1, 4133, 1536), (1, 16384, 1536),
                                   (4, 256, 1536), (3, 777, 1000)],
                         ids=["off-tile", "long", "served", "narrow"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_scan_kernel_model_scales(cuda, dtype, b, s, c):
    """Inputs at the model's scales (``scan1.ref.model_scale_inputs``: dt
    from the model's dt init, A in [-16, -1], a warmed-up state), where a
    state lives for hundreds of steps: S over many 256-step tiles and off
    them, mamba-130m's served chunk (blocks of 8 channels), and a width
    off the 8-channel blocks (B=3, C=1000: 750 blocks of 4 channels).  y
    within the scan tolerance of max |y|, the state within 1e-3."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    args, h0 = scan_ref.model_scale_inputs(gen, b, s, c, 16, DTYPES[dtype])
    y, h = scan_ops.selective_scan(*args, initial_state=h0)
    torch.cuda.synchronize()
    wy, wh = scan_ref.selective_scan_ref(*args, h0)
    err = float((y.float() - wy.float()).abs().max())
    assert err <= SCAN_TOL[dtype] * float(wy.float().abs().max())
    torch.testing.assert_close(h, wh, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1536, 1003])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_scan_kernel_writes_destination(cuda, dtype, c):
    """``out_state`` a slot of a stacked [n_rep, B, C, N] leaf (C = 1003:
    rows the wrapper pads to 1008 channels): the final state lands there
    and equals the plain version's, the other slots and the inputs stay
    as they were; ``out_state`` may also be the initial state itself."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    args, h0 = scan_ref.model_scale_inputs(gen, 2, 300, c, 16, DTYPES[dtype])
    before = [t.clone() for t in args] + [h0.clone()]
    stacked = torch.full((3, 2, c, 16), 7.0, device=cuda)
    y, fin = scan_ops.selective_scan(*args, initial_state=h0,
                                     out_state=stacked[1])
    torch.cuda.synchronize()
    assert fin.data_ptr() == stacked[1].data_ptr()
    wy, wh = scan_ref.selective_scan_ref(*args, h0)
    err = float((y.float() - wy.float()).abs().max())
    assert err <= SCAN_TOL[dtype] * float(wy.float().abs().max())
    torch.testing.assert_close(fin, wh, rtol=1e-3, atol=1e-3)
    assert bool((stacked[0] == 7.0).all() and (stacked[2] == 7.0).all())
    for t, t0 in zip(list(args) + [h0], before):
        assert torch.equal(t, t0)
    y2, fin2 = scan_ops.selective_scan(*args, initial_state=h0,
                                       out_state=h0)
    torch.cuda.synchronize()
    assert fin2.data_ptr() == h0.data_ptr()
    assert torch.equal(y2, y) and torch.equal(fin2, fin)


@pytest.mark.cuda
@pytest.mark.parametrize("wrong", ["shape", "dtype", "strides", "overlap"])
def test_selective_scan_destination_must_fit(cuda, wrong):
    """A final-state destination the kernel could not write as it stands
    raises before any launch: a wrong shape, type or layout, or one that
    overlaps an input other than the initial state."""
    z = lambda *shape: torch.zeros(shape, device=cuda)  # noqa: E731
    b, s, c, n = 2, 32, 64, 16
    x, dt = z(b, s, c), z(b, s, c)
    bad = {"shape": z(b, c, n + 1), "dtype": z(b, c, n).double(),
           "strides": z(b, n, c).transpose(1, 2),
           "overlap": dt.view(-1)[:b * c * n].view(b, c, n)}[wrong]
    n0 = scan_ops.selective_scan.launches
    with pytest.raises(ValueError, match="out_state"):
        scan_ops.selective_scan(x, dt, z(c, n), z(b, s, n), z(b, s, n),
                                z(c), initial_state=z(b, c, n),
                                out_state=bad)
    assert scan_ops.selective_scan.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("di,n,dtr", [(1536, 16, 48), (128, 16, 4),
                                      (1000, 8, 6)],
                         ids=["mamba-130m", "reduced", "off-tile"])
@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba1_decode_kernel(cuda, dtype, b, di, n, dtr):
    """mamba-130m's widths, the reduced ones, and d_inner off the
    128-channel tile with d_state 8, at batch rows up to 16 (whose 256
    blocks take two waves of the card); x_proj and dt_proj in the compute
    dtype, as the model passes them.  The inputs are at the model's
    scales (projections with std 1/sqrt(fan-in), dt_bias from dt
    log-uniform in [1e-3, 1e-1], A_log = log(1..n)), so dt lands where
    serving puts it and the old state's share of the new one is not
    rounded away by exp(dt * A) being 0 or 1."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    rn = _rn(gen, cuda)
    td = DTYPES[dtype]
    k = 4
    u = torch.rand((di,), generator=gen, device=cuda)
    dt0 = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=cuda)).repeat(di, 1)
    args = (rn(b, k - 1, di, dt=td), rn(b, di, n), rn(b, di, dt=td),
            rn(di, k) / k ** 0.5, rn(di),
            (rn(di, dtr + 2 * n) / di ** 0.5).to(td),
            (rn(dtr, di) / dtr ** 0.5).to(td), dt_bias, a_log, rn(di))
    kw = dict(d_state=n, dt_rank=dtr)
    n0 = dec_ops.mamba1_decode_fused.launches
    got = dec_ops.mamba1_decode_fused(*args, **kw)
    torch.cuda.synchronize()
    assert dec_ops.mamba1_decode_fused.launches == n0 + 1
    _close(got, dec_ref.mamba1_decode_fused_ref(*args, **kw), TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba1_decode_kernel_writes_destination(cuda, dtype):
    """``out_conv`` and ``out_ssm`` slots of stacked leaves at mamba-130m's
    widths: the new window and state land there and equal the plain
    version's; the old window and state and the other slots stay as they
    were."""
    rn = _rn(torch.Generator(device=cuda).manual_seed(15), cuda)
    td = DTYPES[dtype]
    b, di, n, dtr, k = 4, 1536, 16, 48, 4
    args = (rn(b, k - 1, di, dt=td), rn(b, di, n), rn(b, di, dt=td),
            rn(di, k) / k ** 0.5, rn(di),
            (rn(di, dtr + 2 * n) / di ** 0.5).to(td),
            (rn(dtr, di) / dtr ** 0.5).to(td), rn(di) - 4.0,
            torch.log(torch.rand((di, n), device=cuda) * 15 + 1), rn(di))
    before = [t.clone() for t in args[:2]]
    conv_dst = torch.full((3, b, k - 1, di), 7.0, device=cuda).to(td)
    ssm_dst = torch.full((3, b, di, n), 7.0, device=cuda)
    kw = dict(d_state=n, dt_rank=dtr)
    got = dec_ops.mamba1_decode_fused(*args, **kw, out_conv=conv_dst[2],
                                      out_ssm=ssm_dst[1])
    torch.cuda.synchronize()
    assert got[1].data_ptr() == conv_dst[2].data_ptr()
    assert got[2].data_ptr() == ssm_dst[1].data_ptr()
    want = dec_ref.mamba1_decode_fused_ref(*args, **kw)
    _close(got, want, TOL[dtype])
    assert torch.equal(got[1], want[1])
    assert torch.equal(args[0], before[0]) and torch.equal(args[1], before[1])
    assert bool((conv_dst[:2] == 7.0).all() and (ssm_dst[0] == 7.0).all()
                and (ssm_dst[2] == 7.0).all())


@pytest.mark.cuda
def test_wrappers_raise_on_overlap_and_cluster_size(cuda):
    """A destination that overlaps an input, or a d_inner whose blocks
    would need a cluster of more than 8, raises before any launch."""
    z = lambda *shape: torch.zeros(shape, device=cuda)  # noqa: E731
    k, n, r = 4, 16, 4

    def decode(di, **out):
        return dec_ops.mamba1_decode_fused(
            z(1, k - 1, di), z(1, di, n), z(1, di), z(di, k), z(di),
            z(di, r + 2 * n), z(r, di), z(di), z(di, n), z(di), d_state=n,
            dt_rank=r, **out)
    with pytest.raises(ValueError, match="cluster of more than 8"):
        decode(2056)
    args = [z(1, k - 1, 64), z(1, 64, n), z(1, 64), z(64, k), z(64),
            z(64, r + 2 * n), z(r, 64), z(64), z(64, n), z(64)]
    with pytest.raises(ValueError, match="out_ssm overlaps"):
        dec_ops.mamba1_decode_fused(*args, d_state=n, dt_rank=r,
                                    out_ssm=args[1])
    x, st = z(2, 8, 64), z(2, k - 1, 64)
    with pytest.raises(ValueError, match="out_state overlaps"):
        conv_ops.causal_conv1d(x, z(64, k), z(64), initial_state=st,
                               out_state=st)
    with pytest.raises(ValueError, match="out_state overlaps"):
        conv_ops.causal_conv1d(x, z(64, k), z(64), initial_state=st,
                               out_state=x.view(-1)[:st.numel()].view(
                                   st.shape))


@pytest.mark.cuda
def test_mamba1_wrappers_raise_on_shapes_not_built(cuda):
    """A d_state the Mamba-1 kernels were not built for, or projections
    wider than the decode kernel takes, raise; nothing falls back."""
    z = lambda *shape: torch.zeros(shape, device=cuda)  # noqa: E731
    with pytest.raises(ValueError, match="d_state"):
        scan_ops.selective_scan(z(1, 8, 64), z(1, 8, 64), z(64, 32),
                                z(1, 8, 32), z(1, 8, 32), z(64))
    di, k = 64, 4

    def decode(n, r):
        return dec_ops.mamba1_decode_fused(
            z(1, k - 1, di), z(1, di, n), z(1, di), z(di, k), z(di),
            z(di, r + 2 * n), z(r, di), z(di), z(di, n), z(di), d_state=n,
            dt_rank=r)
    with pytest.raises(ValueError, match="d_state"):
        decode(32, 4)
    with pytest.raises(ValueError, match="bad mamba1 decode shapes"):
        decode(16, 100)


# --------------------------------------------- the decode burst as a graph
# reduced (two units of each layer pattern, d_model 64, head_dim 16,
# d_state 16), bf16 compute and caches, as the engine serves them
GRAPH_ARCHS = ("mamba2-2.7b", "zamba2-2.7b", "mamba-130m", "llama3-8b",
               "gemma3-1b", "falcon-h1-0.5b", "qwen3-moe-235b-a22b",
               "llama4-maverick-400b-a17b", "qwen3-moe-235b-a22b:ragged")


def _graph_model(name, dev):
    """A reduced registered config; ``name:ragged`` with the ragged MoE
    dispatch."""
    from repro_torch.configs import reduced
    from repro_torch.core.registry import get
    from repro_torch.models import lm
    name, _, impl = name.partition(":")
    cfg = reduced(get(name))
    if impl:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               impl=impl))
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, lm.prepare_params(cfg, lm.init_lm_params(cfg, gen,
                                                         device=dev))


def _prefilled_cache(cfg, params, dev, b=4, prompt=20, max_seq=64):
    from repro_torch.models import lm
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (b, prompt), generator=gen,
                         device=dev)
    _, cache = lm.lm_prefill(cfg, params, toks,
                             lm.init_lm_cache(cfg, b, max_seq, device=dev))
    return cache


def _clone_cache(cache):
    from repro_torch.models.params import tree_map
    return {"segments": tree_map(torch.clone, cache["segments"]),
            "pos": cache["pos"].clone()}


def _assert_same_burst(got, want):
    from repro_torch.models.params import tree_leaves
    assert len(got) == len(want)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


def _launches():
    from repro_torch.serving.graphs import LAUNCH_COUNTERS
    return [getattr(fn, attr) for fn, attr in LAUNCH_COUNTERS]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_decode_graph_replays_match_eager_burst(cuda, arch):
    """Three 8-step bursts at one key (the first eager, then capture; two
    replays), each against an eager ``decode_tokens`` from a clone of the
    same cache: tokens, ``ok``, ``pos`` and every cache leaf bit for bit;
    the state leaves stay at the cache's addresses."""
    from repro_torch.models import lm
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.graphs import make_decode_tokens
    cfg, params = _graph_model(arch, cuda)
    cache = _prefilled_cache(cfg, params, cuda)
    own = [t.data_ptr() for t in tree_leaves(cache["segments"])]
    spare = lm.init_spare_states(cache)
    decode_n = make_decode_tokens(cfg)
    first = torch.randint(0, cfg.vocab_size, (4, 1), dtype=torch.int32,
                          device=cuda)
    for _ in range(3):
        want = lm.decode_tokens(cfg, params, _clone_cache(cache), first, 8,
                                kv_bucket=48, rope_len=64,
                                with_sentinel=True)
        got = decode_n(params, cache, first, 8, kv_bucket=48, rope_len=64,
                       with_sentinel=True, spare=spare)
        torch.cuda.synchronize()
        _assert_same_burst(got, want)
        assert bool(got[2].all())
        cache, first = got[1], got[0][:, -1:].clone()
        assert [t.data_ptr() for t in tree_leaves(cache["segments"])] == own
    assert (decode_n.captures, decode_n.replays) == (1, 2)
    assert decode_n.keys == [(4, 8, 48, 64, True)]


def _checked_engine(cfg, params, dev, seen):
    """An engine whose every burst is also run eagerly from a clone of its
    cache and held to it bit for bit; ``seen`` collects the buckets."""
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, params, slots=2, max_seq=256, decode_block=4,
                        chunk_size=32, device=dev)
    real = eng._decode_n

    def checked(params_, cache, first, n, kv_bucket=None, rope_len=None,
                with_sentinel=False, *, spare=None):
        ref = _clone_cache(dict(cache, pos=cache["pos"].to(dev)))
        want = lm.decode_tokens(cfg, params_, ref, first.to(dev), n,
                                kv_bucket=kv_bucket, rope_len=rope_len,
                                with_sentinel=with_sentinel)
        got = real(params_, cache, first, n, kv_bucket, rope_len,
                   with_sentinel, spare=spare)
        _assert_same_burst(got, want)
        seen.append(kv_bucket)
        return got
    eng._decode_n = checked
    return eng, real


def _serve(eng, cfg):
    import numpy as np
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(3)
    for i, n in enumerate((9, 120, 17, 140, 23)):
        eng.submit(Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, n),
                           max_new=12))
    done = eng.run()
    assert [r.status for r in done] == ["ok"] * 5
    return {r.rid: r.out for r in done}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_engine_graph_bursts_match_eager_across_buckets(cuda, arch):
    """5 ragged requests through 2 slots, 4-token bursts: requests are
    admitted mid-flight (their prefill groups scattered into the slots
    between bursts) and the KV bucket climbs past its 128-row rung; every
    burst equals an eager burst from a clone of the cache, and every burst
    after the first at its key is a replay."""
    cfg, params = _graph_model(arch, cuda)
    seen = []
    eng, runner = _checked_engine(cfg, params, cuda, seen)
    _serve(eng, cfg)
    keys = set(runner.keys)
    assert runner.captures == len(keys)
    assert runner.replays == len(seen) - len(keys) > 0
    if cfg.attn is not None or cfg.shared_attn is not None:
        assert len(set(seen)) >= 2


@pytest.mark.cuda
def test_second_engine_gets_its_own_graphs(cuda):
    """Two engines in one process on the same params: each captures its
    own graphs over its own cache, and their streams are equal."""
    cfg, params = _graph_model("zamba2-2.7b", cuda)
    from repro_torch.serving.engine import ServingEngine
    outs, runners = [], []
    for _ in range(2):
        eng = ServingEngine(cfg, params, slots=2, max_seq=256,
                            decode_block=4, chunk_size=32, device=cuda)
        outs.append(_serve(eng, cfg))
        runners.append(eng._decode_n)
    assert outs[0] == outs[1]
    assert runners[0] is not runners[1]
    assert runners[0].captures > 0 and runners[1].captures > 0
    assert runners[0].replays > 0 and runners[1].replays > 0
    assert not set(runners[0]._bursts) & set(runners[1]._bursts)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_graph_launch_counts_equal_eager(cuda, arch):
    """The wrappers' launch counters: an eager burst adds its launches;
    the runner's first call (eager, then a capture that is not counted)
    and each replay add the same."""
    from repro_torch.models import lm
    from repro_torch.serving.graphs import make_decode_tokens
    cfg, params = _graph_model(arch, cuda)
    cache = _prefilled_cache(cfg, params, cuda)
    first = torch.zeros((4, 1), dtype=torch.int32, device=cuda)
    before = _launches()
    lm.decode_tokens(cfg, params, _clone_cache(cache), first, 8,
                     kv_bucket=48, rope_len=64)
    eager = [a - b for a, b in zip(_launches(), before)]
    assert sum(eager) > 0
    decode_n = make_decode_tokens(cfg)
    spare = lm.init_spare_states(cache)
    for _ in range(3):
        before = _launches()
        decode_n(params, cache, first, 8, kv_bucket=48, rope_len=64,
                 spare=spare)
        assert [a - b for a, b in zip(_launches(), before)] == eager
    assert decode_n.replays == 2


@pytest.mark.cuda
def test_graph_burst_needs_the_spare_set(cuda):
    """On the card the runner refuses a burst without the spare state set
    (its graphs would write new state buffers on every call) and launches
    nothing."""
    from repro_torch.serving.graphs import make_decode_tokens
    cfg, params = _graph_model("mamba2-2.7b", cuda)
    cache = _prefilled_cache(cfg, params, cuda)
    before = _launches()
    with pytest.raises(ValueError, match="spare state set"):
        make_decode_tokens(cfg)(params, cache, torch.zeros(
            (4, 1), dtype=torch.int32, device=cuda), 8)
    assert _launches() == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "gemma3-1b"])
def test_capture_creates_no_cached_tensor(cuda, arch, monkeypatch):
    """Inside the capture no rope table and no ticket counter is made: the
    eager call before it at the same key made them all (a tensor first
    made inside a capture holds garbage until a replay)."""
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.models import lm, rope
    from repro_torch.serving import graphs
    cfg, params = _graph_model(arch, cuda)
    cache = _prefilled_cache(cfg, params, cuda)
    rope._tables.cache_clear()
    real, during = graphs.decode_tokens, []

    def state():
        info = rope._tables.cache_info()
        return (info.currsize, info.misses,
                {d: t.data_ptr() for d, t in flash_ops._TICKETS.items()},
                len(flash_ops._RETIRED_TICKETS))

    def spy(*a, **kw):
        capturing = torch.cuda.is_current_stream_capturing()
        s0 = state()
        out = real(*a, **kw)
        during.append((capturing, s0, state()))
        return out
    monkeypatch.setattr(graphs, "decode_tokens", spy)
    decode_n = graphs.make_decode_tokens(cfg)
    first = torch.zeros((4, 1), dtype=torch.int32, device=cuda)
    decode_n(params, cache, first, 8, kv_bucket=48, rope_len=64,
             spare=lm.init_spare_states(cache))
    assert [c for c, _, _ in during] == [False, True]
    eager, capture = during
    assert eager[2][1] > eager[1][1]          # the eager call made tables
    assert capture[1] == capture[2] == eager[2]


# ------------------------------------ the engine's control layer on the card

def _leaf_ptrs(cache):
    from repro_torch.models.params import tree_leaves
    return [t.data_ptr() for t in tree_leaves(cache)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "gemma3-1b",
                                  "falcon-h1-0.5b"])
def test_restore_into_another_slot_in_place(cuda, arch):
    """Slot 1 offloaded to the host (pinned) and restored into slot 3:
    every leaf keeps its address, slot 3 holds slot 1's rows bit for bit
    and ``pos``, the other slots are untouched."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.cache import offload_slots, restore_slot
    cfg, params = _graph_model(arch, cuda)
    cache = _prefilled_cache(cfg, params, cuda)
    cache["pos"].copy_(torch.tensor([20, 13, 20, 7], dtype=torch.int32))
    before = _clone_cache(cache)
    ptrs = _leaf_ptrs(cache)
    blob = offload_slots(cache, [1, 2])[1]
    assert all(v.device.type == "cpu" for k, v in blob.items()
               if k != "__meta__")
    assert restore_slot(cache, blob, 3, rid=0) is cache
    torch.cuda.synchronize()
    assert _leaf_ptrs(cache) == ptrs
    for now, old in zip(tree_leaves(cache["segments"]),
                        tree_leaves(before["segments"])):
        assert torch.equal(now[:, 3], old[:, 1])
        assert torch.equal(now[:, :3], old[:, :3])
    assert cache["pos"].tolist() == [20, 13, 20, 13]


@pytest.mark.cuda
def test_poison_slot_one_row_on_the_card(cuda):
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.fault_inject import poison_slot
    cfg, params = _graph_model("zamba2-2.7b", cuda)
    cache = _prefilled_cache(cfg, params, cuda)
    ptrs = _leaf_ptrs(cache)
    poison_slot(cache, 2)
    assert _leaf_ptrs(cache) == ptrs
    for leaf in tree_leaves(cache["segments"]):
        assert bool(torch.isnan(leaf[:, 2].float()).all())
        for b in (0, 1, 3):
            assert bool(torch.isfinite(leaf[:, b].float()).all())


@pytest.mark.cuda
def test_sentinel_burst_key_and_one_transfer(cuda, monkeypatch):
    """The engine's bursts run at sentinel keys; a decode-only step moves
    its tokens and flags to the host in one ``.cpu()``; a NaN poked into
    one slot trips only that row, which is replayed from its checkpoint
    and finishes with the stream of a clean run."""
    import numpy as np
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.fault_inject import FaultPlan
    cfg, params = _graph_model("zamba2-2.7b", cuda)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, cfg.vocab_size, n) for n in (9, 17)]

    def serve(spec):
        eng = ServingEngine(cfg, params, slots=2, max_seq=256,
                            decode_block=4, chunk_size=32, device=cuda,
                            checkpoint_every=2,
                            fault_plan=FaultPlan.from_spec(spec))
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new=16))
        while eng._chunked_prefill.active or eng.queue:
            eng.step()
        calls = []
        real = torch.Tensor.cpu
        monkeypatch.setattr(torch.Tensor, "cpu",
                            lambda t, *a, **k: (calls.append(1),
                                                real(t, *a, **k))[1])
        eng.step()
        monkeypatch.setattr(torch.Tensor, "cpu", real)
        assert len(calls) == 1
        eng.run()
        return eng
    clean = serve("")
    assert all(k[4] for k in clean._decode_n.keys)
    faulted = serve("nan_decode@iter=2:slot=1")
    assert faulted.stats["divergences"] == faulted.stats["replays"] == 1
    assert {r.rid: r.out for r in faulted.finished} == \
        {r.rid: r.out for r in clean.finished}
    assert set(faulted._decode_n.keys) == set(clean._decode_n.keys)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "gemma3-1b"])
def test_bf16_blob_roundtrip_through_the_file(cuda, arch):
    """A bf16 slot blob written by ``dump_blob`` and read by ``parse_blob``
    validates, names its dtypes as the reference does and restores the
    slot bit for bit."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.cache import (offload_slot, restore_slot,
                                           slot_schema, validate_blob)
    from repro_torch.serving.store import dump_blob, parse_blob
    cfg, params = _graph_model(arch, cuda)
    cache = _prefilled_cache(cfg, params, cuda)
    blob = offload_slot(cache, 0, tags={"rid": 5})
    back = parse_blob(dump_blob(blob))
    validate_blob(back, list(slot_schema(cache)), rid=5)
    assert "bfloat16" in {v[1] for v in slot_schema(cache).values()}
    before = _clone_cache(cache)
    restore_slot(cache, back, 2, expect_tags={"rid": 5})
    for now, old in zip(tree_leaves(cache["segments"]),
                        tree_leaves(before["segments"])):
        assert torch.equal(now[:, 2], old[:, 0])


# ------------------------------------------------- the measured profiler

def _window_ops(path):
    """The device operations of the CUDA calls made inside the profiler's
    window, read from its trace by correlation id."""
    import json
    from repro_torch.serving.profiler import WINDOW
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    win = next(e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation")
    lo, hi = win["ts"], win["ts"] + win["dur"]
    ids = {e.get("args", {}).get("correlation") for e in events
           if str(e.get("cat", "")).startswith("cuda_")
           and lo <= e["ts"] <= hi} - {None}
    return [e for e in events if "dur" in e
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and e.get("args", {}).get("correlation") in ids]


@pytest.mark.cuda
def test_profiler_trace_windows_attribute_every_kernel(cuda, tmp_path):
    """Reduced falcon-h1-0.5b (attention and Mamba-2 in each layer): trace
    windows over an eager prefill chunk, an eager 8-step burst and a
    replay of that burst's graph (learned at its first call), each held
    to (a) attributed plus unattributed ms equal to the trace's summed
    device time of the window's calls within 1%, (b) nothing
    unattributed and not degraded, (c) ``ssm`` at least the SSM kernels'
    time by name and ``other`` at least the attention kernels'."""
    from repro_torch.models import lm
    from repro_torch.serving.graphs import make_decode_tokens
    from repro_torch.serving.profiler import Profiler
    cfg, params = _graph_model("falcon-h1-0.5b", cuda)
    cache = _prefilled_cache(cfg, params, cuda)
    spare = lm.init_spare_states(cache)
    prof = Profiler(mode="trace", trace_dir=str(tmp_path))
    runner = make_decode_tokens(cfg, prof)
    first = torch.zeros((4, 1), dtype=torch.int32, device=cuda)
    chunk = torch.ones((4, 16), dtype=torch.long, device=cuda)

    def burst():
        runner(params, cache, first, 8, spare=spare)[0].cpu()
    burst()                                  # learned, then captured
    calls = {
        "chunk": lambda: lm.lm_prefill_chunk(cfg, params, chunk,
                                             cache)[0].cpu(),
        "eager": lambda: lm.decode_tokens(cfg, params, cache, first, 8,
                                          _spare_states=spare)[0].cpu(),
        "replay": burst}
    for name, fn in calls.items():
        with prof.window(name) as ft:
            fn()
        ops = _window_ops(prof.last_trace)
        total = sum(e["dur"] for e in ops) / 1e3
        assert total > 0
        got = sum(ft.ms.values()) + ft.unattributed_ms
        assert abs(got - total) <= 0.01 * total, name
        assert ft.unattributed_ms == 0 and not ft.degraded, name
        by = lambda *ks: sum(e["dur"] for e in ops if e["cat"] == "kernel"
                             and any(k in e["name"] for k in ks)) / 1e3
        ssm = by("conv1d_kernel", "m2_decode_kernel", "ssd_kernel",
                 "ssd_tc_kernel")
        attn = by("flash_wgmma_kernel", "flash_f32_kernel",
                  "decode_bf16_kernel", "decode_f32_kernel")
        assert ssm > 0 and attn > 0, name
        assert ft.ms["ssm"] >= ssm * (1 - 1e-9), name
        assert ft.ms["other"] >= attn * (1 - 1e-9), name
    assert runner.replays == 1 and runner.captures == 1


# --------------------------------------------------------- the MoE layer
# qwen3-moe-235b-a22b's expert shapes (d_model 4096, expert d_ff 1536)
# with 8 experts, top 2: 4 x 64 tokens


def _moe_case(cf, impl="gshard"):
    from repro_torch.core.config import MoEConfig
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    m = MoEConfig(n_experts=8, experts_per_token=2, d_ff_expert=1536,
                  capacity_factor=cf, impl=impl)
    gen = torch.Generator().manual_seed(40)
    p = init_params(moe.moe_param_defs(4096, m), gen, torch.float32,
                    torch.device("cpu"))
    x = torch.randn((4, 64, 4096), generator=gen)
    return m, p, x


def _to(p, x, dev, dt):
    """The layer's params and input on ``dev``, the experts and x in
    ``dt`` (the router stays fp32, as ``prepare_params`` leaves it)."""
    cast = {k: (v if k == "router" else v.to(dt)) for k, v in p.items()}
    return ({k: v.to(dev) for k, v in cast.items()}, x.to(dt).to(dev))


def _moe_plain(p, x, m):
    """Every token's top-k experts applied one by one, gate-weighted, in
    fp32 on the CPU: the function both dispatch paths compute where
    nothing drops."""
    import torch.nn.functional as F
    xf = x.float().reshape(-1, x.shape[-1])
    gates, idx = torch.topk(xf @ p["router"].float(), m.experts_per_token,
                            dim=-1)
    gates = torch.softmax(gates, -1)
    y = torch.zeros_like(xf)
    for e in range(m.n_experts):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel():
            h = xf[rows] @ p["wi"][e].float()
            g = xf[rows] @ p["wg"][e].float()
            y[rows] += gates[rows, slot, None] * (
                (F.silu(g) * h) @ p["wo"][e].float())
    return y.reshape(x.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gshard_on_card_matches_cpu(cuda, dtype):
    """The gshard path on the card against the same function on the CPU
    from the same (rounded) inputs, at the default capacity factor 1.25,
    where choices drop."""
    from repro_torch.models import moe
    m, p, x = _moe_case(1.25)
    td = DTYPES[dtype]
    pc, xc = _to(p, x, "cpu", td)
    pd, xd = _to(p, x, cuda, td)
    want = moe.moe_gshard(pc, xc, m, 1)
    got = moe.moe_gshard(pd, xd, m, 1)
    torch.cuda.synchronize()
    _close([got.cpu()], [want], TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["gshard", "ragged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_on_card_matches_plain(cuda, dtype, impl):
    """Both paths on the card at a capacity where nothing drops, against
    the plain per-expert loop in fp32 on the CPU from the same rounded
    inputs (in bf16: one rounding of each product)."""
    from repro_torch.models import moe
    m, p, x = _moe_case(8.0, impl)
    td = DTYPES[dtype]
    pd, xd = _to(p, x, cuda, td)
    pc, xc = _to(p, x, "cpu", td)
    got = moe.moe(pd, xd, m)
    torch.cuda.synchronize()
    _close([got.cpu().float()], [_moe_plain(pc, xc, m)], TOL[dtype])


@pytest.mark.cuda
def test_moe_ragged_equals_gshard_without_drops(cuda):
    """bf16 on the card, capacity factor 8: the two paths agree."""
    from repro_torch.models import moe
    m, p, x = _moe_case(8.0)
    pd, xd = _to(p, x, cuda, torch.bfloat16)
    a = moe.moe_gshard(pd, xd, m, 1)
    b = moe.moe_ragged(pd, xd, m)
    torch.cuda.synchronize()
    _close([a.float()], [b.float()], TOL["bfloat16"])


# ------------------------------------------------------------ training


def _bwd_case(kind, rn, td):
    """Inputs of one backward kernel and its plain version."""
    if kind == "conv1d":
        x, dy = rn(2, 100, 48, dt=td), rn(2, 100, 48, dt=td)
        w, b = 0.5 * rn(48, 4), 0.1 * rn(48)
        return (lambda: conv_ops.causal_conv1d_bwd_cuda(x, w, b, dy),
                lambda: conv_ref.causal_conv1d_bwd_ref(x, w, b, dy))
    if kind.startswith("ssd"):
        # ssd16 the CUDA-core route in both types; the rest tensor cores
        # in bf16: 4 chunks at S=512 carry the state pass, and 32 heads
        # on 2 groups give each group two slices of 8 heads to sum
        b, s, h, p, g, n, q = {"ssd16": (2, 64, 4, 16, 2, 16, 16),
                               "ssd128": (2, 256, 4, 64, 1, 64, 128),
                               "ssd_n64": (2, 512, 32, 64, 2, 64, 128),
                               "ssd_n128": (2, 512, 8, 64, 1, 128, 128)}[kind]
        gen = torch.Generator(device="cuda").manual_seed(1)
        (x, dt, A, _, _, D), _ = ssd_ref.model_scale_inputs(gen, b, s, h, p,
                                                            n, td)
        Bm, Cm = rn(b, s, g, n, dt=td), rn(b, s, g, n, dt=td)
        dy = rn(b, s, h, p, dt=td)
        _, _, st = ssd_ref.ssd_chunked_states_ref(x, dt, A, Bm, Cm, D,
                                                  chunk=q)
        return (lambda: ssd_ops.ssd_chunked_bwd_cuda(x, dt, A, Bm, Cm, D, dy,
                                                     st, chunk=q),
                lambda: ssd_ref.ssd_chunked_bwd_ref(x, dt, A, Bm, Cm, D, dy,
                                                    st, chunk=q))
    if kind.startswith("scan1"):
        # the Mamba-1 scan's backward with the final state's gradient:
        # inside one 256-step tile with channels off the block (40, 50);
        # over three tiles, the last ragged, channels off the cluster's 64
        # (200), at N = 16 and 8
        b, s, c, n = {"scan1": (2, 150, 40, 16),
                      "scan1_n8": (3, 70, 50, 8),
                      "scan1_tiles": (2, 700, 200, 16),
                      "scan1_tiles_n8": (2, 700, 200, 8)}[kind]
        gen = torch.Generator(device="cuda").manual_seed(2)
        (x, dt, A, Bm, Cm, D), _ = scan_ref.model_scale_inputs(gen, b, s, c,
                                                               n, td)
        dy, dfin = rn(b, s, c, dt=td), rn(b, c, n)
        ins = (x, dt, A, Bm, Cm, D, dy, dfin)
        return (lambda: scan_ops.selective_scan_bwd_cuda(*ins),
                lambda: scan_ref.selective_scan_bwd_ref(*ins))
    # flash16 the CUDA-core route in both types; flash64 to flash128 wgmma
    # in bf16 (d=80 and 128 padded to 128 columns); flash256 CUDA cores in
    # both (32-row tiles); S not a multiple of a tile; the window (shorter
    # than S, its band's edges inside tiles) and the non-causal mode on
    # both routes
    bh, kvh, s, d, causal, window = {
        "flash16": (6, 2, 100, 16, True, None),
        "flash64": (9, 3, 130, 64, True, None),
        "flash80": (32, 32, 300, 80, True, None),
        "flash128": (8, 2, 130, 128, True, None),
        "flash256": (4, 1, 100, 256, True, None),
        "flash_window16": (6, 2, 200, 16, True, 37),
        "flash_window64": (4, 1, 300, 64, True, 77),
        "flash_window256": (4, 1, 200, 256, True, 45),
        "flash_noncausal16": (6, 2, 100, 16, False, None),
        "flash_noncausal80": (16, 16, 300, 80, False, None)}[kind]
    q, k, v = rn(2, bh, s, d, dt=td), rn(2, kvh, s, d, dt=td), rn(
        2, kvh, s, d, dt=td)
    do = rn(2, bh, s, d, dt=td)
    o, lse = flash_ref.attention_lse_ref(q, k, v, causal=causal,
                                         window=window)
    return (lambda: flash_ops.flash_attention_bwd_cuda(
                q, k, v, o, do, lse, causal=causal, window=window),
            lambda: flash_ref.flash_bwd_ref(q, k, v, o, do, lse,
                                            causal=causal, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("s", [100, 2048])
@pytest.mark.parametrize("c", [48, 5248, 52])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_bwd_kernel(cuda, dtype, c, s, k):
    """The conv1d backward on vectors of channels: C = 48, zamba2-2.7b's
    5248 and 52 (a narrower vector in bf16: 52 = 4 x 13), S = 100 (off
    the 128-row block) and 2048, K = 2, 3 and 4; dx, dw and db within 1e-4
    (fp32) or 3e-2 (bf16) of their own max |g| against the plain
    backward, two calls bit for bit, one launch a call, and the plan's
    vector width (8 bytes: 4 bf16 or 2 fp32 channels a thread)."""
    rn = _rn(torch.Generator(device=cuda).manual_seed(11), cuda)
    td = DTYPES[dtype]
    x, dy = rn(2, s, c, dt=td), rn(2, s, c, dt=td)
    w, b = 0.5 * rn(c, k), 0.1 * rn(c)
    n0 = conv_ops.causal_conv1d_bwd_cuda.launches
    got = conv_ops.causal_conv1d_bwd_cuda(x, w, b, dy)
    again = conv_ops.causal_conv1d_bwd_cuda(x, w, b, dy)
    torch.cuda.synchronize()
    assert conv_ops.causal_conv1d_bwd_cuda.launches == n0 + 2
    want = conv_ref.causal_conv1d_bwd_ref(x, w, b, dy)
    tol = 1e-4 if dtype == "float32" else 3e-2
    for a, a2, r in zip(got, again, want):
        assert a.shape == r.shape
        assert torch.equal(a, a2)
        err = float((a.float() - r.float()).abs().max())
        assert err <= tol * float(r.float().abs().max()), err
    want = 8 // x.element_size()   # 8-byte vectors where C allows
    while c % want:
        want //= 2
    assert conv_ops.conv1d_bwd_plan(2, s, c, k, td).vec == want


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["conv1d", "ssd16", "ssd128", "ssd_n64",
                                  "ssd_n128", "flash16", "flash64",
                                  "flash80", "flash128", "flash256",
                                  "flash_window16", "flash_window64",
                                  "flash_window256", "flash_noncausal16",
                                  "flash_noncausal80", "scan1", "scan1_n8",
                                  "scan1_tiles", "scan1_tiles_n8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernels_match_plain_and_repeat(cuda, dtype, kind):
    """Each backward kernel against its plain backward: every gradient
    within 1e-4 (fp32) or 3e-2 (bf16) of its own max |g|; and two calls
    give the same bits (no atomics)."""
    rn = _rn(torch.Generator(device=cuda).manual_seed(0), cuda)
    kern, plain = _bwd_case(kind, rn, DTYPES[dtype])
    got, again, want = kern(), kern(), plain()
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == "float32" else 3e-2
    for a, a2, b in zip(got, again, want):
        assert a.shape == b.shape
        assert torch.equal(a, a2)
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), (kind, err)


@pytest.mark.cuda
def test_kernels_without_backward_raise_under_grad(cuda):
    """The calls with no backward kernel (the Mamba-1 scan from a state,
    flash attention at a query offset) raise on the card when a gradient
    is asked for, instead of returning an output autograd cannot see
    through; without one they launch."""
    rn = _rn(torch.Generator(device=cuda).manual_seed(0), cuda)
    b, s, c, n = 1, 16, 32, 16
    x = rn(b, s, c).requires_grad_()
    args = (x, rn(b, s, c).abs(), -rn(c, n).abs(), rn(b, s, n), rn(b, s, n),
            rn(c))
    with pytest.raises(NotImplementedError, match="selective_scan"):
        scan_ops.selective_scan(*args, initial_state=rn(b, c, n))
    q = rn(1, 2, 64, 16).requires_grad_()
    with pytest.raises(NotImplementedError, match="flash_attention"):
        flash_ops.flash_attention(q, rn(1, 2, 64, 16), rn(1, 2, 64, 16),
                                  q_offset=4)
    with torch.no_grad():
        y, _ = scan_ops.selective_scan(*args)
    assert y.grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["scan1", "window", "noncausal", "d256"])
def test_new_backward_modes_run_their_functions(cuda, mode):
    """Under grad the wrappers run ``ScanFn`` (the scan from a zero
    state) and ``FlashFn`` (a window over a full sequence, non-causal,
    head_dim 256): the forward and backward kernels launch once each, the
    gradients equal the backward kernel's own on the forward's saved
    outputs, and they agree with the plain backward on the plain
    forward's outputs (so the forward's log-sum-exp in each mode is
    right): within 3e-2 of each gradient's max |g| in bf16."""
    rn = _rn(torch.Generator(device=cuda).manual_seed(4), cuda)
    bf = torch.bfloat16
    if mode == "scan1":
        gen = torch.Generator(device="cuda").manual_seed(5)
        (x, dt, A, Bm, Cm, D), _ = scan_ref.model_scale_inputs(
            gen, 2, 96, 48, 16, bf)
        ins = [t.detach().requires_grad_() for t in (x, dt, A, Bm, Cm, D)]
        fwd, bwd = scan_ops.selective_scan, scan_ops.selective_scan_bwd_cuda
        n0 = (fwd.launches, bwd.launches)
        y, _ = fwd(*ins)
        name = "ScanFn"
    else:
        h, kvh, s, d, causal, window = {
            "window": (4, 1, 200, 64, True, 50),
            "noncausal": (16, 16, 150, 80, False, None),
            "d256": (4, 1, 100, 256, True, None)}[mode]
        ins = [rn(2, n_, s, d, dt=bf).requires_grad_()
               for n_ in (h, kvh, kvh)]
        fwd = flash_ops.flash_attention
        bwd = flash_ops.flash_attention_bwd_cuda
        n0 = (fwd.launches, bwd.launches)
        y = fwd(*ins, causal=causal, window=window)
        name = "FlashFn"
    assert type(y.grad_fn).__name__.startswith(name)
    dy = rn(*y.shape, dt=y.dtype)
    got = torch.autograd.grad(y, ins, dy)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (n0[0] + 1, n0[1] + 1)
    if mode == "scan1":
        want = bwd(*[t.detach() for t in ins], dy)
        plain = scan_ref.selective_scan_bwd_ref(*[t.detach() for t in ins],
                                                dy)
    else:
        q, k, v = (t.detach() for t in ins)
        o, lse = flash_ops.flash_attention_cuda(q, k, v, causal=causal,
                                                window=window, lse=True)
        want = bwd(q, k, v, o, dy, lse, causal=causal, window=window)
        o, lse = flash_ref.attention_lse_ref(q, k, v, causal=causal,
                                             window=window)
        plain = flash_ref.flash_bwd_ref(q, k, v, o, dy, lse, causal=causal,
                                        window=window)
    for a, b, c in zip(got, want, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)
        err = float((a.float() - c.float()).abs().max())
        assert err <= 3e-2 * float(c.float().abs().max()), (mode, err)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["gshard", "ragged"])
def test_moe_gradients_on_the_card(cuda, impl):
    """The MoE layer trains on the card: the gradients of a ``.sum()``
    (a broadcast, stride-0 upstream gradient) through both dispatch
    paths at 8 experts of qwen3-moe's expert shapes, top 2, a shared
    expert, against the same layer's gradients on the CPU (fp32, within
    1e-4 of each leaf's max |g|), and two backward passes bit for bit."""
    from repro_torch.core.config import MoEConfig
    from repro_torch.models import moe
    m = MoEConfig(n_experts=8, experts_per_token=2, d_ff_expert=1536,
                  capacity_factor=4.0, shared_expert=True, impl=impl)
    gen = torch.Generator(device="cpu").manual_seed(6)
    d = 512
    p = {k: (torch.randn(v.shape, generator=gen) / v.shape[-2] ** 0.5
             if len(v.shape) > 1 else torch.randn(v.shape, generator=gen))
         for k, v in moe.moe_param_defs(d, m).items()}
    x = torch.randn(2, 64, d, generator=gen)

    def grads(dev):
        pd = {k: v.to(dev).requires_grad_() for k, v in p.items()}
        xd = x.to(dev).requires_grad_()
        y = moe.moe(pd, xd, m, 1)
        return torch.autograd.grad(y.sum(), [xd, *pd.values()])
    got, again = grads(cuda), grads(cuda)
    want = grads("cpu")
    torch.cuda.synchronize()
    for a, a2, b in zip(got, again, want):
        assert torch.equal(a, a2)
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-4 * max(float(b.abs().max()), 1e-30), err


def _plain_kernels():
    """The training path's kernels swapped for their plain versions
    (autograd runs through them)."""
    import contextlib
    from unittest import mock
    from repro_torch.kernels.ssd.ref import preprocess_dt_A
    from repro_torch.models import attention, mamba2

    def ssd(x, dt_raw, dt_bias, A_log, Bm, Cm, D, *, chunk, initial_state,
            out_state=None):
        dt, A = preprocess_dt_A(dt_raw, dt_bias, A_log)
        return ssd_ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=chunk)

    def conv(x, w, b, *, initial_state=None, activation="silu",
             lengths=None, out_state=None):
        return conv_ref.causal_conv1d_ref(x, w, b)

    def flash(q, k, v, *, causal=True, window=None, **_):
        return flash_ref.attention_ref(q, k, v, causal=causal, window=window)

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(mamba2, "ssd_chunked_raw", ssd))
    stack.enter_context(mock.patch.object(mamba2, "causal_conv1d", conv))
    stack.enter_context(mock.patch.object(attention, "flash_attention",
                                          flash))
    return stack


@pytest.mark.cuda
def test_train_step_kernel_path_matches_plain_path(cuda):
    """One step of a tiny zamba2-style hybrid (the reference's system-test
    config) in fp32 on the card: loss within 1e-5 relative and every
    gradient within 1e-4 of its leaf's max through the kernels against
    autograd through the plain versions; each backward kernel ran."""
    from repro_torch.core.config import AttnConfig, ModelConfig, SSMConfig
    from repro_torch.models.lm import init_lm_params
    from repro_torch.models.params import tree_leaves, tree_unflatten
    from repro_torch.train.train_step import make_loss_fn
    cfg = ModelConfig(
        name="sys-hybrid", family="hybrid", n_layers=4, d_model=64, d_ff=0,
        vocab_size=64, ssm=SSMConfig(d_state=16, headdim=16, chunk=16),
        shared_attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=16),
        shared_attn_d_ff=128, layer_pattern=("mamba2", "mamba2+shared"),
        vocab_pad_multiple=16, compute_dtype="float32")
    params = init_lm_params(cfg, device=cuda)
    toks = torch.randint(0, 64, (2, 64), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    batch = {"tokens": toks, "labels": toks}
    loss_fn = make_loss_fn(cfg)

    def grads():
        live = [t.detach().requires_grad_() for t in tree_leaves(params)]
        loss = loss_fn(tree_unflatten(params, live), batch)
        return loss, torch.autograd.grad(loss, live)

    counts = (flash_ops.flash_attention_bwd_cuda, ssd_ops.ssd_chunked_bwd_cuda,
              conv_ops.causal_conv1d_bwd_cuda)
    n0 = [f.launches for f in counts]
    loss_k, g_k = grads()
    assert all(f.launches > n for f, n in zip(counts, n0))
    with _plain_kernels():
        loss_p, g_p = grads()
    torch.cuda.synchronize()
    assert abs(float(loss_k) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    for a, b in zip(g_k, g_p):
        err = float((a - b).abs().max())
        assert err <= 1e-4 * max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "llama3-8b"])
def test_sampled_burst_on_the_card(cuda, arch):
    """``decode_tokens`` at temperature 0.8 through the kernels: one seed
    gives one burst bit for bit, tokens below the vocab, the sentinel
    clear; temperature 0 with a generator is the greedy burst bit for bit
    and draws nothing; a generator on the CPU is refused."""
    from repro_torch.models import lm
    cfg, params = _graph_model(arch, cuda)
    cache = _prefilled_cache(cfg, params, cuda)
    first = torch.zeros((4, 1), dtype=torch.int32, device=cuda)

    def burst(gen, temperature=0.8):
        return lm.decode_tokens(cfg, params, _clone_cache(cache), first, 8,
                                with_sentinel=True, temperature=temperature,
                                generator=gen)
    a = burst(torch.Generator(device=cuda).manual_seed(5))
    b = burst(torch.Generator(device=cuda).manual_seed(5))
    _assert_same_burst(a, b)
    assert bool(a[2].all()) and int(a[0].max()) < cfg.vocab_size
    gen = torch.Generator(device=cuda).manual_seed(6)
    state = gen.get_state()
    _assert_same_burst(burst(gen, 0.0), lm.decode_tokens(
        cfg, params, _clone_cache(cache), first, 8, with_sentinel=True))
    assert torch.equal(gen.get_state(), state)
    with pytest.raises(ValueError, match="generator is on cpu"):
        burst(torch.Generator(device="cpu").manual_seed(5))
