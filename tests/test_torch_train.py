"""The port's training path against the reference, on the CPU.

* The plain backwards of the kernels on the training path (flash
  attention with GQA: causal, in a window shorter than S, non-causal off
  a tile, causal at head_dim 256; the SSD scan; conv1d; the Mamba-1
  selective scan, with its final state's gradient) against ``jax.vjp``
  of the reference's plain versions, directly and through the wrappers'
  ``autograd.Function``s (each case asserts its ``...Fn``): fp32,
  within 1e-4 of each gradient's max |g|.  The new backwards' launch
  plans at gemma3-1b's, hubert-xlarge's and mamba-130m's shapes.
* AdamW, the global norm, clipping and the warmup against the reference's
  on random trees (fp32 math on both sides: within 1e-6 relative).
* ``SyntheticLM`` batches and the tokenizer, bit for bit.
* One ``make_train_step`` at microbatches 1 and 2 on the reference's tiny
  hybrid (``tests/test_system.py``) and reduced smollm-135m, gemma3-1b
  (one unit: local and global layers), hubert-xlarge (frame features),
  qwen3-moe (gshard and ragged), llama4-maverick (one unit), mamba-130m
  and llava-next (patch features), from the reference's params carried
  over (``from_jax``), against the reference's jitted step (gradients
  accumulated in the compute dtype).  fp32: loss
  within 1e-5 relative, grad norm within 1e-4,
  lr exact, each first moment (0.1 x the clipped gradient) within 1e-4 of
  its leaf's max, and the new params within 1e-5 where the gradient is
  above 1e-3 of its leaf's max (AdamW's first step moves a weight by
  lr x sign(g); where g is at the level of the two sides' rounding its
  sign may differ, so there they are held within 2.2 lr).  bf16 (the two
  frameworks round at other points): loss within 1e-2 relative, grad norm
  within 5e-2, each moment leaf's cosine to the reference's >= 0.98.
* ``lm_forward(train=True)`` with remat against without: values and
  gradients bit-identical.
* Checkpoints written by one package and restored by the other;
  corruption, retention, structure mismatch and ``AsyncCheckpointer``.
* ``Trainer``: a restart resumes identically (the reference's test), and
  10 steps' losses against the reference's ``Trainer`` in fp32 within
  1e-4 relative; the launcher feeds each frontend its synthetic stream.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import reduced as j_reduced
from repro.configs import smollm_135m as J_SMOLLM
from repro.core import config as jc
from repro.data import synthetic as jsyn
from repro.data import tokenizer as jtok
from repro.kernels.conv1d import ref as jconv
from repro.kernels.flash import ref as jflash
from repro.kernels.scan1 import ref as jscan
from repro.kernels.ssd import ref as jssd
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro.train import trainer as jtrainer
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import reduced
from repro_torch.configs import smollm_135m as T_SMOLLM
from repro_torch.convert import from_jax, opt_state_from_jax, to_numpy
from repro_torch.core import config as tc
from repro_torch.data import synthetic as tsyn
from repro_torch.data import tokenizer as ttok
from repro_torch.kernels.conv1d import ops as conv_ops
from repro_torch.kernels.conv1d import ref as tconv
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.flash import ref as tflash
from repro_torch.kernels.grad import needs_grad
from repro_torch.kernels.scan1 import ops as scan_ops
from repro_torch.kernels.scan1 import ref as tscan
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as tssd
from repro_torch.models import lm as tlm
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from repro_torch.train import trainer as ttrainer

GRAD_TOL = 1e-4


def _np(x):
    return np.asarray(x, np.float32)


def _hold(got, want, tol=GRAD_TOL, name=""):
    got, want = to_numpy(got), _np(want)
    assert got.shape == want.shape, name
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (name, err)


# --------------------------------------------------- plain backwards


def _conv_case(rng):
    x = rng.standard_normal((2, 37, 12)).astype(np.float32)
    w = (0.5 * rng.standard_normal((12, 4))).astype(np.float32)
    b = (0.1 * rng.standard_normal(12)).astype(np.float32)
    dy = rng.standard_normal((2, 37, 12)).astype(np.float32)
    _, vjp = jax.vjp(lambda x, w, b: jconv.causal_conv1d_ref(x, w, b)[0],
                     x, w, b)
    return (x, w, b), dy, vjp(dy)


def _ssd_case(rng):
    b, s, h, p, g, n, q = 2, 48, 4, 16, 2, 16, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (0.01 + 0.5 * rng.random((b, s, h))).astype(np.float32)
    A = -(0.5 + 3 * rng.random(h)).astype(np.float32)
    Bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    Cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda *a: jssd.ssd_chunked_ref(*a, chunk=q)[0], x, dt, A, Bm, Cm, D)
    return (x, dt, A, Bm, Cm, D), dy, vjp(dy)


# the flash cases' masks: (causal, window)
FLASH_MODES = {"flash": (True, None), "flash_window": (True, 11),
               "flash_noncausal": (False, None), "flash_d256": (True, None)}


def _flash_case(rng, kind="flash"):
    """GQA 3:1 at d = 16 over 40 positions; the window (11) shorter than
    S; non-causal over 37 positions (not a multiple of 16); d = 256 over
    a short S, causal, GQA 4:1 (gemma3-1b's head)."""
    h, kvh, s, d = {"flash": (6, 2, 40, 16), "flash_window": (6, 2, 40, 16),
                    "flash_noncausal": (4, 2, 37, 16),
                    "flash_d256": (4, 1, 24, 256)}[kind]
    causal, window = FLASH_MODES[kind]
    q = rng.standard_normal((2, h, s, d)).astype(np.float32)
    k = rng.standard_normal((2, kvh, s, d)).astype(np.float32)
    v = rng.standard_normal((2, kvh, s, d)).astype(np.float32)
    do = rng.standard_normal((2, h, s, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jflash.attention_ref(
        q, k, v, causal=causal, window=window), q, k, v)
    return (q, k, v), do, vjp(do)


def _scan1_case(rng):
    """The Mamba-1 scan from a zero state, 2 x 29 steps x 12 channels x
    16 states, against the reference's oracle (``kernels/scan1/ref.py``),
    the gradients of y and of the final state."""
    b, s, c, n = 2, 29, 12, 16
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    dt = (0.01 + 0.5 * rng.random((b, s, c))).astype(np.float32)
    A = -(0.5 + 3 * rng.random((c, n))).astype(np.float32)
    Bm = rng.standard_normal((b, s, n)).astype(np.float32)
    Cm = rng.standard_normal((b, s, n)).astype(np.float32)
    D = rng.standard_normal(c).astype(np.float32)
    dy = rng.standard_normal((b, s, c)).astype(np.float32)
    dfin = rng.standard_normal((b, c, n)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jscan.selective_scan_ref(*a),
                     x, dt, A, Bm, Cm, D)
    return (x, dt, A, Bm, Cm, D), (dy, dfin), vjp((dy, dfin))


def _plain_bwd(kind, ins, dy):
    t = [torch.from_numpy(a) for a in ins]
    d = (tuple(torch.from_numpy(a) for a in dy) if isinstance(dy, tuple)
         else torch.from_numpy(dy))
    if kind == "conv1d":
        return tconv.causal_conv1d_bwd_ref(*t, d)
    if kind == "ssd":
        _, _, states = tssd.ssd_chunked_states_ref(*t, chunk=16)
        dx, ddt, dA, dB, dC, dD = tssd.ssd_chunked_bwd_ref(*t, d, states,
                                                          chunk=16)
        return dx, ddt, dA, dB, dC, dD
    if kind == "scan1":
        return tscan.selective_scan_bwd_ref(*t, *d)
    masks = dict(zip(("causal", "window"), FLASH_MODES[kind]))
    o, lse = tflash.attention_lse_ref(*t, **masks)
    return tflash.flash_bwd_ref(*t, o, d, lse, **masks)


def _wrapper_bwd(kind, ins, dy):
    t = [torch.from_numpy(a).requires_grad_() for a in ins]
    fn = {"conv1d": "Conv1dFn", "ssd": "SsdFn", "scan1": "ScanFn"}.get(
        kind, "FlashFn")
    if kind == "conv1d":
        y, _ = conv_ops.causal_conv1d(*t)
    elif kind == "ssd":
        y, _ = ssd_ops.ssd_chunked(*t, chunk=16)
    elif kind == "scan1":
        y, final = scan_ops.selective_scan(*t)
        assert type(final.grad_fn).__name__.startswith(fn)
        y = (y, final)
    else:
        causal, window = FLASH_MODES[kind]
        y = flash_ops.flash_attention(*t, causal=causal, window=window)
    out = y[0] if isinstance(y, tuple) else y
    assert type(out.grad_fn).__name__.startswith(fn)
    dy = (tuple(torch.from_numpy(a) for a in dy) if isinstance(dy, tuple)
          else torch.from_numpy(dy))
    return torch.autograd.grad(y, t, dy)


CASES = {"conv1d": _conv_case, "ssd": _ssd_case, "scan1": _scan1_case,
         **{k: functools.partial(_flash_case, kind=k) for k in FLASH_MODES}}


@functools.lru_cache(maxsize=None)
def _case(kind):
    """One draw and its ``jax.vjp`` a kind, shared by both routes."""
    return CASES[kind](np.random.default_rng(0))


@pytest.mark.parametrize("via", ["plain", "wrapper"])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_backward_against_jax_vjp(kind, via):
    ins, dy, want = _case(kind)
    got = (_plain_bwd if via == "plain" else _wrapper_bwd)(kind, ins, dy)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _hold(g, w, name=f"{kind} grad {i}")


def _ssd_three_pass(x, dt, A, Bm, Cm, D, dy, states, chunk, hs):
    """The tensor-core backward's split (``csrc/ssd_bwd.cu``) in plain
    float64: (1) each chunk's local U_c = sum_i e^cum_i dy_i^T C_i; (2) the
    state pass, dh'_{nc-1} = 0 and dh'_{c-1} = e^cum_last,c dh'_c + U_c;
    (3) every gradient of a chunk from h_c and dh'_c alone, dB and dC
    summed over slices of ``hs`` heads and then over a group's slices,
    dA and dD over (batch row, chunk) partials."""
    f = torch.float64
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    nc, q = s // chunk, chunk
    xf = x.to(f).reshape(b, nc, q, h, p)
    dyf = dy.to(f).reshape(b, nc, q, h, p)
    Bh = Bm.to(f).repeat_interleave(h // g, 2).reshape(b, nc, q, h, n)
    Ch = Cm.to(f).repeat_interleave(h // g, 2).reshape(b, nc, q, h, n)
    dtf = dt.to(f).reshape(b, nc, q, h)
    Af, Df = A.to(f), D.to(f)
    cum = torch.cumsum(dtf * Af, 2)                       # [b,c,q,h]
    last = cum[:, :, -1:]
    ecum, elast = cum.exp(), last[:, :, 0].exp()          # elast [b,c,h]
    # (1) local
    U = torch.einsum("bcih,bcihp,bcihn->bchpn", ecum, dyf, Ch)
    # (2) the state pass
    dh = torch.zeros_like(U)
    carry = torch.zeros_like(U[:, 0])
    for c in reversed(range(nc)):
        dh[:, c] = carry
        carry = elast[:, c, :, None, None] * carry + U[:, c]
    # (3) the chunk pass
    hc = states.to(f).permute(0, 2, 1, 3, 4)              # [b,c,h,p,n]
    e2 = (last - cum).exp()
    w = dtf * e2
    dBs = w[..., None] * torch.einsum("bcjhp,bchpn->bcjhn", xf, dh)
    dCs = ecum[..., None] * torch.einsum("bcihp,bchpn->bcihn", dyf, hc)
    dcum = (Ch * dCs).sum(-1)
    t1 = torch.einsum("bcjhn,bchpn->bcjhp", Bh, dh)
    dw = (xf * t1).sum(-1)
    dx = Df[:, None] * dyf + w[..., None] * t1
    lmat = (cum[:, :, :, None] - cum[:, :, None]).exp()   # [b,c,i,j,h]
    lmat = lmat * torch.ones(q, q, dtype=f).tril()[:, :, None]
    gm = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    dm = torch.einsum("bcihp,bcjhp->bcijh", dyf, xf)
    m = gm * lmat * dtf[:, :, None]
    dg = dm * lmat * dtf[:, :, None]
    ecol = (gm * lmat * dm).sum(2)                         # over i: [b,c,j,h]
    dcum = dcum + (m * dm).sum(3) - dtf * ecol - w * dw
    ddt = e2 * dw + ecol
    dcum[:, :, -1] += elast * (dh * hc).sum((-1, -2)) + (w * dw).sum(2)
    da = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    ddt = ddt + Af * da
    dx = dx + torch.einsum("bcijh,bcihp->bcjhp", m, dyf)
    dBs = dBs + torch.einsum("bcijh,bcihn->bcjhn", dg, Ch)
    dCs = dCs + torch.einsum("bcijh,bcjhn->bcihn", dg, Bh)

    def by_group(t):
        part = t.reshape(b, nc, q, h // hs, hs, n).sum(4)
        return part.reshape(b, nc, q, g, h // g // hs, n).sum(4).reshape(
            b, s, g, n)
    return (dx.reshape(b, s, h, p), ddt.reshape(b, s, h),
            (dtf * da).sum(2).sum((0, 1)), by_group(dBs), by_group(dCs),
            (dyf * xf).sum((2, 4)).sum((0, 1)))


def test_ssd_backward_three_passes():
    """The split of the tensor-core SSD backward (local U, the state pass,
    the chunk pass with per-slice partials) in float64 against the plain
    backward, at 4 chunks and two slices of 8 heads in each of 2 groups:
    every gradient within 1e-4 of its max |g|."""
    rng = np.random.default_rng(3)
    b, s, h, p, g, n, q = 2, 64, 32, 8, 2, 8, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (0.01 + 0.5 * rng.random((b, s, h))).astype(np.float32)
    A = -(0.5 + 3 * rng.random(h)).astype(np.float32)
    Bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    Cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, D)]
    d = torch.from_numpy(dy)
    _, _, states = tssd.ssd_chunked_states_ref(*t, chunk=q)
    hs = ssd_ops.slice_heads(h, g)
    assert hs == 8
    got = _ssd_three_pass(*t, d, states, q, hs)
    want = tssd.ssd_chunked_bwd_ref(*t, d, states, chunk=q)
    for i, (a, w) in enumerate(zip(got, want)):
        _hold(a, w, name=f"ssd three-pass grad {i}")


def _lane_scan_up(pa, pb):
    """Five-level inclusive scan of the maps h -> pa h + pb over the last
    dim (32 lanes), lower lanes first, as the kernel's __shfl_up_sync."""
    lane = torch.arange(32)
    for off in (1, 2, 4, 8, 16):
        qa = torch.roll(pa, off, -1)
        qb = torch.roll(pb, off, -1)
        on = lane >= off
        pb = torch.where(on, pa * qb + pb, pb)
        pa = torch.where(on, pa * qa, pa)
    return pa, pb


def _lane_scan_down(P, Q):
    """Five-level inclusive suffix scan of the maps c -> P c + Q over the
    last dim: lane l ends with lanes l..31 composed, l's map outermost
    (__shfl_down_sync)."""
    lane = torch.arange(32)
    for off in (1, 2, 4, 8, 16):
        qp = torch.roll(P, -off, -1)
        qq = torch.roll(Q, -off, -1)
        on = lane + off < 32
        Q = torch.where(on, P * qq + Q, Q)
        P = torch.where(on, P * qp, P)
    return P, Q


def _scan1_bwd_tiles(x, dt, A, Bm, Cm, D, dy, dfin, k):
    """``csrc/scan1_bwd.cu``'s decomposition in plain fp32: tiles of 32 k
    steps, lane l owning steps l k .. l k + k - 1.  Pass 1 keeps h where
    each lane's run starts (each lane's folded map, the lanes' scan from
    the carried state).  Pass 2 walks the tiles in reverse: the
    gradient's map c -> a (C dy + c) folded backwards over each run (its
    product that of the run's a), the suffix scan over lanes from the
    carry out of the tile above (seeded from ``dfin``) give the carry
    into each lane's last step; one backward walk gives g, one forward
    walk from pass 1's start h and the contributions."""
    b, s, c = x.shape
    n = A.shape[-1]
    T = 32 * k
    tiles = -(-s // T)
    pad = tiles * T - s

    def tiled(t):   # [b, S, ...] -> [tiles, b, 32 lanes, k, ...]
        t = torch.nn.functional.pad(t, (0,) * (2 * (t.dim() - 2)) + (0, pad))
        return t.reshape(b, tiles, 32, k, *t.shape[2:]).transpose(0, 1)
    xt, dtt, dyt = tiled(x), tiled(dt), tiled(dy)
    Bt, Ct = tiled(Bm), tiled(Cm)
    # [tiles, b, lane, k, c, n]
    a = torch.exp(dtt[..., None] * A)
    u = (dtt * xt)[..., None] * Bt[..., None, :]
    cdy = dyt[..., None] * Ct[..., None, :]

    def fold(i):
        pa, pb = a[i][:, :, 0], u[i][:, :, 0]
        for j in range(1, k):
            pb = a[i][:, :, j] * pb + u[i][:, :, j]
            pa = pa * a[i][:, :, j]
        return pa, pb                                  # [b, lane, c, n]

    def lanes_last(t):
        return t.permute(0, 2, 3, 1)                   # [b, c, n, lane]

    # pass 1: h where each lane's run starts, every tile
    starts, carry = [], torch.zeros(b, c, n)
    for i in range(tiles):
        pa, pb = (lanes_last(t) for t in fold(i))
        pa, pb = _lane_scan_up(pa, pb)
        hend = pa * carry[..., None] + pb
        starts.append(torch.cat([carry[..., None], hend[..., :31]], -1))
        carry = hend[..., 31]
    # pass 2
    dx = torch.zeros(tiles, b, 32, k, c)
    ddt = torch.zeros_like(dx)
    dB = torch.zeros(tiles, b, 32, k, n)
    dC = torch.zeros_like(dB)
    dA = torch.zeros(c, n)
    gc = torch.zeros(b, c, n) if dfin is None else dfin.clone()
    for i in reversed(range(tiles)):
        ai, qi = a[i], cdy[i]
        own = lanes_last(torch.prod(ai, 2))
        Q = ai[:, :, k - 1] * qi[:, :, k - 1]
        for j in range(k - 2, -1, -1):
            Q = ai[:, :, j] * (qi[:, :, j] + Q)
        P, Q = _lane_scan_down(own, lanes_last(Q))
        cend = P * gc[..., None] + Q
        cin = torch.cat([cend[..., 1:], gc[..., None]], -1)
        gc = cend[..., 0]
        g = [None] * k
        cc = cin.permute(0, 3, 1, 2)                   # [b, lane, c, n]
        for j in range(k - 1, -1, -1):
            g[j] = qi[:, :, j] + cc
            cc = ai[:, :, j] * g[j]
        h = starts[i].permute(0, 3, 1, 2)
        for j in range(k):
            ah = ai[:, :, j] * h
            h = ah + u[i][:, :, j]
            w = ah * g[j]
            dtj, xj, dyj = dtt[i][:, :, j], xt[i][:, :, j], dyt[i][:, :, j]
            usum = (Bt[i][:, :, j, None, :] * g[j]).sum(-1)
            dx[i][:, :, j] = dtj * usum + D * dyj
            ddt[i][:, :, j] = xj * usum + (A * w).sum(-1)
            dA += (dtj[..., None] * w).sum((0, 1))
            dB[i][:, :, j] = ((dtj * xj)[..., None] * g[j]).sum(2)
            dC[i][:, :, j] = (h * dyj[..., None]).sum(2)

    def untile(t):
        return t.transpose(0, 1).reshape(b, tiles * T, *t.shape[4:])[:, :s]
    return (untile(dx), untile(ddt), dA, untile(dB), untile(dC),
            (x * dy).sum((0, 1)))


@pytest.mark.parametrize("n", [8, 16])
def test_scan1_backward_tile_decomposition(n):
    """The selective-scan backward kernel's algebra (tiles of 32 K steps
    with the kernel's K, the lanes' folded maps, the forward and suffix
    scans over lanes, the state and gradient carries between tiles) in
    plain fp32 against ``jax.vjp`` of the reference's
    ``selective_scan_ref``: 3 tiles, the last ragged, channels off the
    kernel's block, the final state's gradient; each gradient within
    1e-5 of its max |g|."""
    rng = np.random.default_rng(5)
    b, s, c = 2, 2 * scan_ops.BWD_TILE + 37, 5
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    dt = (0.001 + 0.05 * rng.random((b, s, c))).astype(np.float32)
    A = -(1.0 + 15 * rng.random((c, n))).astype(np.float32)
    Bm = rng.standard_normal((b, s, n)).astype(np.float32)
    Cm = rng.standard_normal((b, s, n)).astype(np.float32)
    D = rng.standard_normal(c).astype(np.float32)
    dy = rng.standard_normal((b, s, c)).astype(np.float32)
    dfin = rng.standard_normal((b, c, n)).astype(np.float32)
    ins = (x, dt, A, Bm, Cm, D)
    _, vjp = jax.vjp(lambda *a: jscan.selective_scan_ref(*a), *ins)
    want = vjp((dy, dfin))
    t = [torch.from_numpy(v) for v in ins + (dy, dfin)]
    got = _scan1_bwd_tiles(*t, k=scan_ops.BWD_STEPS)
    for i, (g, w) in enumerate(zip(got, want)):
        _hold(g, w, tol=1e-5, name=f"scan1 tiles n={n} grad {i}")


@pytest.mark.parametrize("arch", ["gemma3-1b", "hubert-xlarge",
                                  "mamba-130m"])
def test_new_backward_plans(arch):
    """The launch plans of the backwards this slice trains through, at
    B=4, S=2048 and S=1500 (off a tile) in bf16: gemma3-1b's head_dim 256
    on wgmma in 64-key and 64-row blocks (within a block's 227 KB of
    shared memory; its fp32 on CUDA cores in 32-row tiles),
    hubert-xlarge's non-causal d = 80 on wgmma, and mamba-130m's
    selective-scan backward: 256-step tiles, 16 channels a block in bf16
    (8 in fp32; one dB / dC partial a block), within a block's shared
    memory, its scratch as the kernels lay it out (h where each lane's
    run starts, dA and dD a batch row, dB and dC a channel block)."""
    from repro_torch.core.registry import get
    cfg = get(arch)
    for s in (2048, 1500):
        if cfg.attn is not None:
            a = cfg.attn
            plan = flash_ops.flash_bwd_plan(4, a.n_heads, a.n_kv_heads, s,
                                            a.head_dim, torch.bfloat16)
            assert plan.route == "wgmma"
            rows = 64 if a.head_dim == 256 else 128
            assert plan.blocks[1:] == (-(-s // rows) * a.n_kv_heads * 4,
                                       -(-s // rows) * a.n_heads * 4)
            assert plan.scratch == (4, a.n_heads, -(-s // 128) * 128, 2)
            assert max(plan.smem_bytes) <= 227 * 1024
            if a.head_dim == 256:
                plan = flash_ops.flash_bwd_plan(4, a.n_heads, a.n_kv_heads,
                                                s, 256, torch.float32)
                tiles = -(-s // 32)
                assert plan.route == "cuda_cores"
                assert plan.blocks[1:] == (tiles * a.n_kv_heads * 4,
                                           tiles * a.n_heads * 4)
                assert max(plan.smem_bytes) <= 227 * 1024
        if cfg.ssm is not None:
            c, n = cfg.ssm.d_inner(cfg.d_model), cfg.ssm.d_state
            plan = scan_ops.scan1_bwd_plan(4, s, c, n, torch.bfloat16)
            tiles, nblk = -(-s // 256), -(-c // 16)
            assert (plan.tile, plan.channels) == (256, 16)
            assert (plan.ldc, plan.tiles, plan.partials) == (c, tiles, nblk)
            assert plan.blocks == 4 * nblk
            # dB and dC summed over each block's 16 channels on chip: a
            # partial a (batch row, step) is C / 16 floats
            assert plan.partials == c // 16
            assert plan.scratch == 4 * (tiles * c * n * 32 + c * n + c
                                        + 2 * nblk * n * s)
            # one block of 16 warps an SM in bf16; fp32 8 warps
            assert max(plan.smem_bytes) <= 227 * 1024
            plan32 = scan_ops.scan1_bwd_plan(4, s, c, n, torch.float32)
            assert (plan32.channels, plan32.partials) == (8, c // 8)
            assert max(plan32.smem_bytes) <= 227 * 1024


def test_grad_check_decides_the_route():
    x = torch.zeros(2, 3)
    xg = torch.zeros(2, 3, requires_grad=True)
    assert not needs_grad(x, None)
    assert needs_grad(x, None, xg)
    with torch.no_grad():
        assert not needs_grad(xg)
    with torch.inference_mode():
        assert not needs_grad(xg)
    # without a gradient the wrappers run their plain versions as before
    # (no autograd Function)
    w, b = torch.zeros(3, 4), torch.zeros(3)
    with torch.no_grad():
        y, _ = conv_ops.causal_conv1d(xg[None], w.requires_grad_(), b)
    assert y.grad_fn is None


# --------------------------------------------------- optimizer, data


def _random_tree(rng, scale=1.0):
    """Keys in sorted order, as JAX flattens a dict."""
    return {"b": (scale * rng.standard_normal(5)).astype(np.float32),
            "seg": [((scale * rng.standard_normal((2, 4, 3)))
                     .astype(np.float32),
                     (scale * rng.standard_normal(7)).astype(np.float32))],
            "w": (scale * rng.standard_normal((6, 5))).astype(np.float32)}


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])
def test_adamw_against_reference(grad_scale):
    """Three steps of AdamW from warmup (clipping live at grad_scale 10)."""
    rng = np.random.default_rng(1)
    params = _random_tree(rng)
    kw = dict(lr=1e-2, warmup_steps=4)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init_opt_state(jp, jopt.OptConfig(**kw))
    tp = from_jax(params, "cpu")
    ts = topt.init_opt_state(tp, topt.OptConfig(**kw))
    for _ in range(3):
        g = _random_tree(rng, grad_scale)
        np.testing.assert_allclose(
            float(topt.global_norm(from_jax(g, "cpu"))),
            float(jopt.global_norm(jax.tree_util.tree_map(jnp.asarray, g))),
            rtol=1e-6)
        jp, js, jm = jopt.adamw_update(
            jp, jax.tree_util.tree_map(jnp.asarray, g), js,
            jopt.OptConfig(**kw))
        tp, ts, tm = topt.adamw_update(tp, from_jax(g, "cpu"), ts,
                                       topt.OptConfig(**kw))
        assert float(tm["lr"]) == float(jm["lr"])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for got, want in zip(tree_leaves(tp) + tree_leaves(ts["m"])
                             + tree_leaves(ts["v"]),
                             jax.tree_util.tree_leaves(jp)
                             + jax.tree_util.tree_leaves(js["m"])
                             + jax.tree_util.tree_leaves(js["v"])):
            np.testing.assert_allclose(to_numpy(got), _np(want), rtol=1e-5,
                                       atol=1e-7)
        assert int(ts["step"]) == int(js["step"])


def test_schedule_and_clip_against_reference():
    for step in (0, 1, 5, 99, 100, 250):
        for warm in (0, 1, 100):
            cfg = dict(lr=3e-4, warmup_steps=warm)
            assert float(topt._schedule(topt.OptConfig(**cfg),
                                        torch.tensor(step, dtype=torch.int32))
                         ) == float(jopt._schedule(jopt.OptConfig(**cfg),
                                                   jnp.int32(step)))


def test_data_and_tokenizer_bit_for_bit():
    for seq, nl in ((64, 8), (16, 8), (2048, 8)):
        c = dict(vocab_size=1000, seq_len=seq, global_batch=3, seed=5,
                 needle_len=nl)
        jd = jsyn.SyntheticLM(jsyn.DataConfig(**c))
        td = tsyn.SyntheticLM(tsyn.DataConfig(**c))
        for step in (0, 1, 17):
            a, b = jd.batch(step), td.batch(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        pred = np.random.default_rng(0).integers(0, 1000, (3, seq))
        assert tsyn.needle_accuracy(pred, b, td.cfg) == \
            jsyn.needle_accuracy(pred, b, jd.cfg)
    ja = jsyn.SyntheticAudio(jsyn.DataConfig(50, 12, 2, 3), feat_dim=8)
    ta = tsyn.SyntheticAudio(tsyn.DataConfig(50, 12, 2, 3), feat_dim=8)
    for k, v in ja.batch(4).items():
        np.testing.assert_array_equal(v, ta.batch(4)[k])
    for text in ("hello", "héllo wörld", ""):
        np.testing.assert_array_equal(ttok.encode(text, eos=True),
                                      jtok.encode(text, eos=True))
        assert ttok.decode(ttok.encode(text)) == jtok.decode(
            jtok.encode(text))
    np.testing.assert_array_equal(ttok.batch_encode(["ab", "abcdef"],
                                                    pad_to=4),
                                  jtok.batch_encode(["ab", "abcdef"],
                                                    pad_to=4))


# --------------------------------------------------- the train step


def _tiny_hybrid(pkg, **kw):
    """The reference's ``tests/test_system.py::_tiny_hybrid``."""
    return pkg.ModelConfig(
        name="sys-hybrid", family="hybrid", n_layers=4, d_model=64, d_ff=0,
        vocab_size=64, ssm=pkg.SSMConfig(d_state=16, headdim=16, chunk=16),
        shared_attn=pkg.AttnConfig(n_heads=4, n_kv_heads=4, head_dim=16),
        shared_attn_d_ff=128, layer_pattern=("mamba2", "mamba2+shared"),
        vocab_pad_multiple=16, **kw)


# the reduced registered configs the train step is held on, by name, as
# (reference config, port config, reduce keywords, replaced fields):
# smollm-135m; gemma3-1b at one unit (5 local layers, window 8 < S, and a
# global one); hubert-xlarge (encoder, frame features); qwen3-moe by both
# dispatch paths; llama4 at one unit (top-1 dense_moe and moe with the
# shared expert); mamba-130m (mamba1); llava-next (patch features before
# the tokens)
REDUCED = {
    "smollm": ("smollm_135m", "smollm_135m", {}, {}),
    "gemma3": ("gemma3_1b", "gemma3_1b", {"n_units": 1}, {}),
    "hubert": ("hubert_xlarge", "hubert_xlarge", {}, {}),
    "moe_gshard": ("qwen3_moe_235b", "qwen3_moe_235b", {}, {}),
    "moe_ragged": ("qwen3_moe_235b", "qwen3_moe_235b", {},
                   {"impl": "ragged"}),
    "llama4": ("llama4_maverick", "llama4_maverick", {"n_units": 1}, {}),
    "mamba1": ("paper_models.MAMBA1_130M", "mamba_130m", {}, {}),
    "llava": ("llava_next", "llava_next", {}, {}),
}


def _reduced_pair(model, compute_dtype):
    import repro.configs as jconfigs
    import repro_torch.configs as tconfigs
    jname, tname, kw, moe_kw = REDUCED[model]
    jcfg = functools.reduce(getattr, jname.split("."), jconfigs)
    out = []
    for red, cfg in ((j_reduced, jcfg), (reduced, getattr(tconfigs, tname))):
        c = red(cfg, **kw)
        if moe_kw:
            c = dataclasses.replace(c, moe=dataclasses.replace(c.moe,
                                                               **moe_kw))
        out.append(dataclasses.replace(c, compute_dtype=compute_dtype))
    return tuple(out)


def _cfg_pair(model, compute_dtype):
    if model == "hybrid":
        return (_tiny_hybrid(jc, compute_dtype=compute_dtype),
                _tiny_hybrid(tc, compute_dtype=compute_dtype))
    return _reduced_pair(model, compute_dtype)


def _train_batch(cfg, rng):
    """4 rows of 32 positions: tokens; an audio model's frame features
    (labels a frame); a vision model's 8 patch features before 24 tokens,
    with labels over all 32 positions, as the reference's loss takes
    them."""
    b, s = 4, 32
    if cfg.frontend == "audio":
        return {"features": rng.standard_normal(
                    (b, s, cfg.frontend_feature_dim)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size,
                                       (b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        return {"tokens": rng.integers(0, cfg.vocab_size,
                                       (b, s - 8)).astype(np.int32),
                "features": rng.standard_normal(
                    (b, 8, cfg.frontend_feature_dim)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size,
                                       (b, s)).astype(np.int32)}
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": toks, "labels": toks}


def _cosine(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    den = np.linalg.norm(a) * np.linalg.norm(b)
    return 1.0 if den == 0 else float(a @ b / den)


@pytest.mark.parametrize("model,compute_dtype,mb", [
    ("hybrid", "float32", 1), ("hybrid", "bfloat16", 2),
    ("smollm", "float32", 2), ("smollm", "bfloat16", 1),
    ("gemma3", "float32", 1), ("gemma3", "bfloat16", 1),
    ("hubert", "float32", 1), ("hubert", "bfloat16", 2),
    ("moe_gshard", "float32", 1), ("moe_gshard", "bfloat16", 1),
    ("moe_ragged", "float32", 2), ("moe_ragged", "bfloat16", 1),
    ("llama4", "float32", 1), ("llama4", "bfloat16", 1),
    ("mamba1", "float32", 1), ("mamba1", "bfloat16", 1),
    ("llava", "float32", 1), ("llava", "bfloat16", 1)])
def test_train_step_against_reference(model, compute_dtype, mb):
    jcfg, tcfg = _cfg_pair(model, compute_dtype)
    # fp32 compute also accumulates the gradients in fp32: a bf16
    # accumulation rounds each to 2^-8 of itself, where two sides whose
    # fp32 sums differ in the last bits may round apart
    kw = dict(lr=1e-3, warmup_steps=3, grad_dtype=compute_dtype)
    jp = jlm.init_lm_params(jcfg, jax.random.PRNGKey(0))
    js = jopt.init_opt_state(jp, jopt.OptConfig(**kw))
    tp = from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    ts = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    batch = _train_batch(jcfg, np.random.default_rng(0))
    jstep = jax.jit(jts.make_train_step(jcfg, jopt.OptConfig(**kw),
                                        microbatches=mb))
    jp2, js2, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    tstep = tts.make_train_step(tcfg, topt.OptConfig(**kw), microbatches=mb)
    tp2, ts2, tm = tstep(tp, ts, {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
    assert float(tm["lr"]) == float(jm["lr"])
    m_got = [to_numpy(m) for m in tree_leaves(ts2["m"])]
    m_want = [_np(m) for m in jax.tree_util.tree_leaves(js2["m"])]
    assert len(m_got) == len(m_want)
    if compute_dtype == "float32":
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        lr = float(jm["lr"])
        for g, w, p_got, p_want in zip(
                m_got, m_want, tree_leaves(tp2),
                jax.tree_util.tree_leaves(jp2)):
            top = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= 1e-4 * top
            dp = np.abs(to_numpy(p_got) - _np(p_want))
            live = np.abs(w) > 1e-3 * top
            assert float(dp.max()) <= 2.2 * lr
            assert float(dp[live].max(initial=0.0)) <= 1e-5
    else:
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-2)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=5e-2)
        for g, w in zip(m_got, m_want):
            assert _cosine(g, w) >= 0.98
    assert int(ts2["step"]) == int(js2["step"]) == 1


def test_remat_is_bit_identical():
    cfg = _tiny_hybrid(tc, compute_dtype="float32")
    params = tlm.init_lm_params(cfg, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 64, (2, 32)))
    outs = []
    for remat, train in (("block", True), ("none", True), ("block", False)):
        c = dataclasses.replace(cfg, remat=remat)
        live = [t.detach().requires_grad_() for t in tree_leaves(params)]
        logits = tlm.lm_forward(c, tree_unflatten(params, live), toks,
                                train=train)
        grads = torch.autograd.grad(logits.square().mean(), live)
        outs.append((logits.detach(), grads))
    for logits, grads in outs[1:]:
        assert torch.equal(logits, outs[0][0])
        for a, b in zip(grads, outs[0][1]):
            assert torch.equal(a, b)


# --------------------------------------------------- checkpoints


def _train_trees(jcfg):
    jp = jlm.init_lm_params(jcfg, jax.random.PRNGKey(2))
    js = jopt.init_opt_state(jp, jopt.OptConfig())
    js = dict(js, step=jnp.int32(7))
    jtree = {"params": jp, "opt": js}
    ttree = {"params": from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu"),
             "opt": opt_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              js), "cpu")}
    return jtree, ttree


def _same_tree(got_port, want_jax):
    """Leaf by leaf, matched by path: same dtype, same bits."""
    g = dict(tckpt._paths(got_port))
    w = dict(tckpt._paths(jax.tree_util.tree_map(np.asarray, want_jax)))
    assert g.keys() == w.keys()
    for key, a in g.items():
        b = w[key]
        assert a.dtype == {np.dtype(np.float32): torch.float32,
                           np.dtype(np.int32): torch.int32}[b.dtype], key
        np.testing.assert_array_equal(to_numpy(a), b)


def test_checkpoints_cross_packages(tmp_path):
    jtree, ttree = _train_trees(_tiny_hybrid(jc))
    jckpt.save(str(tmp_path / "j"), 3, jtree)
    _same_tree(tckpt.restore(str(tmp_path / "j"), ttree), jtree)
    tckpt.save(str(tmp_path / "t"), 4, ttree)
    with open(tmp_path / "t" / "step_00000004" / "manifest.json") as f:
        got = f.read()
    with open(tmp_path / "j" / "step_00000003" / "manifest.json") as f:
        want = f.read()
    assert got.replace('"step": 4', '"step": 3') == want
    back = jckpt.restore(str(tmp_path / "t"), jtree)
    _same_tree(ttree, back)
    # a bf16 leaf goes through float32 and comes back as it was
    t16 = {"a": torch.randn(3, 5).to(torch.bfloat16)}
    tckpt.save(str(tmp_path / "b"), 1, t16)
    assert torch.equal(tckpt.restore(str(tmp_path / "b"), t16)["a"],
                       t16["a"])


def test_checkpoint_bf16_leaves_from_the_reference(tmp_path):
    """The reference saves bf16 leaves as bf16 (numpy reads them back as
    2-byte void): the port restores them bit for bit beside fp32 and
    int32 leaves, a corrupted bf16 leaf fails its crc, and a void leaf of
    another kind raises."""
    rng = np.random.default_rng(5)
    a16 = rng.standard_normal((3, 7)).astype(np.float32)
    a32 = rng.standard_normal((4,)).astype(np.float32)
    i32 = rng.integers(-9, 9, (2, 3)).astype(np.int32)
    jtree = {"w16": jnp.asarray(a16, dtype=jnp.bfloat16),
             "n": {"w32": jnp.asarray(a32), "i": jnp.asarray(i32)}}
    d = jckpt.save(str(tmp_path / "j"), 2, jtree)
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f)["dtypes"]["w16"] == "bfloat16"
    target = {"w16": torch.zeros((3, 7), dtype=torch.bfloat16),
              "n": {"w32": torch.zeros(4),
                    "i": torch.zeros((2, 3), dtype=torch.int32)}}
    got = tckpt.restore(str(tmp_path / "j"), target)
    want16 = np.asarray(jtree["w16"]).view(np.int16)
    assert got["w16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w16"].view(torch.int16).numpy(),
                                  want16)
    assert got["n"]["w32"].dtype == torch.float32
    np.testing.assert_array_equal(got["n"]["w32"].numpy(), a32)
    assert got["n"]["i"].dtype == torch.int32
    np.testing.assert_array_equal(got["n"]["i"].numpy(), i32)
    # a bf16 leaf restored into an fp32 target widens exactly
    wide = tckpt.restore(str(tmp_path / "j"),
                         dict(target, w16=torch.zeros((3, 7))))
    assert torch.equal(wide["w16"], got["w16"].float())
    # one flipped bit of the bf16 leaf fails its crc
    npz = os.path.join(d, "arrays.npz")
    data = dict(np.load(npz))
    assert data["w16"].dtype.kind == "V" and data["w16"].itemsize == 2
    bits = data["w16"].view(np.uint16).copy()
    bits[1, 2] ^= 1
    data["w16"] = bits.view(data["w16"].dtype)
    np.savez(npz, **data)
    with pytest.raises(IOError, match="corruption detected in leaf w16"):
        tckpt.restore(str(tmp_path / "j"), target)
    # a void leaf that is not a bf16 one
    data["w16"] = np.zeros((3, 7), dtype="V4")
    np.savez(npz, **data)
    with pytest.raises(ValueError, match="leaf w16.*bfloat16"):
        tckpt.restore(str(tmp_path / "j"), target, verify=False)


def test_checkpoint_corruption_retention_mismatch_async(tmp_path):
    tree = {"a": torch.randn(4, 8),
            "b": {"c": torch.arange(10, dtype=torch.int32),
                  "d": torch.tensor(3.5)}}
    d = tckpt.save(str(tmp_path / "c"), 1, tree)
    npz = os.path.join(d, "arrays.npz")
    data = dict(np.load(npz))
    data["a"] = data["a"] + 1.0
    np.savez(npz, **data)
    with pytest.raises(IOError, match="corruption"):
        tckpt.restore(str(tmp_path / "c"), tree)
    for s in range(6):
        tckpt.save(str(tmp_path / "r"), s, tree, keep=2)
    assert sorted(x for x in os.listdir(tmp_path / "r")) == [
        "step_00000004", "step_00000005"]
    with pytest.raises(ValueError, match="mismatch"):
        tckpt.restore(str(tmp_path / "r"), {"a": tree["a"],
                                            "zz": torch.zeros(3)})
    ck = tckpt.AsyncCheckpointer(str(tmp_path / "a"), keep=2)
    for s in (1, 2, 3):
        ck.save(s, tree)
    ck.wait()
    assert tckpt.latest_step(str(tmp_path / "a")) == 3
    out = tckpt.restore(str(tmp_path / "a"), tree, step=3)
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert sorted(os.listdir(tmp_path / "a")) == ["step_00000002",
                                                  "step_00000003"]


def test_async_checkpoint_is_a_snapshot(tmp_path):
    """The tree is changed in place, as ``adamw_update`` does, before the
    background write ends: the checkpoint holds the tree at save time."""
    torch.manual_seed(0)
    tree = {"p": torch.randn(256, 256), "m": [torch.randn(64)],
            "h": torch.randn(8, 8).to(torch.bfloat16),
            "n": np.arange(5, dtype=np.int32)}
    want = {"p": tree["p"].clone(), "m": [tree["m"][0].clone()],
            "h": tree["h"].clone(), "n": tree["n"].copy()}
    ck = tckpt.AsyncCheckpointer(str(tmp_path / "s"), keep=1)
    ck.save(1, tree)
    tree["p"].add_(1.0)
    tree["m"][0].mul_(-2.0)
    tree["h"].add_(1.0)
    tree["n"] += 7
    ck.wait()
    out = tckpt.restore(str(tmp_path / "s"), want)
    assert torch.equal(out["p"], want["p"])
    assert torch.equal(out["m"][0], want["m"][0])
    assert torch.equal(out["h"], want["h"])
    np.testing.assert_array_equal(to_numpy(out["n"]), want["n"])


# --------------------------------------------------- the trainer


def test_trainer_restart_resumes_identically(tmp_path):
    """The reference's ``test_restart_resumes_identically`` on the port:
    10 steps with a checkpoint at 5; a fresh trainer restored at 5
    reproduces steps 6-10."""
    cfg = _tiny_hybrid(tc)
    kw = dict(seq_len=32, global_batch=4, device="cpu")
    t1 = ttrainer.Trainer(cfg, topt.OptConfig(lr=1e-3),
                          ttrainer.TrainerConfig(steps=10, ckpt_every=5,
                                                 log_every=100,
                                                 ckpt_dir=str(tmp_path)),
                          **kw)
    s1 = t1.run(log=lambda *_: None)
    t2 = ttrainer.Trainer(cfg, topt.OptConfig(lr=1e-3),
                          ttrainer.TrainerConfig(steps=10, ckpt_every=100,
                                                 log_every=100,
                                                 ckpt_dir=str(tmp_path)),
                          **kw)
    assert t2.maybe_restore() and t2.state.step == 10
    r = tckpt.restore(str(tmp_path), {"params": t2.params,
                                      "opt": t2.opt_state}, step=5)
    t2.params, t2.opt_state = r["params"], r["opt"]
    t2.state.step = 5
    s2 = t2.run(log=lambda *_: None)
    np.testing.assert_allclose(s1.losses[5:], s2.losses, rtol=1e-5)
    assert all(np.isfinite(s1.losses))


def test_trainer_against_reference():
    """10 steps in fp32 from the same params and data: the losses agree
    within 1e-4 relative."""
    jcfg = _tiny_hybrid(jc, compute_dtype="float32")
    tcfg = _tiny_hybrid(tc, compute_dtype="float32")
    kw = dict(seq_len=32, global_batch=4)
    tcf = dict(steps=10, ckpt_every=0, log_every=100)
    jt = jtrainer.Trainer(jcfg, jopt.OptConfig(lr=1e-3),
                          jtrainer.TrainerConfig(**tcf), **kw)
    tt = ttrainer.Trainer(tcfg, topt.OptConfig(lr=1e-3),
                          ttrainer.TrainerConfig(**tcf), device="cpu", **kw)
    tt.params = from_jax(jax.tree_util.tree_map(np.asarray, jt.params),
                         "cpu")
    tt.opt_state = topt.init_opt_state(tt.params, topt.OptConfig(lr=1e-3))
    js = jt.run(log=lambda *_: None)
    ts = tt.run(log=lambda *_: None)
    np.testing.assert_allclose(ts.losses, js.losses, rtol=1e-4)


def test_training_entry_points_need_cuda_by_default(monkeypatch):
    """``Trainer`` and the launcher default to the card and raise without
    one; ``device="cpu"`` (``--device cpu``) runs the plain path."""
    from repro_torch.launch import train as launch_train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_hybrid(tc)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrainer.Trainer(cfg, topt.OptConfig(), ttrainer.TrainerConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", "smollm-135m", "--steps", "1"])
    launch_train.main(["--arch", "smollm-135m", "--steps", "2", "--seq",
                       "32", "--batch", "2", "--device", "cpu"])


def test_launcher_feeds_each_frontend(capsys):
    """``launch.train`` trains an audio model on frame features and a
    vision model on patch features before its tokens (labels over the
    whole sequence, 0 at the patches); a token model's stream is the
    needle stream as before."""
    from repro_torch.core.registry import get
    from repro_torch.launch import train as launch_train
    hub, lla = reduced(get("hubert-xlarge")), reduced(
        get("llava-next-mistral-7b"))
    a = tsyn.synthetic_for(hub, 32, 2).batch(3)
    assert a["features"].shape == (2, 32, hub.frontend_feature_dim)
    assert a["labels"].shape == (2, 32)
    v = tsyn.synthetic_for(lla, 32, 2).batch(3)
    assert v["features"].shape == (2, 16, lla.frontend_feature_dim)
    assert v["tokens"].shape == (2, 16) and v["labels"].shape == (2, 32)
    assert (v["labels"][:, :16] == 0).all()
    np.testing.assert_array_equal(v["labels"][:, 16:], v["tokens"])
    sm = reduced(T_SMOLLM)
    t = tsyn.synthetic_for(sm, 32, 2, seed=4).batch(5)
    want = tsyn.SyntheticLM(tsyn.DataConfig(sm.vocab_size, 32, 2,
                                            seed=4)).batch(5)
    for k in want:
        np.testing.assert_array_equal(t[k], want[k])
    for arch in ("hubert-xlarge", "llava-next-mistral-7b"):
        launch_train.main(["--arch", arch, "--steps", "2", "--seq", "32",
                           "--batch", "2", "--device", "cpu"])
        out = capsys.readouterr().out
        assert "done: 2 steps" in out and "nan" not in out
