"""Plain PyTorch Mamba-1 selective scan (S6), the reference oracle's math.

Shapes: x, dt: [B, S, C] (C = d_inner, dt post-softplus); A: [C, N];
Bm, Cm: [B, S, N]; D: [C]; h: [B, C, N].  A sequential loop over S in
fp32, step for step as the reference's ``selective_scan_ref``:
``h = h * exp(dt*A) + (dt*x) * B``, ``y = C . h``, and ``D * x`` added
after the loop.  Used by the CPU path of :mod:`.ops`, by the tests, and as
the kernel's comparison on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd.ref import into, softplus


def selective_scan_ref(x, dt, A, Bm, Cm, D,
                       initial_state: Optional[torch.Tensor] = None, *,
                       out_state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B,S,C] in x's dtype, final h [B,C,N] fp32); ``out_state``,
    when given, receives a copy of the final state and is returned in its
    place, as the kernel writes its destination."""
    b, s, c = x.shape
    n = A.shape[-1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = Bm.float(), Cm.float()
    h = (torch.zeros((b, c, n), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    ys = torch.empty((b, s, c), dtype=torch.float32, device=x.device)
    for t in range(s):
        da = torch.exp(dtf[:, t, :, None] * Af[None])            # [b,c,n]
        h = h * da + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        ys[:, t] = torch.einsum("bcn,bn->bc", h, Cf[:, t])
    y = ys + xf * D.float()[None, None]
    return y.to(x.dtype), into(out_state, h)


def selective_scan_bwd_ref(x, dt, A, Bm, Cm, D, dy,
                           dfinal: Optional[torch.Tensor] = None):
    """Backward of :func:`selective_scan_ref` from a zero initial state, as
    ``csrc/scan1_bwd.cu`` computes it, in fp32: with a_t = exp(dt_t A) and
    g_t the gradient of h_t (g_t = C_t dy_t + a_{t+1} g_{t+1}, plus
    ``dfinal`` [B,C,N] at the last step), walking time in reverse:
    dx_t = dt_t sum_n B_t g_t + D dy_t, ddt_t = sum_n (x_t B_t + A a_t
    h_{t-1}) g_t, dA = sum_{b,t} dt_t a_t h_{t-1} g_t, dB_t = sum_c dt_t x_t
    g_t, dC_t = sum_c h_t dy_t, dD = sum_{b,t} x_t dy_t.  Returns (dx, ddt,
    dA, dB, dC, dD), each in its input's dtype."""
    b, s, c = x.shape
    n = A.shape[-1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf, dyf = Bm.float(), Cm.float(), dy.float()
    hs = torch.empty((b, s + 1, c, n), dtype=torch.float32, device=x.device)
    hs[:, 0] = 0.0
    h = hs[:, 0]
    for t in range(s):
        da = torch.exp(dtf[:, t, :, None] * Af[None])
        h = h * da + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        hs[:, t + 1] = h
    g = (torch.zeros((b, c, n), dtype=torch.float32, device=x.device)
         if dfinal is None else dfinal.float().clone())
    dx = torch.empty((b, s, c), dtype=torch.float32, device=x.device)
    ddt = torch.empty_like(dx)
    dB = torch.empty((b, s, n), dtype=torch.float32, device=x.device)
    dC = torch.empty_like(dB)
    dA = torch.zeros((c, n), dtype=torch.float32, device=x.device)
    for t in reversed(range(s)):
        g = g + Cf[:, t, None, :] * dyf[:, t, :, None]            # [b,c,n]
        da = torch.exp(dtf[:, t, :, None] * Af[None])
        ga = da * hs[:, t] * g
        u = (Bf[:, t, None, :] * g).sum(-1)                       # [b,c]
        dx[:, t] = dtf[:, t] * u + D.float() * dyf[:, t]
        ddt[:, t] = xf[:, t] * u + (Af[None] * ga).sum(-1)
        dA += (dtf[:, t, :, None] * ga).sum(0)
        dB[:, t] = ((dtf[:, t] * xf[:, t])[..., None] * g).sum(1)
        dC[:, t] = (hs[:, t + 1] * dyf[:, t, :, None]).sum(1)
        g = da * g
    dD = (xf * dyf).sum((0, 1))
    return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
            dB.to(Bm.dtype), dC.to(Cm.dtype), dD.to(D.dtype))


def model_scale_inputs(gen: torch.Generator, b: int, s: int, c: int, n: int,
                       dtype, warmup: int = 128):
    """Scan inputs ((x, dt, A, B, C, D), initial state) at a Mamba-1
    model's scales, drawn from ``gen`` on its device: dt = softplus(dt_bias
    + 0.1 * noise) with dt_bias the inverse softplus of dt log-uniform in
    [1e-3, 1e-1] per channel, A = -(uniform in [1, 16]) per (channel,
    state) (the model's inits, ``models/params.py``), x, B and C standard
    normal in ``dtype`` and D standard normal, and the initial state the
    plain version's final state after ``warmup`` such steps from zero, the
    size a served state has.  With these, exp(dt * A) lies in [0.2, 1)
    and a state carries over hundreds of steps, so a carry lost between
    the kernel's tiles shows; draws of dt ~ softplus(normal) and A ~
    -exp(normal) decay it within a few steps."""
    dev = gen.device

    def rn(*shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    u = torch.rand((c,), generator=gen, device=dev)
    dt0 = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    A = -(torch.rand((c, n), generator=gen, device=dev) * 15.0 + 1.0)
    D = rn(c)

    def draw(s_):
        return (rn(b, s_, c, dt=dtype), softplus(dt_bias + 0.1 * rn(b, s_, c)),
                rn(b, s_, n, dt=dtype), rn(b, s_, n, dt=dtype))
    wx, wdt, wB, wC = draw(warmup)
    _, h0 = selective_scan_ref(wx, wdt, A, wB, wC, D)
    x, dts, Bm, Cm = draw(s)
    return (x, dts, A, Bm, Cm, D), h0
