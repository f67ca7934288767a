"""Plain PyTorch Mamba-2 SSD (state-space dual) operator.

Shapes (following the Mamba-2 paper):
  x  : [B, S, H, P]   per-head inputs (P = headdim)
  dt : [B, S, H]      post-softplus step sizes
  A  : [H]            negative per-head decay rates
  Bm : [B, S, G, N]   input projections (G groups, N = d_state)
  Cm : [B, S, G, N]   output projections
  D  : [H]            skip connection
Returns y : [B, S, H, P] and final state [B, H, P, N] (fp32).

  * ``ssd_sequential`` — O(S) token-by-token recurrence (ground truth).
  * ``ssd_chunked_ref`` — the chunked dual form the kernel implements.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: max(x, 0) + log1p(exp(-|x|)).  Not torch's
    thresholded ``F.softplus``; the kernels use the same formula."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _expand_groups(t: torch.Tensor, n_heads: int, dim: int = 2) -> torch.Tensor:
    """[B, S, G, N] -> [B, S, H, N] by repeating each group."""
    return torch.repeat_interleave(t, n_heads // t.shape[dim], dim=dim)


def preprocess_dt_A(dt_raw, dt_bias, A_log):
    """dt = softplus(dt_raw + dt_bias), A = -exp(A_log), both fp32."""
    dt = softplus(dt_raw.float() + dt_bias.float())
    A = -torch.exp(A_log.float())
    return dt, A


def _init_state(x, n, initial_state):
    b, _, h, p = x.shape
    if initial_state is None:
        return torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    return initial_state.float()


def ssd_sequential(x, dt, A, Bm, Cm, D,
                   initial_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    Bh = _expand_groups(Bm, h).float()
    Ch = _expand_groups(Cm, h).float()
    xf, dtf, Af = x.float(), dt.float(), A.float()
    hstate = _init_state(x, n, initial_state)
    ys = []
    for t in range(s):
        da = torch.exp(dtf[:, t] * Af)                       # [b,h]
        upd = (dtf[:, t, :, None] * Bh[:, t])[:, :, None, :] \
            * xf[:, t, :, :, None]
        hstate = hstate * da[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", hstate, Ch[:, t]))
    y = torch.stack(ys, dim=1) + xf * D.float()[None, None, :, None]
    return y.to(x.dtype), hstate


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j<k<=i} a[..., k]; -inf where j > i."""
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk: int = 128,
                    initial_state: Optional[torch.Tensor] = None,
                    out_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (matmul dual form), numerically matching ssd_sequential.
    ``out_state``, when given, receives a copy of the final state and is
    returned in its place, as the kernel writes its destination."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} must be a multiple of chunk {chunk}")
    nc, q = s // chunk, chunk
    Bh = _expand_groups(Bm, h).float().reshape(b, nc, q, h, n)
    Ch = _expand_groups(Cm, h).float().reshape(b, nc, q, h, n)
    xf = x.float().reshape(b, nc, q, h, p)
    dtf = dt.float().reshape(b, nc, q, h)
    Af = A.float()

    da_t = (dtf * Af).permute(0, 1, 3, 2)            # [b,nc,h,q]
    cum = torch.cumsum(da_t, dim=-1)
    L = torch.exp(_segsum(da_t))                     # [b,nc,h,q,q]
    cb = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)
    dtx = dtf[..., None] * xf                        # [b,nc,q,h,p]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", cb * L, dtx)

    decay_to_end = torch.exp(cum[..., -1:] - cum)    # [b,nc,h,q]
    states = torch.einsum("bchq,bcqhn,bcqhp->bchpn", decay_to_end, Bh, dtx)
    chunk_decay = torch.exp(cum[..., -1])            # [b,nc,h]

    hprev = _init_state(x, n, initial_state)
    h_in = []
    for c in range(nc):                              # state entering chunk c
        h_in.append(hprev)
        hprev = hprev * chunk_decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)                  # [b,nc,h,p,n]

    y_off = torch.einsum("bcqhn,bchpn,bchq->bcqhp", Ch, h_in, torch.exp(cum))
    y = (y_diag + y_off).reshape(b, s, h, p)
    y = y + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), into(out_state, hprev)


def into(out: Optional[torch.Tensor], t: torch.Tensor) -> torch.Tensor:
    """``t``, or ``out`` holding a copy of it."""
    if out is None:
        return t
    out.copy_(t)
    return out


def ssd_decode_ref(state, x_t, dt_t, A, B_t, C_t, D
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. state: [B,H,P,N]; x_t: [B,H,P]; dt_t: [B,H];
    B_t/C_t: [B,G,N]."""
    h = x_t.shape[1]
    Bh = _expand_groups(B_t, h, dim=1).float()
    Ch = _expand_groups(C_t, h, dim=1).float()
    xf, dtf = x_t.float(), dt_t.float()
    da = torch.exp(dtf * A.float())
    upd = (dtf[..., None] * Bh)[:, :, None, :] * xf[..., None]
    new_state = state * da[..., None, None] + upd
    y = (torch.einsum("bhpn,bhn->bhp", new_state, Ch)
         + xf * D.float()[None, :, None])
    return y.to(x_t.dtype), new_state


def model_scale_inputs(gen: torch.Generator, b: int, s: int, h: int, p: int,
                       n: int, dtype, warmup: int = 128):
    """SSD inputs ((x, dt, A, B, C, D), initial state) at a Mamba-2 model's
    scales, drawn from ``gen`` on its device: dt = softplus(dt_bias + 0.1 *
    noise) with dt_bias the inverse softplus of dt log-uniform in [1e-3,
    1e-1] per head (the model's init), A = -(uniform in [1, 16]) (A_log's
    init), x, B and C standard normal in ``dtype`` (conv outputs; B and C
    of one group), and the initial state the plain version's final state
    after ``warmup`` such tokens from zero, the size a served state has.
    Unscaled draws put dt * A where exp(dt * A) is ~1 or ~0, where a
    dropped carry can hide."""
    dev = gen.device

    def rn(*shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    u = torch.rand((h,), generator=gen, device=dev)
    dt0 = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    A = -(torch.rand((h,), generator=gen, device=dev) * 15.0 + 1.0)
    D = rn(h)

    def draw(s_):
        return (rn(b, s_, h, p, dt=dtype),
                softplus(dt_bias + 0.1 * rn(b, s_, h)),
                rn(b, s_, 1, n, dt=dtype), rn(b, s_, 1, n, dt=dtype))
    wx, wdt, wB, wC = draw(warmup)
    _, h0 = ssd_chunked_ref(wx, wdt, A, wB, wC, D, chunk=warmup)
    x, dts, Bm, Cm = draw(s)
    return (x, dts, A, Bm, Cm, D), h0
