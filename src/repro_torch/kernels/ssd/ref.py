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
    y, final, _ = ssd_chunked_states_ref(x, dt, A, Bm, Cm, D, chunk=chunk,
                                         initial_state=initial_state)
    return y, into(out_state, final)


def ssd_chunked_states_ref(x, dt, A, Bm, Cm, D, chunk: int = 128,
                           initial_state: Optional[torch.Tensor] = None):
    """``ssd_chunked_ref``'s (y, final state), and the state entering each
    chunk, fp32 [B, H, S / chunk, P, N]: what the forward saves for the
    backward."""
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
    return y.to(x.dtype), hprev, h_in.permute(0, 2, 1, 3, 4)


def ssd_chunked_bwd_ref(x, dt, A, Bm, Cm, D, dy, states, chunk: int = 128):
    """Backward of the chunked scan from a zero initial state, with no
    gradient into the final state (training's case), as
    ``csrc/ssd_bwd.cu`` computes it, in fp32.  ``states`` are the chunk
    start states ([B, H, S / chunk, P, N], :func:`ssd_chunked_states_ref`).
    Per chunk, with w_j = dt_j e^(cum_last - cum_j), L_ij =
    e^(cum_i - cum_j) (j <= i), M = (C B^T) L dt_j and dM = dy x^T:
    dx = D dy + w (dh' B) + M^T dy; dB = w (x dh') + (dM L dt_j)^T C;
    dC = e^cum (dy h) + (dM L dt_j) B; the state gradient dh' of the chunk
    after is e^cum_last dh'' + sum_i e^cum_i dy_i C_i^T; the gradient of
    each cum is summed back over the prefix sum into ddt and dA.  Returns
    (dx, dB, dC in x's dtype; ddt [B,S,H], dA [H], dD [H] fp32)."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    nc, q = s // chunk, chunk
    f32 = torch.float32
    Bh = _expand_groups(Bm, h).to(f32).reshape(b, nc, q, h, n)
    Ch = _expand_groups(Cm, h).to(f32).reshape(b, nc, q, h, n)
    xf = x.to(f32).reshape(b, nc, q, h, p)
    dyf = dy.to(f32).reshape(b, nc, q, h, p)
    dtf = dt.to(f32).reshape(b, nc, q, h).permute(0, 1, 3, 2)   # [b,c,h,q]
    Af = A.to(f32)
    hin = states.to(f32).permute(0, 2, 1, 3, 4)                  # [b,c,h,p,n]
    da_t = dtf * Af[:, None]                                     # [b,c,h,q]
    cum = torch.cumsum(da_t, dim=-1)
    last = cum[..., -1:]
    ecum, elast = torch.exp(cum), torch.exp(last)
    wend = dtf * torch.exp(last - cum)
    # the state gradient leaving each chunk, walked back from zero
    local = torch.einsum("bchq,bcqhp,bcqhn->bchpn", ecum, dyf, Ch)
    dh_out = torch.zeros_like(hin)
    carry = torch.zeros_like(hin[:, 0])
    for c in range(nc - 1, -1, -1):
        dh_out[:, c] = carry
        carry = elast[:, c, :, :, None] * carry + local[:, c]
    # the state terms
    t1 = torch.einsum("bcjhn,bchpn->bcjhp", Bh, dh_out)
    wq = wend.permute(0, 1, 3, 2)[..., None]                     # [b,c,q,h,1]
    dx = D.to(f32)[:, None] * dyf + wq * t1
    dw = (xf * t1).sum(-1).permute(0, 1, 3, 2)                   # [b,c,h,q]
    dB = wq * torch.einsum("bcjhp,bchpn->bcjhn", xf, dh_out)
    u = torch.einsum("bcihp,bchpn->bcihn", dyf, hin)
    dC = ecum.permute(0, 1, 3, 2)[..., None] * u
    dcum = (Ch * dC).sum(-1).permute(0, 1, 3, 2)
    ddt = torch.exp(last - cum) * dw
    dcum = dcum - wend * dw
    dcum_last = (elast[..., 0] * (dh_out * hin).sum((-1, -2))
                 + (wend * dw).sum(-1))
    # the intra-chunk terms
    G = torch.einsum("bcihn,bcjhn->bchij", Ch, Bh)
    dM = torch.einsum("bcihp,bcjhp->bchij", dyf, xf)
    L = torch.exp(_segsum(da_t))                                 # 0 above
    M = G * L * dtf[..., None, :]
    dG = dM * L * dtf[..., None, :]
    E = G * L * dM
    dcum = dcum + (M * dM).sum(-1) - dtf * E.sum(-2)
    ddt = ddt + E.sum(-2)
    dx = dx + torch.einsum("bchij,bcihp->bcjhp", M, dyf)
    dB = dB + torch.einsum("bchij,bcihn->bcjhn", dG, Ch)
    dC = dC + torch.einsum("bchij,bcjhn->bcihn", dG, Bh)
    dcum[..., -1] += dcum_last
    da = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
    ddt = ddt + Af[:, None] * da
    dA = (dtf * da).sum((0, 1, 3))
    dD = (dyf * xf).sum((0, 1, 2, 4))
    dB = dB.reshape(b, s, g, h // g, n).sum(3)
    dC = dC.reshape(b, s, g, h // g, n).sum(3)
    return (dx.reshape(b, s, h, p).to(x.dtype), ddt.permute(0, 1, 3, 2)
            .reshape(b, s, h), dA, dB.to(x.dtype), dC.to(x.dtype), dD)


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
