"""Plain PyTorch fused decode steps (Mamba-2 and Mamba-1).

Each composes the conv shift step, the projections and the state update
op for op, cast for cast, as the reference's ``mamba2_decode_fused_ref``
and ``mamba1_decode_fused_ref`` do.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.conv1d.ref import conv1d_decode_ref
from repro_torch.kernels.ssd.ref import into, softplus, ssd_decode_ref


def mamba2_decode_fused_ref(conv_state, ssm_state, xbc_t, conv_w, conv_b,
                            dt_raw, dt_bias, A_log, D, *, n_groups: int,
                            d_state: int, headdim: int,
                            out_conv: Optional[torch.Tensor] = None,
                            out_ssm: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """conv_state: [B,K-1,C]; ssm_state: [B,H,P,N]; xbc_t: [B,C] (pre-conv
    packed x|B|C); dt_raw: [B,H].  Returns (y [B,H,P], conv_state',
    ssm_state' [B,H,P,N] fp32); ``out_conv`` and ``out_ssm``, when given,
    receive copies of the last two and are returned in their place, as
    the kernel writes its destinations."""
    xbc, new_conv = conv1d_decode_ref(conv_state, xbc_t, conv_w, conv_b)
    gn = n_groups * d_state
    di = xbc.shape[-1] - 2 * gn
    b = xbc.shape[0]
    xs = xbc[..., :di]
    bm = xbc[..., di:di + gn].reshape(b, n_groups, d_state)
    cm = xbc[..., di + gn:].reshape(b, n_groups, d_state)
    dt = softplus(dt_raw.float() + dt_bias.float())
    A = -torch.exp(A_log.float())
    y, new_ssm = ssd_decode_ref(ssm_state.float(),
                                xs.reshape(b, di // headdim, headdim),
                                dt, A, bm, cm, D)
    return y, into(out_conv, new_conv), into(out_ssm, new_ssm)


def mamba1_decode_fused_ref(conv_state, ssm_state, xi_t, conv_w, conv_b,
                            x_proj, dt_proj, dt_bias, A_log, D, *,
                            d_state: int, dt_rank: int,
                            out_conv: Optional[torch.Tensor] = None,
                            out_ssm: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """conv_state: [B,K-1,di]; ssm_state: [B,di,N]; xi_t: [B,di] (pre-conv).
    Returns (y [B,di] fp32, conv_state', ssm_state' [B,di,N] fp32).  The
    projections read ``x_proj`` and ``dt_proj`` in the conv output's dtype
    and round their outputs to it, as the reference's oracle does.
    ``out_conv`` and ``out_ssm``, when given, receive copies of the last
    two and are returned in their place, as the kernel writes its
    destinations."""
    xi, new_conv = conv1d_decode_ref(conv_state, xi_t, conv_w, conv_b)
    dt_ = xi.dtype
    proj = xi @ x_proj.to(dt_)
    dt_low = proj[..., :dt_rank]
    bm = proj[..., dt_rank:dt_rank + d_state]
    cm = proj[..., dt_rank + d_state:]
    dt = softplus((dt_low @ dt_proj.to(dt_)).float() + dt_bias.float())
    A = -torch.exp(A_log.float())
    h = ssm_state.float()
    dA = torch.exp(dt[..., None] * A[None])
    dBx = (dt * xi.float())[..., None] * bm.float()[:, None, :]
    h = h * dA + dBx
    y = torch.einsum("bdn,bn->bd", h, cm.float())
    y = y + xi.float() * D.float()
    return y, into(out_conv, new_conv), into(out_ssm, h)
