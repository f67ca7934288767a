"""Plain PyTorch Mamba-1 selective scan (S6), the reference oracle's math.

Shapes: x, dt: [B, S, C] (C = d_inner, dt post-softplus); A: [C, N];
Bm, Cm: [B, S, N]; D: [C]; h: [B, C, N].  A sequential loop over S in
fp32, step for step as the reference's ``selective_scan_ref``:
``h = h * exp(dt*A) + (dt*x) * B``, ``y = C . h``, and ``D * x`` added
after the loop.  Used by the CPU path of :mod:`.ops`, by the tests, and as
the kernel's comparison on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def selective_scan_ref(x, dt, A, Bm, Cm, D,
                       initial_state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B,S,C] in x's dtype, final h [B,C,N] fp32)."""
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
    return y.to(x.dtype), h
