"""Normalization layers (pure functions, fp32 inside, ``1 + scale``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.scope import scope


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    with scope("norm"):
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * (1.0 + scale.float())).to(x.dtype)


def gated_rms_norm(x: torch.Tensor, gate: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Mamba2 gated RMSNorm: norm(x * silu(z)) with learned scale."""
    with scope("ssm_gate"):
        xf = x.float() * F.silu(gate.float())
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * (1.0 + scale.float())).to(x.dtype)
