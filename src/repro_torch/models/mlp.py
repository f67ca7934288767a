"""Gated MLP (SwiGLU / GeGLU): ``act(x @ wg) * (x @ wi) @ wo``.

Plain matmuls, as in the reference, where they sit outside every Pallas
kernel.  The weights arrive in the compute dtype
(:func:`repro_torch.models.lm.prepare_params` casts them once).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.scope import scope
from repro_torch.distributed.sharding import constrain
from repro_torch.models.params import ParamDef

# the matmul weights the compute dtype reads (cast once at load)
MLP_KEYS = ("wi", "wg", "wo")


def mlp_param_defs(d_model: int, d_ff: int) -> Dict[str, ParamDef]:
    return {
        "wi": ParamDef((d_model, d_ff), ("embed", "ff"), fan_in=d_model),
        "wg": ParamDef((d_model, d_ff), ("embed", "ff"), fan_in=d_model),
        "wo": ParamDef((d_ff, d_model), ("ff", "embed"), init="normal_out",
                       fan_in=d_ff),
    }


def activation(act: str):
    """The gate's activation: SiLU, or GELU by the tanh approximation,
    ``jax.nn.gelu``'s default."""
    if act == "silu":
        return F.silu
    return lambda t: F.gelu(t, approximate="tanh")


def gated(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
          wo: torch.Tensor, act: str, h_axes=None) -> torch.Tensor:
    """``act(x @ wg) * (x @ wi) @ wo`` in ``x``'s dtype, with no scope (the
    caller opens its own: ``mlp``, or the MoE's ``moe_shared_expert``).
    ``h_axes`` (the MLP's) constrains the gated hidden to a plan's
    layout."""
    dt = x.dtype
    h = x @ wi.to(dt)
    g = x @ wg.to(dt)
    h = activation(act)(g) * h
    if h_axes is not None:
        h = constrain(h, h_axes)
    return h @ wo.to(dt)


def mlp(p: Dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    with scope("mlp"):
        return gated(x, p["wi"], p["wg"], p["wo"], act,
                     h_axes=("batch", "seq", "ff"))
