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


def mlp(p: Dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    with scope("mlp"):
        dt = x.dtype
        h = x @ p["wi"].to(dt)
        g = x @ p["wg"].to(dt)
        # jax.nn.gelu's default is the tanh approximation
        a = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
        return (a * h) @ p["wo"].to(dt)
