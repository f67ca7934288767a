"""Mamba-1 block: selective scan (S6) with data-dependent dt, B and C.

The large projections (``wx``, ``wz``, ``out_proj``) and, in prefill, the
``x_proj`` and ``dt_proj`` products are plain matmuls, as in the
reference, where they sit outside every Pallas kernel.  The conv, the
scan and the whole decode step go through the kernels' wrappers, which
pick the path by device.  Matmul weights are read in the compute dtype:
:func:`repro_torch.models.lm.prepare_params` casts ``PROJ_KEYS`` once at
load, which gives the reference's per-use ``.astype(dt_)`` bits.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.config import SSMConfig
from repro_torch.core.scope import scope
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels.conv1d.ops import causal_conv1d
from repro_torch.kernels.conv1d.ref import silu
from repro_torch.kernels.decode_fused.ops import mamba1_decode_fused
from repro_torch.kernels.scan1.ops import selective_scan
from repro_torch.kernels.ssd.ref import softplus
from repro_torch.models.mamba2 import INERT_DT, conv_lengths, state_slot
from repro_torch.models.params import ParamDef


def dt_rank(d_model: int, s: SSMConfig) -> int:
    return s.dt_rank or max(1, math.ceil(d_model / 16))


def mamba1_param_defs(d_model: int, s: SSMConfig) -> Dict[str, ParamDef]:
    di = s.d_inner(d_model)
    dtr = dt_rank(d_model, s)
    return {
        "wx": ParamDef((d_model, di), ("embed", "conv_dim"), fan_in=d_model),
        "wz": ParamDef((d_model, di), ("embed", "conv_dim"), fan_in=d_model),
        "conv_w": ParamDef((di, s.conv_kernel), ("conv_dim", None),
                           fan_in=s.conv_kernel),
        "conv_b": ParamDef((di,), ("conv_dim",), init="zeros"),
        "x_proj": ParamDef((di, dtr + 2 * s.d_state), ("conv_dim", None),
                           fan_in=di),
        "dt_proj": ParamDef((dtr, di), ("dt_rank", "conv_dim"), fan_in=dtr),
        "dt_bias": ParamDef((di,), ("conv_dim",), init="dt_bias"),
        "A_log": ParamDef((di, s.d_state), ("conv_dim", "dstate"),
                          init="a_log"),
        "D": ParamDef((di,), ("conv_dim",), init="ones"),
        "out_proj": ParamDef((di, d_model), ("conv_dim", "embed"),
                             init="normal_out", fan_in=di),
    }


# the matmul weights the compute dtype reads (cast once at load)
PROJ_KEYS = ("wx", "wz", "x_proj", "dt_proj", "out_proj")


def mamba1_block(p: Dict, x: torch.Tensor, s: SSMConfig, d_model: int, *,
                 cache: Optional[Dict] = None, eps: float = 1e-5,
                 mask: Optional[torch.Tensor] = None,
                 lengths: Optional[torch.Tensor] = None,
                 slots: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence pass; with a cache (prefill) also returns the final
    states.  ``mask`` ([B, S] bool, chunked prefill) marks valid tokens, a
    left-aligned prefix per row of ``lengths`` tokens ([B] int32, given
    with the mask): invalid tokens are inert (their dt is
    softplus(-30), so the scan state passes through) and the conv state
    ends at the last valid input.  ``slots`` ({"conv", "ssm"}, the
    layer's slots in a new cache) take the final conv state and the
    scan's final state in place where their types allow."""
    dtr = dt_rank(d_model, s)
    dt_ = x.dtype
    with scope("ssm_in_proj"):
        xi = x @ p["wx"].to(dt_)
        z = x @ p["wz"].to(dt_)
    xi = constrain(xi, ("batch", "seq", "conv_dim"))
    init_conv = cache["conv"] if cache is not None else None
    xi, conv_state = causal_conv1d(
        xi, p["conv_w"], p["conv_b"], initial_state=init_conv,
        lengths=conv_lengths(mask, lengths),
        out_state=state_slot(slots, "conv", dt_))
    with scope("ssm_in_proj"):
        proj = xi @ p["x_proj"].to(dt_)
        dt_low = proj[..., :dtr]
        bm = proj[..., dtr:dtr + s.d_state]
        cm = proj[..., dtr + s.d_state:]
        dt_pre = ((dt_low @ p["dt_proj"].to(dt_)).float()
                  + p["dt_bias"].float())
        if mask is not None:
            dt_pre = torch.where(mask[:, :, None], dt_pre,
                                 torch.full((), INERT_DT, device=x.device))
        dt = softplus(dt_pre)
    A = -torch.exp(p["A_log"].float())
    init_ssm = cache["ssm"] if cache is not None else None
    y, ssm_state = selective_scan(xi, dt, A, bm, cm, p["D"].float(),
                                  initial_state=init_ssm,
                                  out_state=state_slot(slots, "ssm",
                                                       torch.float32))
    with scope("ssm_gate"):
        y = y * silu(z.float()).to(dt_)
    with scope("ssm_out_proj"):
        out = y @ p["out_proj"].to(dt_)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": conv_state.to(cache["conv"].dtype),
                     "ssm": ssm_state.float()}
    return constrain(out, ("batch", "seq", "embed")), new_cache


def mamba1_decode(p: Dict, x: torch.Tensor, s: SSMConfig, d_model: int, *,
                  cache: Dict, eps: float = 1e-5,
                  slots: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    """Single-token step. x: [B, 1, D]; cache: {"conv": [B,K-1,di],
    "ssm": [B,di,N]}.  Conv shift, the dt/B/C projections and the state
    update run as one fused kernel, which writes the new window and state
    into ``slots`` ({"conv", "ssm"}, the layer's slots in a new cache)
    where their types allow.  The new conv window comes back in the
    cache's dtype."""
    dt_ = x.dtype
    xt = x[:, 0]
    with scope("ssm_in_proj"):
        xi = xt @ p["wx"].to(dt_)
        z = xt @ p["wz"].to(dt_)
    y, conv_state, h = mamba1_decode_fused(
        cache["conv"], cache["ssm"], xi, p["conv_w"], p["conv_b"],
        p["x_proj"], p["dt_proj"], p["dt_bias"], p["A_log"], p["D"],
        d_state=s.d_state, dt_rank=dt_rank(d_model, s),
        out_conv=state_slot(slots, "conv", dt_),
        out_ssm=state_slot(slots, "ssm", torch.float32))
    with scope("ssm_gate"):
        y = y * silu(z.float())
    with scope("ssm_out_proj"):
        out = (y.to(dt_) @ p["out_proj"].to(dt_))[:, None, :]
    return out, {"conv": conv_state.to(cache["conv"].dtype), "ssm": h}


def init_mamba1_cache(d_model: int, s: SSMConfig, batch: int,
                      dtype: torch.dtype, device: torch.device) -> Dict:
    di = s.d_inner(d_model)
    return {
        "conv": torch.zeros((batch, s.conv_kernel - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, s.d_state), dtype=torch.float32,
                           device=device),
    }
