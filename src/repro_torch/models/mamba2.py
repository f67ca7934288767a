"""Mamba-2 (SSD) block — in/out projections + conv1d + chunked SSD core.

The large projections (``wz``, ``wxBC``, ``wdt``, ``out_proj``) are plain
matmuls, as in the reference, where they sit outside every Pallas kernel.
They take the weights in the compute dtype: the reference casts them per
use (``p["wz"].astype(dt_)``), and :func:`repro_torch.models.lm.prepare_params`
casts them once at load instead, which gives the same bits and saves
re-reading the fp32 weights on every decode step.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.config import SSMConfig
from repro_torch.core.scope import scope
from repro_torch.kernels.conv1d.ops import causal_conv1d
from repro_torch.kernels.decode_fused.ops import mamba2_decode_fused
from repro_torch.kernels.ssd.ops import ssd_chunked_raw
from repro_torch.models.norms import gated_rms_norm
from repro_torch.models.params import ParamDef

# dt_raw of masked and padded tokens: softplus(-30) ~ 1e-13, so they update
# no SSM state
INERT_DT = -30.0


def mamba2_param_defs(d_model: int, s: SSMConfig) -> Dict[str, ParamDef]:
    di = s.d_inner(d_model)
    nh = s.n_ssm_heads(d_model)
    gn = s.n_groups * s.d_state
    conv_dim = di + 2 * gn
    return {
        "wz": ParamDef((d_model, di), ("embed", "conv_dim"), fan_in=d_model),
        "wxBC": ParamDef((d_model, conv_dim), ("embed", "conv_dim"),
                         fan_in=d_model),
        "wdt": ParamDef((d_model, nh), ("embed", "ssm_heads"), fan_in=d_model),
        "conv_w": ParamDef((conv_dim, s.conv_kernel), ("conv_dim", None),
                           fan_in=s.conv_kernel),
        "conv_b": ParamDef((conv_dim,), ("conv_dim",), init="zeros"),
        "A_log": ParamDef((nh,), ("ssm_heads",), init="a_log"),
        "D": ParamDef((nh,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamDef((nh,), ("ssm_heads",), init="dt_bias"),
        "norm_scale": ParamDef((di,), ("conv_dim",), init="zeros"),
        "out_proj": ParamDef((di, d_model), ("conv_dim", "embed"),
                             init="normal_out", fan_in=di),
    }


# the matmul weights the compute dtype reads (cast once at load)
PROJ_KEYS = ("wz", "wxBC", "wdt", "out_proj")


def _split_xbc(xbc: torch.Tensor, s: SSMConfig, d_model: int):
    di = s.d_inner(d_model)
    gn = s.n_groups * s.d_state
    lead = xbc.shape[:-1]
    return (xbc[..., :di],
            xbc[..., di:di + gn].reshape(*lead, s.n_groups, s.d_state),
            xbc[..., di + gn:].reshape(*lead, s.n_groups, s.d_state))


def conv_lengths(mask: Optional[torch.Tensor],
                 lengths: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``lengths`` ([B] int32, the valid prefix per row, which ends a
    prefill's conv state; None: every row is full), which a chunk's
    ``mask`` must come with."""
    if mask is not None and lengths is None:
        raise ValueError("a chunk's mask comes with its rows' lengths")
    return lengths


def mamba2_block(p: Dict, x: torch.Tensor, s: SSMConfig, d_model: int, *,
                 cache: Optional[Dict] = None, eps: float = 1e-5,
                 mask: Optional[torch.Tensor] = None,
                 lengths: Optional[torch.Tensor] = None,
                 slots: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence pass. If cache is given (prefill), returns final states.

    ``mask`` ([B, S] bool, chunked prefill) marks valid tokens, a
    left-aligned prefix per row of ``lengths`` tokens ([B] int32, given
    with the mask).  Invalid tokens are inert: their dt is
    driven to zero and the conv state ends at the last valid input.
    ``slots`` ({"conv", "ssm"}, the layer's slots in a new cache) take the
    final conv and SSM states in place where their types allow; the
    returned cache holds them."""
    b, seq, _ = x.shape
    di = s.d_inner(d_model)
    nh = s.n_ssm_heads(d_model)
    dt_ = x.dtype
    with scope("ssm_in_proj"):
        z = x @ p["wz"].to(dt_)
        xbc = x @ p["wxBC"].to(dt_)
        dt_raw = x @ p["wdt"].to(dt_)
    if mask is not None:
        dt_raw = torch.where(mask[:, :, None], dt_raw,
                             torch.full((), INERT_DT, dtype=dt_,
                                        device=x.device))
    init_conv = cache["conv"] if cache is not None else None
    xbc, conv_state = causal_conv1d(
        xbc, p["conv_w"], p["conv_b"], initial_state=init_conv,
        lengths=conv_lengths(mask, lengths),
        out_state=state_slot(slots, "conv", dt_))
    xs, bm, cm = _split_xbc(xbc, s, d_model)
    xh = xs.reshape(b, seq, nh, s.headdim)

    # pad the sequence to a chunk multiple with inert tokens
    pad = (-seq) % s.chunk
    if pad:
        xh = torch.nn.functional.pad(xh, (0, 0, 0, 0, 0, pad))
        dt_raw = torch.nn.functional.pad(dt_raw, (0, 0, 0, pad),
                                         value=INERT_DT)
        bm = torch.nn.functional.pad(bm, (0, 0, 0, 0, 0, pad))
        cm = torch.nn.functional.pad(cm, (0, 0, 0, 0, 0, pad))
    init_ssm = cache["ssm"] if cache is not None else None
    y, ssm_state = ssd_chunked_raw(xh, dt_raw, p["dt_bias"], p["A_log"],
                                   bm.contiguous(), cm.contiguous(), p["D"],
                                   chunk=s.chunk, initial_state=init_ssm,
                                   out_state=state_slot(slots, "ssm",
                                                   torch.float32))
    y = y[:, :seq].reshape(b, seq, di)
    y = gated_rms_norm(y, z, p["norm_scale"], eps)
    with scope("ssm_out_proj"):
        out = y @ p["out_proj"].to(dt_)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": conv_state.to(cache["conv"].dtype),
                     "ssm": ssm_state.to(cache["ssm"].dtype)}
    return out, new_cache


def state_slot(slots: Optional[Dict], key: str, dtype: torch.dtype):
    """``slots[key]`` where the kernel can write it in place: present, of
    ``dtype``, contiguous and 16-byte aligned; else None (the caller
    copies)."""
    t = None if slots is None else slots.get(key)
    return t if (t is not None and t.dtype == dtype and t.is_contiguous()
                 and t.data_ptr() % 16 == 0) else None


def mamba2_decode(p: Dict, x: torch.Tensor, s: SSMConfig, d_model: int, *,
                  cache: Dict, eps: float = 1e-5,
                  slots: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """Single-token step. x: [B, 1, D]; cache: {"conv": [B,K-1,C],
    "ssm": [B,H,P,N]}.  Conv shift + state update run as one fused kernel,
    which writes the new window and state into ``slots`` ({"conv",
    "ssm"}, the layer's slots in a new cache) where their types allow."""
    b = x.shape[0]
    di = s.d_inner(d_model)
    dt_ = x.dtype
    xt = x[:, 0]
    with scope("ssm_in_proj"):
        z = xt @ p["wz"].to(dt_)
        xbc = xt @ p["wxBC"].to(dt_)
        dt_raw = xt @ p["wdt"].to(dt_)
    y, conv_state, ssm_state = mamba2_decode_fused(
        cache["conv"], cache["ssm"], xbc, p["conv_w"], p["conv_b"],
        dt_raw, p["dt_bias"], p["A_log"], p["D"],
        n_groups=s.n_groups, d_state=s.d_state, headdim=s.headdim,
        out_conv=state_slot(slots, "conv", dt_),
        out_ssm=state_slot(slots, "ssm", torch.float32))
    y = y.reshape(b, di)
    y = gated_rms_norm(y, z, p["norm_scale"], eps)
    with scope("ssm_out_proj"):
        out = (y @ p["out_proj"].to(dt_))[:, None, :]
    return out, {"conv": conv_state.to(cache["conv"].dtype),
                 "ssm": ssm_state.to(cache["ssm"].dtype)}


def init_mamba2_cache(d_model: int, s: SSMConfig, batch: int,
                      dtype: torch.dtype, device: torch.device) -> Dict:
    di = s.d_inner(d_model)
    nh = s.n_ssm_heads(d_model)
    conv_dim = di + 2 * s.n_groups * s.d_state
    return {
        "conv": torch.zeros((batch, s.conv_kernel - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, nh, s.headdim, s.d_state),
                           dtype=torch.float32, device=device),
    }
