"""Per-layer block composition: param defs, cache init, and application.

The port serves the ``mamba2`` kind so far; every other kind raises and
names the ROADMAP item that ports it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.models import mamba2 as m2
from repro_torch.models.norms import rms_norm
from repro_torch.models.params import ParamDef

_NOT_PORTED = {
    "dense": "the hybrid/dense slice (attention, rope, mlp)",
    "local": "the sliding-window ring slice",
    "moe": "the MoE item",
    "dense_moe": "the MoE item",
    "mamba2+shared": "the hybrid/dense slice (attention, rope, mlp)",
    "hybrid_par": "the hybrid/dense slice (attention, rope, mlp)",
    "mamba1": "the Mamba-1 slice",
    "encoder": "the encoder and frontends item",
}


def _unported(kind: str) -> NotImplementedError:
    where = _NOT_PORTED.get(kind)
    if where is None:
        return NotImplementedError(f"unknown layer kind {kind!r}")
    return NotImplementedError(
        f"layer kind {kind!r} is not ported yet; ROADMAP.md: {where}")


def layer_param_defs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    if kind != "mamba2":
        raise _unported(kind)
    return {
        "ln": ParamDef((cfg.d_model,), ("embed",), init="zeros"),
        "mamba": m2.mamba2_param_defs(cfg.d_model, cfg.ssm),
    }


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, *,
                     dtype: torch.dtype, device: torch.device) -> Dict:
    if kind != "mamba2":
        raise _unported(kind)
    return m2.init_mamba2_cache(cfg.d_model, cfg.ssm, batch, dtype, device)


def apply_layer(cfg: ModelConfig, kind: str, p: Dict, x: torch.Tensor, *,
                cache: Optional[Dict] = None,
                pos: Optional[torch.Tensor] = None,
                chunk_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """``chunk_mask`` ([B, S] bool) marks valid tokens during a chunked
    prefill; SSM layers treat invalid tokens as inert.  A one-token call
    with a cache and ``pos`` is a decode step."""
    if kind != "mamba2":
        raise _unported(kind)
    eps = cfg.norm_eps
    h = rms_norm(x, p["ln"], eps)
    is_decode = cache is not None and x.shape[1] == 1 and pos is not None
    if is_decode:
        out, new_cache = m2.mamba2_decode(p["mamba"], h, cfg.ssm, cfg.d_model,
                                          cache=cache, eps=eps)
    else:
        out, new_cache = m2.mamba2_block(p["mamba"], h, cfg.ssm, cfg.d_model,
                                         cache=cache, eps=eps,
                                         mask=chunk_mask)
    return x + out, new_cache
