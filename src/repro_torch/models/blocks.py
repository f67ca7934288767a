"""Per-layer block composition: param defs, cache init, and application.

The port serves the ``mamba2``, ``mamba2+shared`` (Zamba2: a Mamba-2
layer followed by the one shared attention+MLP block), ``mamba1``
(selective scan), ``dense``, ``local`` and ``hybrid_par`` kinds.  A
``local`` layer is a ``dense`` one with a sliding window: the same
params, a ring cache of ``sliding_window`` slots, and the local rope
table (theta 1e4) where the model has one.  A ``hybrid_par`` layer
(Falcon-H1, Hymba) runs attention and a Mamba-2 mixer side by side on
one normed input and adds both to the residual before its MLP; its cache
is one flat dict of the Mamba-2 leaves ``conv``, ``ssm`` and the KV
leaves ``k``, ``v``.  Every other kind raises and names the ROADMAP item
that ports it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.models import mamba1 as m1
from repro_torch.models import mamba2 as m2
from repro_torch.models.attention import (attention, attn_param_defs,
                                          init_attn_cache)
from repro_torch.models.mlp import mlp, mlp_param_defs
from repro_torch.models.norms import rms_norm
from repro_torch.models.params import ParamDef

_NOT_PORTED = {
    "moe": "the MoE item",
    "dense_moe": "the MoE item",
    "encoder": "the encoder and frontends item",
}


def _unported(kind: str) -> NotImplementedError:
    where = _NOT_PORTED.get(kind)
    if where is None:
        return NotImplementedError(f"unknown layer kind {kind!r}")
    return NotImplementedError(
        f"layer kind {kind!r} is not ported yet; ROADMAP.md: {where}")


def layer_param_defs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    D = cfg.d_model
    if kind in ("dense", "local"):
        return {
            "ln1": ParamDef((D,), ("embed",), init="zeros"),
            "attn": attn_param_defs(D, cfg.attn),
            "ln2": ParamDef((D,), ("embed",), init="zeros"),
            "mlp": mlp_param_defs(D, cfg.d_ff),
        }
    if kind == "hybrid_par":
        return {
            "ln1": ParamDef((D,), ("embed",), init="zeros"),
            "attn": attn_param_defs(D, cfg.attn),
            "mamba": m2.mamba2_param_defs(D, cfg.ssm),
            "ln2": ParamDef((D,), ("embed",), init="zeros"),
            "mlp": mlp_param_defs(D, cfg.d_ff),
        }
    if kind in ("mamba2", "mamba2+shared"):
        return {
            "ln": ParamDef((D,), ("embed",), init="zeros"),
            "mamba": m2.mamba2_param_defs(D, cfg.ssm),
        }
    if kind == "mamba1":
        return {
            "ln": ParamDef((D,), ("embed",), init="zeros"),
            "mamba": m1.mamba1_param_defs(D, cfg.ssm),
        }
    raise _unported(kind)


def shared_block_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """Zamba2-style shared transformer block (one copy, applied at every
    'mamba2+shared' position)."""
    D = cfg.d_model
    return {
        "ln1": ParamDef((D,), ("embed",), init="zeros"),
        "attn": attn_param_defs(D, cfg.shared_attn),
        "ln2": ParamDef((D,), ("embed",), init="zeros"),
        "mlp": mlp_param_defs(D, cfg.shared_attn_d_ff or cfg.d_ff),
    }


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     *, dtype: torch.dtype, device: torch.device) -> Dict:
    if kind in ("dense", "local"):
        window = cfg.attn.sliding_window if kind == "local" else None
        return init_attn_cache(cfg.attn, batch, max_seq, window=window,
                               dtype=dtype, device=device)
    if kind == "hybrid_par":
        c = m2.init_mamba2_cache(cfg.d_model, cfg.ssm, batch, dtype, device)
        c.update(init_attn_cache(cfg.attn, batch, max_seq, dtype=dtype,
                                 device=device))
        return c
    if kind in ("mamba2", "mamba2+shared"):
        c = m2.init_mamba2_cache(cfg.d_model, cfg.ssm, batch, dtype, device)
        if kind == "mamba2+shared":
            c["attn"] = init_attn_cache(cfg.shared_attn, batch, max_seq,
                                        dtype=dtype, device=device)
        return c
    if kind == "mamba1":
        return m1.init_mamba1_cache(cfg.d_model, cfg.ssm, batch, dtype,
                                    device)
    raise _unported(kind)


def _attn_mlp(cfg: ModelConfig, p: Dict, a, x: torch.Tensor, *, rope, cache,
              pos, valid_len, chunk_mask=None, window=None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Pre-norm attention then pre-norm MLP, each added to the residual."""
    eps = cfg.norm_eps
    h = rms_norm(x, p["ln1"], eps)
    a_out, new_cache = attention(p["attn"], h, a, rope=rope, window=window,
                                 cache=cache, pos=pos, valid_len=valid_len,
                                 chunk_mask=chunk_mask, eps=eps)
    x = x + a_out
    h = rms_norm(x, p["ln2"], eps)
    return x + mlp(p["mlp"], h, cfg.act), new_cache


def _mamba(cfg: ModelConfig, kind: str, p: Dict, h: torch.Tensor, *, cache,
           pos, chunk_mask, chunk_lengths, slots
           ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The Mamba mixer of a ``kind`` layer on the normed input ``h``, with
    the ``conv`` and ``ssm`` leaves of the layer's cache: a decode step
    for a one-token call with a cache and ``pos``, else a block."""
    mcache = None
    if cache is not None:
        mcache = {"conv": cache["conv"], "ssm": cache["ssm"]}
    is_decode = cache is not None and h.shape[1] == 1 and pos is not None
    if kind == "mamba1":
        block, decode = m1.mamba1_block, m1.mamba1_decode
    else:
        block, decode = m2.mamba2_block, m2.mamba2_decode
    if is_decode:
        return decode(p, h, cfg.ssm, cfg.d_model, cache=mcache,
                      eps=cfg.norm_eps, slots=slots)
    return block(p, h, cfg.ssm, cfg.d_model, cache=mcache, eps=cfg.norm_eps,
                 mask=chunk_mask, lengths=chunk_lengths, slots=slots)


def _hybrid_par(cfg: ModelConfig, p: Dict, x: torch.Tensor, *, rope, cache,
                pos, valid_len, chunk_mask, chunk_lengths, slots
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Falcon-H1-style parallel heads: attention (KV leaves written in
    place) and Mamba-2 (new states into ``slots``) read the same normed
    input, and both outputs join the residual in the reference's order,
    ``x + a_out + m_out``; then the pre-norm MLP."""
    eps = cfg.norm_eps
    h = rms_norm(x, p["ln1"], eps)
    a_out, new_attn = attention(
        p["attn"], h, cfg.attn, rope=rope,
        cache=({"k": cache["k"], "v": cache["v"]} if cache is not None
               else None),
        pos=pos, valid_len=valid_len, chunk_mask=chunk_mask, eps=eps)
    m_out, new_m = _mamba(cfg, "hybrid_par", p["mamba"], h, cache=cache,
                          pos=pos, chunk_mask=chunk_mask,
                          chunk_lengths=chunk_lengths, slots=slots)
    x = x + a_out + m_out
    h = rms_norm(x, p["ln2"], eps)
    x = x + mlp(p["mlp"], h, cfg.act)
    new_cache = None
    if cache is not None:
        new_cache = dict(new_m)
        new_cache.update(new_attn)
    return x, new_cache


def apply_layer(cfg: ModelConfig, kind: str, p: Dict, x: torch.Tensor, *,
                rope=None, rope_local=None, cache: Optional[Dict] = None,
                pos: Optional[torch.Tensor] = None,
                shared: Optional[Dict] = None,
                chunk_mask: Optional[torch.Tensor] = None,
                chunk_lengths: Optional[torch.Tensor] = None,
                valid_len: Optional[torch.Tensor] = None,
                slots: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """``chunk_mask`` ([B, S] bool) marks valid tokens during a chunked
    prefill, a prefix of ``chunk_lengths`` ([B] int32) per row; SSM layers
    treat invalid tokens as inert.  A one-token call
    with a cache and ``pos`` is a decode step.  ``rope`` is the (sin, cos)
    pair at the call's token positions and ``valid_len`` a decode step's
    attended rows of this layer's cache, both as
    :func:`repro_torch.models.attention.attention` takes them;
    ``rope_local`` the local table's pair, which ``local`` layers take
    where it is given; ``shared`` the shared block's params.  KV leaves of
    ``cache`` are written in place (see
    :mod:`repro_torch.models.attention`); a Mamba layer's kernels write
    its new states into ``slots`` (the layer's slots in the new cache:
    {"conv", "ssm"}) where they can, and return them."""
    if kind in ("dense", "local"):
        local = kind == "local"
        return _attn_mlp(
            cfg, p, cfg.attn, x,
            rope=rope_local if local and rope_local is not None else rope,
            cache=cache, pos=pos, valid_len=valid_len, chunk_mask=chunk_mask,
            window=cfg.attn.sliding_window if local else None)
    if kind == "hybrid_par":
        return _hybrid_par(cfg, p, x, rope=rope, cache=cache, pos=pos,
                           valid_len=valid_len, chunk_mask=chunk_mask,
                           chunk_lengths=chunk_lengths, slots=slots)
    if kind not in ("mamba2", "mamba2+shared", "mamba1"):
        raise _unported(kind)
    eps = cfg.norm_eps
    h = rms_norm(x, p["ln"], eps)
    out, new_cache = _mamba(cfg, kind, p["mamba"], h, cache=cache, pos=pos,
                            chunk_mask=chunk_mask,
                            chunk_lengths=chunk_lengths, slots=slots)
    x = x + out
    if kind == "mamba2+shared":
        if shared is None:
            raise ValueError("mamba2+shared layers need the shared block's "
                             "params")
        x, new_attn = _attn_mlp(cfg, shared, cfg.shared_attn, x, rope=rope,
                                cache=(cache["attn"] if cache is not None
                                       else None),
                                pos=pos, valid_len=valid_len)
        if new_cache is not None:
            new_cache["attn"] = new_attn
    return x, new_cache
