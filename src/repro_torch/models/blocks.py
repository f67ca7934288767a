"""Per-layer block composition: param defs, cache init, and application.

Every layer kind of the reference is served:

* ``dense``, ``local``, ``dense_moe``, ``moe`` and ``encoder``: pre-norm
  attention, then a pre-norm feed-forward, each added to the residual.
  A ``local`` layer is a ``dense`` one with a sliding window: the same
  params, a ring cache of ``sliding_window`` slots, and the local rope
  table (theta 1e4) where the model has one.  A ``dense_moe`` layer is a
  ``dense`` layer at the MoE interleave positions (llama4).  A ``moe``
  layer's feed-forward is the mixture of experts
  (:mod:`repro_torch.models.moe`, over one dispatch group: the
  reference's ``plan.moe_groups`` is 1 without a sharding plan).
  An ``encoder`` layer attends bidirectionally (``AttnConfig.causal``
  False) with no cache, and its cache is empty.
* ``mamba2``, ``mamba2+shared`` (Zamba2: a Mamba-2 layer followed by the
  one shared attention+MLP block) and ``mamba1`` (selective scan).
* ``hybrid_par`` (Falcon-H1, Hymba): attention and a Mamba-2 mixer side
  by side on one normed input, both added to the residual before its
  MLP; its cache is one flat dict of the Mamba-2 leaves ``conv``,
  ``ssm`` and the KV leaves ``k``, ``v``.

An unknown kind raises ``ValueError``, as in the reference.
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
from repro_torch.models.moe import moe, moe_param_defs
from repro_torch.models.norms import rms_norm
from repro_torch.models.params import ParamDef


def _unknown(kind: str) -> ValueError:
    return ValueError(f"unknown layer kind {kind!r}")


def layer_param_defs(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    D = cfg.d_model
    if kind in ("dense", "local", "encoder", "dense_moe"):
        return {
            "ln1": ParamDef((D,), ("embed",), init="zeros"),
            "attn": attn_param_defs(D, cfg.attn),
            "ln2": ParamDef((D,), ("embed",), init="zeros"),
            "mlp": mlp_param_defs(D, cfg.d_ff),
        }
    if kind == "moe":
        return {
            "ln1": ParamDef((D,), ("embed",), init="zeros"),
            "attn": attn_param_defs(D, cfg.attn),
            "ln2": ParamDef((D,), ("embed",), init="zeros"),
            "moe": moe_param_defs(D, cfg.moe),
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
    raise _unknown(kind)


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
    if kind == "encoder":
        return {}
    if kind in ("dense", "local", "moe", "dense_moe"):
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
    raise _unknown(kind)


def _attn_ff(cfg: ModelConfig, p: Dict, a, x: torch.Tensor, *, rope, cache,
             pos, valid_len, chunk_mask=None, window=None
             ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Pre-norm attention then the pre-norm feed-forward (the MLP, or the
    mixture of experts where ``p`` holds ``moe``), each added to the
    residual."""
    eps = cfg.norm_eps
    h = rms_norm(x, p["ln1"], eps)
    a_out, new_cache = attention(p["attn"], h, a, rope=rope, window=window,
                                 cache=cache, pos=pos, valid_len=valid_len,
                                 chunk_mask=chunk_mask, eps=eps)
    x = x + a_out
    h = rms_norm(x, p["ln2"], eps)
    if "moe" in p:
        return x + moe(p["moe"], h, cfg.moe, 1, cfg.act), new_cache
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
    {"conv", "ssm"}) where they can, and return them.  An ``encoder``
    layer attends with no cache and returns an empty one."""
    if kind == "encoder":
        x, _ = _attn_ff(cfg, p, cfg.attn, x, rope=rope, cache=None, pos=None,
                        valid_len=None)
        return x, {}
    if kind in ("dense", "local", "moe", "dense_moe"):
        local = kind == "local"
        return _attn_ff(
            cfg, p, cfg.attn, x,
            rope=rope_local if local and rope_local is not None else rope,
            cache=cache, pos=pos, valid_len=valid_len, chunk_mask=chunk_mask,
            window=cfg.attn.sliding_window if local else None)
    if kind == "hybrid_par":
        return _hybrid_par(cfg, p, x, rope=rope, cache=cache, pos=pos,
                           valid_len=valid_len, chunk_mask=chunk_mask,
                           chunk_lengths=chunk_lengths, slots=slots)
    if kind not in ("mamba2", "mamba2+shared", "mamba1"):
        raise _unknown(kind)
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
        x, new_attn = _attn_ff(cfg, shared, cfg.shared_attn, x, rope=rope,
                               cache=(cache["attn"] if cache is not None
                                      else None),
                               pos=pos, valid_len=valid_len)
        if new_cache is not None:
            new_cache["attn"] = new_attn
    return x, new_cache
