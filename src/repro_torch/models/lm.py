"""Language model: embedding -> layer segments -> head.

The port of the reference's ``repro.models.lm``, every layer kind
(:mod:`repro_torch.models.blocks`) and both frontends.  Params and
caches keep the reference's layouts: params are the same nested dict,
with ``segments`` a list of per-unit tuples whose leaves are stacked
``[n_rep, ...]``, for Zamba2-style models one ``shared`` attention+MLP
block, and for models with a frontend ``frontend_proj`` ([F, D]); a
``moe`` layer's params hold ``moe`` (``router``, the experts' ``wi``,
``wg``, ``wo``, and the shared expert's where the model has one); a
cache is ``{"segments": [...], "pos": [B] int32}`` with mamba2 leaves
``conv: [n_rep,B,K-1,C]`` (bf16) and ``ssm: [n_rep,B,H,P,N]`` (fp32),
mamba1 leaves ``conv: [n_rep,B,K-1,di]`` (bf16) and ``ssm:
[n_rep,B,di,N]`` (fp32), and KV
leaves ``k``, ``v: [n_rep,B,max_seq,KV,hd]`` (bf16) — at the top of a
``dense`` layer's cache, nested under ``attn`` in a ``mamba2+shared``
layer's — or ``[n_rep,B,window,KV,hd]`` rings at the top of a ``local``
layer's (``repro_torch.models.attention``).  A ``hybrid_par`` layer's
cache holds both at its top level: the mamba2 ``conv`` and ``ssm``
leaves (state leaves, into the new cache's slots) beside ``k`` and ``v``
(KV leaves, written in place).  An ``encoder`` layer's cache is empty.
A Python loop over the stacked layers stands in for ``lax.scan``.

Frontends, as in the reference's ``_embed``: an ``audio`` model embeds
precomputed frame features [B, S, F] through ``frontend_proj`` in place
of tokens; a ``vision`` model projects patch features [B, N, F] the same
way and puts them before the token embeddings, so a prompt of T tokens
fills N + T positions.  The entry points take them as ``features=``.

How a call updates the cache: **KV leaves are written in place**, where
the reference returns new arrays; every other leaf (the small conv and
SSM states) is returned as a new tensor and the input's is left as it
was (a Mamba layer's kernels write their new states straight into the
new tensor's slot).  ``kv_bucket`` slices the KV leaves to their first
``kv_bucket`` rows; the slices are views, so the writes land in the full
cache and need no write-back, and the returned cache holds the full
leaves.  A
ring is cut like any other KV leaf; the bucket rule
(``repro_torch.serving.bucketing``) guarantees that a ring cut below its
window has not wrapped.  (The reference's environment switch that keeps
rings whole is not ported: the port reads no environment variable.)  A
caller that reuses a cache it passed in therefore sees the KV
rows the call wrote; stale rows are harmless, since every read is bounded
by the causal mask, the ring's positions or ``valid_len``
(``repro_torch.models.attention``).  A decode step attends
``min(pos + 1, Skv)`` rows of each layer's own extent ``Skv``.

Rope: the tables cover ``max(S, KV rows, rope_len)`` positions, as in the
reference.  ``rope_len`` (the serving layer passes
``repro_torch.serving.bucketing.rope_len_for``) matters where the largest
KV leaf is a window-sized ring and positions run past it.  A model with
sliding windows builds a second, local pair at theta 1e4 for its
``local`` layers.

Entry points:

* :func:`lm_forward` — full-sequence logits with no cache: encoder
  inference, and the training forward (``train=True``, the reference's
  default), which rematerialises each layer unit in the backward when
  ``cfg.remat == "block"`` (``torch.utils.checkpoint``).
* :func:`lm_prefill` — process the prompt, fill the cache.
* :func:`lm_prefill_chunk` — one state-carrying chunk of a chunked
  prefill, with per-row valid ``lengths``.
* :func:`lm_decode_step` — one token for all rows.
* :func:`decode_tokens` — ``n`` steps with the token selected on the
  device (greedy, or sampled at a temperature); the caller reads the
  whole burst with one host transfer.  On the card the serving layer
  runs its greedy bursts as one captured CUDA graph per burst shape
  (``repro_torch.serving.graphs``).

Every entry point takes a sharding plan's knobs as the reference's do:
``kv_repeat`` (attention layers' KV heads repeated for the compute),
``shared_kv_repeat`` (the shared block's) and ``moe_groups`` (the MoE's
dispatch groups); the defaults are the plan-less values.  Under
``plan.activations()`` with params, inputs and cache placed as DTensors
(:mod:`repro_torch.launch.steps`), the same code runs sharded: the
embedding and the logits are constrained to the plan's layouts, each
layer's residual too (:mod:`repro_torch.models.blocks`), the kernels run
on shards (:mod:`repro_torch.kernels.sharded`), a DTensor cache's KV
leaves are written through their gathered value and its state leaves
are copied (never written in place by a kernel).  A DTensor cache takes
no ``kv_bucket``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.core.config import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.scope import scope
from repro_torch.distributed.sharding import (activations, active_plan,
                                              constrain)
from repro_torch.models import blocks
from repro_torch.models.attention import ATTN_KEYS
from repro_torch.models import mamba1, mamba2
from repro_torch.models.mlp import MLP_KEYS
from repro_torch.models.moe import EXPERT_KEYS
from repro_torch.models.norms import rms_norm
from repro_torch.models.params import (ParamDef, init_params, param_axes,
                                       stack_defs, tree_leaves, tree_map)
from repro_torch.models.rope import LOCAL_ROPE_THETA, rope_at, rope_tables

KV_KEYS = ("k", "v")

NEG_INF = -1e30


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# --------------------------------------------------------------------------
# parameter / cache construction
# --------------------------------------------------------------------------

def model_param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    D, V = cfg.d_model, cfg.padded_vocab
    defs: Dict[str, Any] = {
        "embed": ParamDef((V, D), ("vocab", "embed"), fan_in=1, scale=0.02),
        "final_norm": ParamDef((D,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((D, V), ("embed", "vocab"), fan_in=D)
    defs["segments"] = [
        stack_defs(tuple(blocks.layer_param_defs(cfg, kind) for kind in unit),
                   n_rep)
        for unit, n_rep in cfg.segments()]
    if "mamba2+shared" in cfg.layer_kinds:
        defs["shared"] = blocks.shared_block_defs(cfg)
    if cfg.frontend != "none":
        defs["frontend_proj"] = ParamDef((cfg.frontend_feature_dim, D),
                                         (None, "embed"),
                                         fan_in=cfg.frontend_feature_dim)
    return defs


def lm_param_axes(cfg: ModelConfig):
    """Every param leaf's logical axes, in the params' layout."""
    return param_axes(model_param_defs(cfg))


def init_lm_params(cfg: ModelConfig,
                   generator: Optional[torch.Generator] = None, *,
                   dtype: Optional[torch.dtype] = None,
                   device: Optional[Union[str, torch.device]] = None):
    """Random params drawn from the reference's distributions.  ``device``
    None means the card; ``generator`` None means a generator on that
    device seeded with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return init_params(model_param_defs(cfg), generator,
                       dtype or _dtype(cfg.param_dtype), dev)


def _cast_block(block, cd):
    """One layer's (or the shared block's) attention, MLP and expert
    weights in ``cd``; the rest as it was."""
    out = dict(block)
    if "attn" in block:
        out["attn"] = {k: (v.to(cd) if k in ATTN_KEYS else v)
                       for k, v in block["attn"].items()}
    if "mlp" in block:
        out["mlp"] = {k: (v.to(cd) if k in MLP_KEYS else v)
                      for k, v in block["mlp"].items()}
    if "moe" in block:
        out["moe"] = {k: (v.to(cd) if k in EXPERT_KEYS else v)
                      for k, v in block["moe"].items()}
    return out


# per layer kind, the keys of its "mamba" params that are matmul weights
_MAMBA_PROJ_KEYS = {"mamba2": mamba2.PROJ_KEYS,
                    "mamba2+shared": mamba2.PROJ_KEYS,
                    "hybrid_par": mamba2.PROJ_KEYS,
                    "mamba1": mamba1.PROJ_KEYS}


def prepare_params(cfg: ModelConfig, params):
    """Cast the matmul weights (embedding, head, frontend projection, the
    mamba projections of each layer's kind, the attention, MLP and expert
    weights, the shared block's and the shared expert's included) to the
    compute dtype once.  The reference casts them on every use
    (``.astype(dt_)``); casting once gives the same bits and saves
    reading the fp32 weights on every decode step.  Norm scales, conv and
    SSM parameters and the MoE router stay as they are: their consumers
    read them in fp32."""
    cd = _dtype(cfg.compute_dtype)
    out = dict(params)
    out["embed"] = params["embed"].to(cd)
    for key in ("lm_head", "frontend_proj"):
        if key in params:
            out[key] = params[key].to(cd)
    if "shared" in params:
        out["shared"] = _cast_block(params["shared"], cd)
    segs = []
    for (kinds, _), seg in zip(cfg.segments(), params["segments"]):
        unit = []
        for kind, layer in zip(kinds, seg):
            layer = _cast_block(layer, cd)
            if "mamba" in layer:
                keys = _MAMBA_PROJ_KEYS[kind]
                layer["mamba"] = {k: (v.to(cd) if k in keys else v)
                                  for k, v in layer["mamba"].items()}
            unit.append(layer)
        segs.append(tuple(unit))
    out["segments"] = segs
    return out


def init_lm_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
                  dtype: torch.dtype = torch.bfloat16,
                  device: Optional[Union[str, torch.device]] = None):
    """Zero cache in the reference's layout.  ``max_seq`` sizes the KV
    leaves; the mamba2 states do not depend on it."""
    dev = resolve_device(device)
    segs = []
    for unit, n_rep in cfg.segments():
        unit_cache = tuple(
            blocks.init_layer_cache(cfg, kind, batch, max_seq, dtype=dtype,
                                    device=dev)
            for kind in unit)
        segs.append(tree_map(
            lambda t: t.unsqueeze(0).repeat((n_rep,) + (1,) * t.dim()),
            unit_cache))
    return {"segments": segs,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params, tokens: Optional[torch.Tensor],
           features: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings in the compute dtype; an audio model's projected
    frame features [B, S, F] instead, a vision model's projected patch
    features [B, N, F] (where given) before its token embeddings."""
    cd = _dtype(cfg.compute_dtype)
    with scope("embed"):
        if cfg.frontend == "audio":
            if features is None:
                raise ValueError(f"{cfg.name}: an audio model embeds "
                                 "features=, not tokens")
            x = features.to(cd) @ params["frontend_proj"].to(cd)
        else:
            x = params["embed"][tokens.long()].to(cd)
            if cfg.frontend == "vision" and features is not None:
                feats = features.to(cd) @ params["frontend_proj"].to(cd)
                x = torch.cat([feats, x], dim=1)
    return constrain(x, ("batch", "seq", "embed"))


def _head(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    with scope("lm_head"):
        if cfg.tie_embeddings:
            logits = x @ params["embed"].to(x.dtype).T
        else:
            logits = x @ params["lm_head"].to(x.dtype)
        # (a DTensor's partial sums are reduced before the in-place mask)
        logits = constrain(logits, ("batch", "seq", "vocab"))
        if cfg.padded_vocab != cfg.vocab_size:
            pad = (torch.arange(cfg.padded_vocab, device=x.device)
                   >= cfg.vocab_size)
            # in place on the product's own output: no clone (a device
            # copy)
            logits.masked_fill_(pad, NEG_INF)
    return logits


def _rope_for(cfg: ModelConfig, length: int, pos, s: int, device):
    """The model's (sin, cos) at one call's ``s`` token positions
    (:func:`repro_torch.models.rope.rope_at`), from tables covering
    ``length`` positions as the reference's ``_rope_for`` sizes them:
    (global pair, local pair), the local one at ``LOCAL_ROPE_THETA`` when
    the model has a sliding window, else None; (None, None) for a model
    without attention."""
    a = cfg.attn or cfg.shared_attn
    if a is None:
        return None, None
    cd = _dtype(cfg.compute_dtype)
    rope = rope_at(rope_tables(length, a.head_dim, a.rope_theta, device),
                   pos, s, cd)
    local = None
    if cfg.attn is not None and cfg.attn.sliding_window is not None:
        local = rope_at(rope_tables(length, a.head_dim, LOCAL_ROPE_THETA,
                                    device), pos, s, cd)
    return rope, local


def cache_kv_extent(cache) -> Optional[int]:
    """Row extent of the largest KV leaf ([n_rep, B, S, KV, hd]), or None
    without KV leaves.  It sizes the rope tables, as the reference's
    ``_cache_max_seq`` does; that one also counts the 5-D SSM leaf, which
    changes only how positions past the KV extent are clipped (rows of
    retired slots, whose outputs nothing reads)."""
    best = None
    for seg in cache["segments"]:
        for layer in seg:
            for leaf in _kv_leaves(layer):
                best = max(best or 0, int(leaf.shape[2]))
    return best


def _kv_leaves(tree):
    """Every KV leaf of one layer's cache, nested or not."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _kv_leaves(val)
        elif key in KV_KEYS:
            yield val


def _map_cache(fn_kv, fn_state, tree):
    """Rebuild one layer's cache dict: ``fn_kv`` on KV leaves, ``fn_state``
    on the others."""
    return {k: (_map_cache(fn_kv, fn_state, v) if isinstance(v, dict)
                else fn_kv(v) if k in KV_KEYS else fn_state(v))
            for k, v in tree.items()}


def _state_slots(seg, r: int) -> Dict:
    """Repeat ``r``'s slots of one layer's top-level state leaves (not KV)
    in the stacked new cache ``seg``: where its kernels write in place."""
    return {k: v[r] for k, v in seg.items()
            if not isinstance(v, dict) and k not in KV_KEYS}


def _store_state(dst, src, r: int) -> int:
    """Copy layer ``r``'s new state leaves into the stacked ``dst``; KV
    leaves were already written in place, and so was a state leaf that is
    its slot's own storage (a kernel wrote it there).  Returns the number
    of leaves copied."""
    copies = 0
    for key, val in src.items():
        if isinstance(val, dict):
            copies += _store_state(dst[key], val, r)
        elif key not in KV_KEYS:
            slot = dst[key][r]
            if isinstance(slot, DTensor):
                slot.copy_(val.redistribute(slot.device_mesh,
                                            slot.placements))
                copies += 1
            elif not (val.data_ptr() == slot.data_ptr()
                    and val.shape == slot.shape
                    and val.stride() == slot.stride()):
                slot.copy_(val)
                copies += 1
    return copies


def _state_leaves(cache):
    """The cache's state leaves (every leaf but KV; all at a layer's top
    level), in its segments' layout."""
    return [tuple({k: v for k, v in layer.items()
                   if not isinstance(v, dict) and k not in KV_KEYS}
                  for layer in seg)
            for seg in cache["segments"]]


def init_spare_states(cache):
    """One spare set of a cache's state leaves, in :func:`_state_leaves`'s
    layout: a decode burst's steps write their new states into it and the
    cache's own leaves in turn (:func:`decode_tokens`).  Its values are
    never read before they are written."""
    return tree_map(torch.empty_like, _state_leaves(cache))


def _new_layer(layer, out_states: Optional[Dict]):
    """One layer's new cache dict: its KV leaves (written in place), and new
    state leaves, ``out_states``'s where given, else fresh."""
    if out_states is None:
        return _map_cache(lambda t: t, torch.empty_like, layer)
    return {k: (_map_cache(lambda t: t, torch.empty_like, v)
                if isinstance(v, dict)
                else v if k in KV_KEYS else out_states[k])
            for k, v in layer.items()}


def _decode_valid_lens(pos: torch.Tensor):
    """A decode step's attended rows for a KV extent, ``min(pos + 1,
    extent)`` as the reference clamps them per layer; computed once per
    extent for all the layers that share it."""
    memo: Dict[int, torch.Tensor] = {}

    def get(extent: int) -> torch.Tensor:
        if extent not in memo:
            memo[extent] = torch.clamp(pos + 1, max=extent).to(torch.int32)
        return memo[extent]
    return get


def _run_segments(cfg: ModelConfig, params, x: torch.Tensor, *, cache=None,
                  pos=None, chunk_mask=None, chunk_lengths=None,
                  rope=(None, None), kv_bucket=None, valid_lens=None,
                  out_states=None, remat: bool = False, kv_repeat: int = 1,
                  shared_kv_repeat: int = 1, moe_groups: int = 1):
    """Every layer in order.  Each layer gets views of its cache: state
    leaves at its repeat, KV leaves cut to their first ``kv_bucket`` rows
    (None: all), so its KV writes land in the full cache; and its state
    leaves' slots in the new cache, which its kernels may write in place
    (the old cache's state leaves stay as they were).  The new state
    leaves are ``out_states``'s (:func:`init_spare_states`'s layout; apart
    from the cache's) where given, else new tensors.  ``chunk_mask``
    and ``chunk_lengths`` mark a prefill chunk's valid tokens.  ``rope``
    is the (global, local) pair of :func:`_rope_for`; ``valid_lens`` (a
    decode step) maps a layer's KV extent to its attended rows.  ``remat``
    (no cache) runs each unit, one repeat of a segment's layers, under
    ``torch.utils.checkpoint``: its activations are dropped after the
    forward and recomputed in the backward, as the reference's
    ``jax.checkpoint`` of its scanned unit.  ``kv_repeat``,
    ``shared_kv_repeat`` and ``moe_groups`` go to every layer.  Returns
    (x, the new segments: new state leaves, the cache's own KV leaves)."""
    shared = params.get("shared")
    plan = active_plan()
    new_segs = []
    for si, (unit, n_rep) in enumerate(cfg.segments()):
        seg_p = params["segments"][si]
        seg_c = cache["segments"][si] if cache is not None else None
        new_seg = None
        if seg_c is not None:
            dst = (out_states[si] if out_states is not None
                   else (None,) * len(seg_c))
            new_seg = tuple(_new_layer(c, d) for c, d in zip(seg_c, dst))
        def run_unit(x, r, unit=unit, seg_p=seg_p, seg_c=seg_c,
                     new_seg=new_seg):
            for li, kind in enumerate(unit):
                p = tree_map(lambda t: t[r], seg_p[li])
                c = (_map_cache(lambda t: (t[r] if kv_bucket is None
                                           else t[r, :, :kv_bucket]),
                                lambda t: t[r], seg_c[li])
                     if seg_c is not None else None)
                kv = next(_kv_leaves(c), None) if c is not None else None
                x, nc = blocks.apply_layer(
                    cfg, kind, p, x, rope=rope[0], rope_local=rope[1],
                    cache=c, pos=pos, shared=shared, chunk_mask=chunk_mask,
                    chunk_lengths=chunk_lengths,
                    valid_len=(valid_lens(kv.shape[1])
                               if valid_lens is not None and kv is not None
                               else None),
                    slots=(_state_slots(new_seg[li], r)
                           if new_seg is not None else None),
                    kv_repeat=kv_repeat, shared_kv_repeat=shared_kv_repeat,
                    moe_groups=moe_groups)
                if new_seg is not None:
                    _store_state(new_seg[li], nc, r)
            return x

        if remat and plan is not None:
            # the backward's recompute runs outside the caller's context
            def run_unit(x, r, inner=run_unit):
                with activations(plan):
                    return inner(x, r)
        for r in range(n_rep):
            x = (checkpoint(run_unit, x, r, use_reentrant=False) if remat
                 else run_unit(x, r))
        new_segs.append(new_seg)
    return x, new_segs


def _check_kv_bucket(cfg: ModelConfig, kv_bucket: Optional[int],
                     cache=None) -> None:
    if kv_bucket is None:
        return
    if kv_bucket < 1:
        raise ValueError(f"kv_bucket must be >= 1, got {kv_bucket}")
    if "encoder" in cfg.layer_kinds:
        raise ValueError(
            "kv_bucket requires causal KV caches; encoder (bidirectional) "
            "layers cannot be prefix-sliced")
    if cache is not None and any(isinstance(t, DTensor) for t in
                                 tree_leaves(cache["segments"])):
        raise ValueError("kv_bucket slices the KV leaves as views; a "
                         "sharded (DTensor) cache is attended whole")


def _kv_rows(cache, kv_bucket: Optional[int]) -> Optional[int]:
    """Rows of the KV leaves a call attends: their extent, cut to
    ``kv_bucket``; None without KV leaves."""
    ext = cache_kv_extent(cache)
    return ext if ext is None or kv_bucket is None else min(ext, kv_bucket)


def lm_forward(cfg: ModelConfig, params, tokens: Optional[torch.Tensor] = None,
               *, features: Optional[torch.Tensor] = None,
               train: bool = True, kv_repeat: int = 1,
               shared_kv_repeat: int = 1, moe_groups: int = 1
               ) -> torch.Tensor:
    """Full-sequence forward with no cache: logits [B, S, V] of every
    position.  ``tokens`` [B, S], and ``features`` as :func:`_embed` takes
    them (an audio model's frames alone).  ``train`` (the reference's
    default) rematerialises each layer unit in the backward when
    ``cfg.remat == "block"`` and autograd records the call; the values are
    the same either way.  The training loss runs it on the raw params cast
    to the compute dtype (``repro_torch.train.train_step``); encoder
    inference passes ``train=False``."""
    x = _embed(cfg, params, tokens, features)
    s = x.shape[1]
    rope = _rope_for(cfg, s, None, s, x.device)
    remat = train and cfg.remat == "block" and torch.is_grad_enabled()
    x, _ = _run_segments(cfg, params, x, rope=rope, remat=remat,
                         kv_repeat=kv_repeat,
                         shared_kv_repeat=shared_kv_repeat,
                         moe_groups=moe_groups)
    return _head(cfg, params, x)


def lm_prefill(cfg: ModelConfig, params, tokens: torch.Tensor, cache, *,
               features: Optional[torch.Tensor] = None, kv_repeat: int = 1,
               shared_kv_repeat: int = 1, moe_groups: int = 1
               ) -> Tuple[torch.Tensor, Any]:
    """Process the prompt [B,S] (a vision model's ``features`` [B,N,F]
    before it: N + S positions), fill the cache.  Returns (last-token
    logits [B,1,V], cache with ``pos`` at the positions filled)."""
    x = _embed(cfg, params, tokens, features)
    b, seq = x.shape[0], x.shape[1]
    rope = _rope_for(cfg, max(seq, cache_kv_extent(cache) or seq), None, seq,
                     x.device)
    x, new_segs = _run_segments(cfg, params, x, cache=cache, rope=rope,
                                kv_repeat=kv_repeat,
                                shared_kv_repeat=shared_kv_repeat,
                                moe_groups=moe_groups)
    logits = _head(cfg, params, x[:, -1:])
    return logits, {"segments": new_segs,
                    "pos": torch.full((b,), seq, dtype=torch.int32,
                                      device=x.device)}


def lm_prefill_chunk(cfg: ModelConfig, params, tokens: torch.Tensor, cache,
                     *, lengths: Optional[torch.Tensor] = None,
                     kv_bucket: Optional[int] = None,
                     rope_len: Optional[int] = None,
                     with_sentinel: bool = False, kv_repeat: int = 1,
                     shared_kv_repeat: int = 1, moe_groups: int = 1):
    """One state-carrying prefill chunk of ``S`` tokens per row, starting at
    each row's running offset ``cache["pos"]``.  ``lengths`` ([B] int32,
    default all-S) counts each row's valid leading tokens; the rest are
    inert.  Attention writes the chunk's KV at ``pos`` and attends with the
    offset causal mask.  ``kv_bucket`` (None for the whole cache) bounds
    attention to the KV leaves' first ``kv_bucket`` rows; the caller picks
    ``kv_bucket >= max(pos) + S`` capped at the leaves' extent
    (``repro_torch.serving.bucketing``), and the outputs are bit-identical
    to the unbucketed call.  ``rope_len`` (None, or the serving layer's
    ``max_seq``) extends the rope tables past the KV rows.  Returns
    (logits of each row's last valid token [B,1,V], cache with ``pos``
    advanced by ``lengths``).

    ``with_sentinel`` adds the reference's divergence sentinel and returns
    (logits, cache, ok): ``ok`` ([B] bool, on the device) is True where the
    final hidden states of the row's valid tokens and its logits over the
    vocab are all finite; a row with no valid token passes."""
    _check_kv_bucket(cfg, kv_bucket, cache)
    x = _embed(cfg, params, tokens)
    b, s = x.shape[0], x.shape[1]
    pos = cache["pos"].to(torch.int32).expand(b)
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)
    else:
        lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=x.device).expand(b)
    chunk_mask = torch.arange(s, device=x.device)[None, :] < lengths[:, None]
    rope = _rope_for(cfg, max(s, _kv_rows(cache, kv_bucket) or s,
                              rope_len or 0), pos, s, x.device)
    x, new_segs = _run_segments(cfg, params, x, cache=cache, pos=pos,
                                chunk_mask=chunk_mask, chunk_lengths=lengths,
                                rope=rope, kv_bucket=kv_bucket,
                                kv_repeat=kv_repeat,
                                shared_kv_repeat=shared_kv_repeat,
                                moe_groups=moe_groups)
    last = torch.clamp(lengths - 1, 0, s - 1).long()
    x_last = torch.gather(x, 1, last[:, None, None].expand(b, 1, x.shape[2]))
    logits = _head(cfg, params, x_last)
    new_cache = {"segments": new_segs, "pos": pos + lengths}
    if not with_sentinel:
        return logits, new_cache
    ok = torch.where(chunk_mask[:, :, None], torch.isfinite(x),
                     True).all(-1).all(-1)
    ok &= torch.isfinite(logits[:, 0, :cfg.vocab_size]).all(-1)
    ok |= lengths == 0
    return logits, new_cache, ok


def lm_decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache, *,
                   kv_bucket: Optional[int] = None,
                   rope_len: Optional[int] = None, kv_repeat: int = 1,
                   shared_kv_repeat: int = 1, moe_groups: int = 1,
                   _out_states=None) -> Tuple[torch.Tensor, Any]:
    """One token step. token: [B, 1]; ``cache["pos"]`` is a [B] vector.
    ``kv_bucket`` and ``rope_len`` as in :func:`decode_tokens`.
    ``_out_states`` (private; :func:`init_spare_states`'s layout, apart
    from the cache's state leaves) receives the new state leaves."""
    _check_kv_bucket(cfg, kv_bucket, cache)
    pos = cache["pos"]
    x = _embed(cfg, params, token)
    rows = _kv_rows(cache, kv_bucket)
    rope = _rope_for(cfg, max(rows or 1, rope_len or 0), pos, 1, x.device)
    x, new_segs = _run_segments(cfg, params, x, cache=cache, pos=pos,
                                rope=rope, kv_bucket=kv_bucket,
                                valid_lens=_decode_valid_lens(pos),
                                out_states=_out_states, kv_repeat=kv_repeat,
                                shared_kv_repeat=shared_kv_repeat,
                                moe_groups=moe_groups)
    return _head(cfg, params, x), {"segments": new_segs, "pos": pos + 1}


def _check_generator(generator: Optional[torch.Generator],
                     device: torch.device) -> None:
    """A generator on ``device`` (``cuda`` with no index is the current
    card, as ``torch.Generator(device="cuda")`` gives it)."""
    def indexed(d: torch.device) -> torch.device:
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    if generator is None:
        raise ValueError("temperature sampling requires a generator")
    if indexed(generator.device) != indexed(device):
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"cache on {device}")


def _select(lg: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """The next tokens [B, 1] int32 from one step's logits [B, V]: the
    argmax, or with ``temperature > 0`` ``jax.random.categorical``'s
    Gumbel-max draw, ``argmax(lg / T - log(-log(u)))`` with ``u`` uniform
    in fp32 in [tiny, 1) from one ``torch.rand`` on ``generator``."""
    if temperature > 0.0:
        u = torch.rand(lg.shape, generator=generator, device=lg.device,
                       dtype=torch.float32)
        u.clamp_min_(torch.finfo(torch.float32).tiny)
        lg = lg.float() / temperature - torch.log(-torch.log(u))
    return torch.argmax(lg, dim=-1).to(torch.int32)[:, None]


def decode_tokens(cfg: ModelConfig, params, cache, first_token: torch.Tensor,
                  n: int, *, kv_bucket: Optional[int] = None,
                  rope_len: Optional[int] = None, with_sentinel: bool = False,
                  temperature: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  kv_repeat: int = 1, shared_kv_repeat: int = 1,
                  moe_groups: int = 1, _spare_states=None):
    """``n`` decode steps: ``first_token`` ([B,1]) feeds the first step and
    each next input is selected on the device from the step's logits over
    the first ``cfg.vocab_size`` columns, so the burst needs no host
    sync: the argmax (first maximal index), or with ``temperature > 0`` a
    draw from ``softmax(logits / temperature)``.  Returns (tokens [B,n] int32
    on the device, cache); token ``[:, i]`` is the output after consuming
    the (i-1)-th emitted token, exactly as ``n`` sequential
    :func:`lm_decode_step` calls.  ``kv_bucket`` (None for the whole
    cache, else ``>= max(live pos) + n``) bounds the burst's attention to
    the KV leaves' first ``kv_bucket`` rows, bit-identically; a retired
    row whose ``pos`` is past the bucket writes nothing.  ``rope_len``
    (None, or the serving layer's ``max_seq``) extends the rope tables
    past the KV rows.

    Sampling is the reference's ``jax.random.categorical`` with
    ``generator`` (a ``torch.Generator`` on the cache's device) in place of
    its ``rng`` key: ``argmax(logits / temperature + g)`` with Gumbel noise
    ``g = -log(-log(u))``, ``u`` uniform in fp32 from one
    ``torch.rand(..., generator=generator)`` a step, in step order.  The
    generator's stream differs from ``jax.random``'s, so the tokens are
    the same distribution, not the same draws.  ``temperature == 0``
    draws nothing.

    ``with_sentinel`` adds the reference's divergence sentinel: ``ok``
    ([B] bool, on the device) is True where every step's logits over the
    vocab were finite for that row, and the call returns (tokens, cache,
    ok).

    ``_spare_states`` (private; :func:`init_spare_states` of this cache)
    makes the burst update the cache's state leaves where they are: the
    steps write their new states into the spare set and the cache's own
    leaves in turn, so for even ``n`` the last step writes the cache's
    own and no state leaf is copied; for odd ``n`` the spare set is
    copied back once, after the last step.  The input cache's state
    leaves then hold the burst's final states, and a captured graph of
    the burst reads and writes the same buffers on every replay.
    Without it the input cache's state leaves are left as they were."""
    _check_kv_bucket(cfg, kv_bucket, cache)
    if temperature > 0.0:
        _check_generator(generator, tree_leaves(cache["segments"])[0].device)
    own = _state_leaves(cache) if _spare_states is not None else None
    tok = first_token.to(torch.int32)
    ok = (torch.ones((tok.shape[0],), dtype=torch.bool, device=tok.device)
          if with_sentinel else None)
    out = []
    for i in range(n):
        dst = None if own is None else (_spare_states, own)[i % 2]
        logits, cache = lm_decode_step(cfg, params, tok, cache,
                                       kv_bucket=kv_bucket,
                                       rope_len=rope_len,
                                       kv_repeat=kv_repeat,
                                       shared_kv_repeat=shared_kv_repeat,
                                       moe_groups=moe_groups,
                                       _out_states=dst)
        lg = logits[:, 0, :cfg.vocab_size]
        if with_sentinel:
            ok = ok & torch.isfinite(lg).all(-1)
        tok = _select(lg, temperature, generator)
        out.append(tok)
    if own is not None and n % 2:
        for a, s in zip(tree_leaves(own), tree_leaves(_spare_states)):
            a.copy_(s)
        cache = {"segments": [tuple(_new_layer(c, a)
                                    for c, a in zip(seg, seg_a))
                              for seg, seg_a in zip(cache["segments"], own)],
                 "pos": cache["pos"]}
    toks = torch.cat(out, dim=1)
    return (toks, cache, ok) if with_sentinel else (toks, cache)
