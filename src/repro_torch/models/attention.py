"""GQA attention sub-block: qkv projection, rope, core, output projection.

The port of the reference's ``repro.models.attention.attention`` for
append-only caches.  Cache modes (``cache`` is ``{"k", "v"}``, each
``[B, Skv, KV, hd]``):

* ``cache=None`` — full-sequence attention (one-shot use), no cache;
* ``pos`` None — one-shot prefill: attend the prompt, write its KV at
  rows ``[0, S)``;
* ``S > 1``, ``pos`` given — chunked prefill at per-row offsets: write the
  chunk's KV at rows ``pos[b] + i`` (rows past ``Skv`` are dropped), then
  attend with the offset causal mask over the whole (bucket-sliced) cache;
* ``S == 1`` — a decode step: write each row's KV at ``pos[b]`` (a row at
  or past ``Skv``, a retired slot, writes nothing), then attend the first
  ``min(pos + 1, Skv)`` rows.

**The cache is updated in place**: the KV leaves passed in are written
and returned, where the reference returns new arrays.  A bucket slice of
the cache is a view, so its writes land in the full cache with no
write-back.  Rows a call does not write keep their old values; stale rows
are never read, because every read is bounded by the causal mask or by
``valid_len``, as in the reference.

The KV projection stays in the ``[B, S, KV, hd]`` layout of the cache; the
kernels read ``transpose(1, 2)`` views of it, so attending a bucket of the
cache copies nothing.  ``kv_repeat`` (a sharding knob of the reference) is
not ported: it is always 1.  Sliding windows (the rolling ring cache and
banded attention) raise.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.config import AttnConfig
from repro_torch.kernels.attn_decode.ops import decode_attention
from repro_torch.kernels.flash.ops import flash_attention
from repro_torch.models.norms import rms_norm
from repro_torch.models.params import ParamDef
from repro_torch.models.rope import apply_rope

# the matmul weights the compute dtype reads (cast once at load)
ATTN_KEYS = ("wq", "wk", "wv", "wo")

WINDOW_NOT_PORTED = ("sliding-window attention is not ported yet; "
                     "ROADMAP.md: the ring mode and local windows item")


def attn_param_defs(d_model: int, a: AttnConfig) -> Dict[str, ParamDef]:
    defs = {
        "wq": ParamDef((d_model, a.n_heads, a.head_dim),
                       ("embed", "heads", None), fan_in=d_model),
        "wk": ParamDef((d_model, a.n_kv_heads, a.head_dim),
                       ("embed", "kv_heads", None), fan_in=d_model),
        "wv": ParamDef((d_model, a.n_kv_heads, a.head_dim),
                       ("embed", "kv_heads", None), fan_in=d_model),
        "wo": ParamDef((a.n_heads, a.head_dim, d_model),
                       ("heads", None, "embed"), init="normal_out",
                       fan_in=a.n_heads * a.head_dim),
    }
    if a.qk_norm:
        defs["q_norm"] = ParamDef((a.head_dim,), (None,), init="zeros")
        defs["k_norm"] = ParamDef((a.head_dim,), (None,), init="zeros")
    return defs


def init_attn_cache(a: AttnConfig, batch: int, max_seq: int, *,
                    window: Optional[int] = None,
                    dtype: torch.dtype = torch.bfloat16,
                    device=None) -> Dict[str, torch.Tensor]:
    """Zero ``{"k", "v"}`` of ``[batch, max_seq, KV, hd]``."""
    if window is not None:
        raise NotImplementedError(WINDOW_NOT_PORTED)
    shape = (batch, max_seq, a.n_kv_heads, a.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B,S,D] x [D,H,hd] -> [B,S,H,hd]."""
    b, s, _ = x.shape
    return (x @ w.to(x.dtype).reshape(w.shape[0], -1)).view(
        b, s, w.shape[1], w.shape[2])


def _write_chunk(full: torch.Tensor, new: torch.Tensor,
                 pos: torch.Tensor) -> None:
    """Write ``new`` [B,S,KV,hd] into ``full`` [B,Skv,KV,hd] at rows
    ``pos[b] + i`` in place, dropping rows at or past ``Skv``.  Each row
    rewrites a window of ``min(S, Skv)`` distinct in-range rows that holds
    every target row — the targets from ``new``, the rest with their own
    values — so the write needs no host sync and no duplicate index."""
    b, s = new.shape[0], new.shape[1]
    skv = full.shape[1]
    w = min(s, skv)
    pos = pos.long()
    start = torch.clamp(pos, max=skv - w).clamp(min=0)
    rows = start[:, None] + torch.arange(w, device=full.device)[None, :]
    src = rows - pos[:, None]                                  # [B, w]
    keep = (src < 0) | (src >= s)
    bi = torch.arange(b, device=full.device)[:, None]
    upd = new[bi, src.clamp(0, s - 1)].to(full.dtype)
    cur = full[bi, rows]
    full[bi, rows] = torch.where(keep[:, :, None, None], cur, upd)


def attention(p: Dict, x: torch.Tensor, a: AttnConfig, *,
              rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
              window: Optional[int] = None,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              pos: Optional[torch.Tensor] = None,
              valid_len: Optional[torch.Tensor] = None,
              eps: float = 1e-6
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full attention sub-block: qkv proj -> rope -> core -> out proj.
    ``rope`` is the (sin, cos) pair at this call's token positions
    (:func:`repro_torch.models.rope.rope_at`: ``pos``'s per-row positions
    when a cache and ``pos`` are given, else ``0..S-1``).  ``valid_len``
    ([B] int32, a decode step only) is ``min(pos + 1, Skv)``, computed
    here when None; a model passes it in, once for all its layers.
    Returns (y [B,S,D], the cache it wrote or None).  A ragged chunk's
    invalid tokens need no mask here (the reference's ``chunk_mask`` gates
    only ring-cache writes): their KV rows are overwritten later or hidden
    by the causal mask and ``valid_len``."""
    if window is not None:
        raise NotImplementedError(WINDOW_NOT_PORTED)
    b, s, _ = x.shape
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if a.qk_norm:
        # the reference's head_rms_norm: rms_norm over head_dim
        q = rms_norm(q, p["q_norm"], eps)
        k = rms_norm(k, p["k_norm"], eps)
    if rope is not None:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)

    if cache is None or pos is None:
        # no cache, or a one-shot prefill that fills rows [0, S)
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=a.causal)
        if cache is not None:
            cache["k"][:, :s] = k.to(cache["k"].dtype)
            cache["v"][:, :s] = v.to(cache["v"].dtype)
    elif s > 1:
        _write_chunk(cache["k"], k, pos)
        _write_chunk(cache["v"], v, pos)
        o = flash_attention(q.transpose(1, 2),
                            cache["k"].to(x.dtype).transpose(1, 2),
                            cache["v"].to(x.dtype).transpose(1, 2),
                            causal=a.causal, q_offset=pos)
    else:
        skv = cache["k"].shape[1]
        slot = pos.long()
        ok = (slot >= 0) & (slot < skv)
        slot = slot.clamp(0, skv - 1)
        bi = torch.arange(b, device=x.device)
        for key, new in (("k", k), ("v", v)):
            full = cache[key]
            full[bi, slot] = torch.where(ok[:, None, None],
                                         new[:, 0].to(full.dtype),
                                         full[bi, slot])
        if valid_len is None:
            valid_len = torch.clamp(pos + 1, max=skv).to(torch.int32)
        o = decode_attention(q[:, 0], cache["k"].to(x.dtype).transpose(1, 2),
                             cache["v"].to(x.dtype).transpose(1, 2),
                             valid_len=valid_len)[:, :, None]  # [B,H,1,hd]
    o = o.transpose(1, 2).reshape(b, s, a.n_heads * a.head_dim)
    y = o @ p["wo"].to(x.dtype).reshape(a.n_heads * a.head_dim, -1)
    return y, cache
