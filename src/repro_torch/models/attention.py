"""GQA attention sub-block: qkv projection, rope, core, output projection.

The port of the reference's ``repro.models.attention.attention``.  Cache
modes (``cache`` is ``{"k", "v"}``, each ``[B, Skv, KV, hd]``):

* ``cache=None`` — full-sequence attention (one-shot use), no cache;
* ``pos`` None — one-shot prefill: attend the prompt, then write its KV at
  rows ``[0, S)``, or, into a rolling ring, the last ``window`` tokens
  rolled so that slot ``i`` holds the token with ``position % window ==
  i`` (a prompt shorter than the window is padded with zeros);
* ``S > 1``, ``pos`` given — chunked prefill at per-row offsets: write the
  chunk's KV at rows ``pos[b] + i`` (rows past ``Skv`` are dropped), then
  attend with the offset causal mask over the whole (bucket-sliced) cache;
* ``S > 1``, ``pos`` and ``window`` given, ``Skv <= window`` — chunked
  prefill over a ring (below);
* ``S == 1`` — a decode step: write each row's KV at ``pos[b]``, or at
  ``pos[b] % window`` on a full-window ring (a row whose slot is at or
  past ``Skv``, a retired slot, writes nothing), then attend the first
  ``min(pos + 1, Skv)`` rows.

**Rolling sliding-window caches** are rings of ``window`` slots: slot
``i`` holds the newest token with ``position % window == i``
(:func:`init_attn_cache` allocates the full window even when ``max_seq``
is smaller).  A bucket may slice a ring to ``ring_len < window`` rows
while its cursor has not wrapped.  A chunk attends ``[ring | chunk]``:
the old ring rows followed by the chunk's own K and V, with the ring
cursor ``kv_wrap = pos`` (``repro_torch.kernels.flash``'s ring layout).
**Only then** is the chunk folded into the ring, in place, by the
reference's deterministic gather: slot ``j`` takes the last valid token
``i`` of the chunk (``chunk_mask``) with ``(pos + i) % window == j``, or
keeps its row.  Writing first would overwrite history the chunk must
still see; a chunk longer than the window wraps inside itself, and the
gather keeps the last token of each slot.

**The cache is updated in place**: the KV leaves passed in are written
and returned, where the reference returns new arrays.  A bucket slice of
the cache is a view, so its writes land in the full cache with no
write-back.  Rows a call does not write keep their old values; stale rows
are never read, because every read is bounded by the causal mask, the
ring's positions or ``valid_len``, as in the reference.

The KV projection stays in the ``[B, S, KV, hd]`` layout of the cache; the
kernels read ``transpose(1, 2)`` views of it, so attending a bucket of the
cache copies nothing (a ring chunk copies the ring once, into
``[ring | chunk]``).  ``kv_repeat`` (a sharding knob of the reference) is
not ported: it is always 1.  The reference's ``_local_banded_attention``
(its ``ref``-backend lowering of a long windowed prompt) is not ported:
the flash kernel's window mode, and on the CPU ``attention_ref`` with a
``window``, compute the same function.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.config import AttnConfig
from repro_torch.core.scope import scope
from repro_torch.kernels.attn_decode.ops import decode_attention
from repro_torch.kernels.flash.ops import flash_attention
from repro_torch.models.norms import rms_norm
from repro_torch.models.params import ParamDef
from repro_torch.models.rope import apply_rope

# the matmul weights the compute dtype reads (cast once at load)
ATTN_KEYS = ("wq", "wk", "wv", "wo")


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
    """Zero ``{"k", "v"}`` of ``[batch, max_seq, KV, hd]``, or of
    ``[batch, window, KV, hd]`` for a rolling ring: the full window even
    when ``max_seq`` is smaller, since the ring invariant needs every
    slot."""
    rows = window if window is not None else max_seq
    shape = (batch, rows, a.n_kv_heads, a.head_dim)
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


def _ring_write(ring: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                lens: torch.Tensor, window: int) -> None:
    """Fold a chunk ``new`` [B,S,KV,hd] at positions ``pos[b] + i`` into
    ``ring`` [B,R,KV,hd] in place: slot ``j`` takes the last valid token
    (``i < lens[b]``) with ``(pos + i) % window == j``, or keeps its row.
    A gather over the slots, so a chunk longer than the window needs no
    duplicate index and the write needs no host sync."""
    b, s = new.shape[0], new.shape[1]
    slot = torch.arange(ring.shape[1], device=ring.device)
    t = torch.remainder(pos.long()[:, None] + lens.long()[:, None] - 1
                        - slot[None, :], window)
    i = lens.long()[:, None] - 1 - t                 # newest source, [B, R]
    bi = torch.arange(b, device=ring.device)[:, None]
    src = new[bi, i.clamp(0, s - 1)].to(ring.dtype)
    ring.copy_(torch.where((i >= 0)[:, :, None, None], src, ring))


def _roll_into_ring(ring: torch.Tensor, new: torch.Tensor,
                    window: int) -> None:
    """One-shot prefill of a full-window ring: the last ``window`` of the
    ``S`` tokens rolled so that slot ``i`` holds position ``i`` mod
    ``window``, or the prompt padded with zeros when it is shorter."""
    s = new.shape[1]
    if s >= window:
        rows = torch.roll(new[:, -window:], (s - window) % window, dims=1)
    else:
        rows = torch.nn.functional.pad(new, (0, 0, 0, 0, 0, window - s))
    ring.copy_(rows.to(ring.dtype))


def attention(p: Dict, x: torch.Tensor, a: AttnConfig, *,
              rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
              window: Optional[int] = None,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              pos: Optional[torch.Tensor] = None,
              valid_len: Optional[torch.Tensor] = None,
              chunk_mask: Optional[torch.Tensor] = None,
              eps: float = 1e-6
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full attention sub-block: qkv proj -> rope -> core -> out proj.
    ``rope`` is the (sin, cos) pair at this call's token positions
    (:func:`repro_torch.models.rope.rope_at`: ``pos``'s per-row positions
    when a cache and ``pos`` are given, else ``0..S-1``).  ``window`` is a
    ``local`` layer's sliding window.  ``valid_len`` ([B] int32, a decode
    step only) is ``min(pos + 1, Skv)`` for this layer's ``Skv``, computed
    here when None; a model passes it in, once for all its layers of one
    extent.  ``chunk_mask`` ([B, S] bool, chunked prefill) marks each
    row's valid tokens; it gates the ring writes, since an invalid token
    must never overwrite live ring history.  Append-only caches need no
    mask: an invalid token's KV row is overwritten later or hidden by the
    causal mask and ``valid_len``.  Returns (y [B,S,D], the cache it wrote
    or None)."""
    b, s, _ = x.shape
    with scope("qkv_proj"):
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
        # no cache, or a one-shot prefill
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=a.causal,
                            window=window)
        if cache is not None and window is not None and (
                cache["k"].shape[1] == window):
            _roll_into_ring(cache["k"], k, window)
            _roll_into_ring(cache["v"], v, window)
        elif cache is not None:
            cache["k"][:, :s] = k.to(cache["k"].dtype)
            cache["v"][:, :s] = v.to(cache["v"].dtype)
    elif s > 1 and window is not None and cache["k"].shape[1] <= window:
        # a chunk over a ring: attend [ring | chunk], then fold the chunk in
        ring_len = cache["k"].shape[1]
        kcat = torch.cat([cache["k"].to(k.dtype), k], dim=1)
        vcat = torch.cat([cache["v"].to(v.dtype), v], dim=1)
        o = flash_attention(q.transpose(1, 2), kcat.transpose(1, 2),
                            vcat.transpose(1, 2), causal=a.causal,
                            window=window, q_offset=pos, kv_wrap=pos,
                            ring_len=ring_len)
        lens = (chunk_mask.sum(1) if chunk_mask is not None
                else torch.full((b,), s, device=x.device))
        _ring_write(cache["k"], k, pos, lens, window)
        _ring_write(cache["v"], v, pos, lens, window)
    elif s > 1:
        _write_chunk(cache["k"], k, pos)
        _write_chunk(cache["v"], v, pos)
        o = flash_attention(q.transpose(1, 2),
                            cache["k"].to(x.dtype).transpose(1, 2),
                            cache["v"].to(x.dtype).transpose(1, 2),
                            causal=a.causal, window=window, q_offset=pos)
    else:
        skv = cache["k"].shape[1]
        slot = pos.long()
        if window is not None and skv == window:
            slot = torch.remainder(slot, skv)     # a full-window ring
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
    with scope("o_proj"):
        y = o @ p["wo"].to(x.dtype).reshape(a.n_heads * a.head_dim, -1)
    return y, cache
