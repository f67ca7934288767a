"""Plain PyTorch masked softmax attention (the reference oracle's math).

Layout: q [B, H, Sq, d]; k, v [B, KVH, Skv, d] (GQA: H % KVH == 0).  Scores,
probabilities and the P.V product are fp32, as in the reference's
``attention_ref`` and its Pallas kernels; the output is cast to q's dtype.
Used by the CPU path of :mod:`repro_torch.kernels.flash.ops`, by the
tests, and as the kernel's comparison on the card.

Ring-buffer layout (``kv_wrap``, ``ring_len``): the first ``ring_len`` KV
slots are a ring with modulus ``window`` and per-row write cursor
``kv_wrap``; the rest are the in-flight chunk.  :func:`ring_kv_positions`
gives each slot's absolute position; the masks are evaluated against it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def ring_kv_positions(kv_wrap: torch.Tensor, window: int, ring_len: int,
                      skv: int) -> torch.Tensor:
    """Absolute key positions [B, Skv] of a ring+chunk KV layout: slot
    ``j < ring_len`` holds the newest token with ``pos % window == j``
    strictly before the cursor (negative = never written); slot
    ``j >= ring_len`` is chunk token ``kv_wrap + (j - ring_len)``."""
    w = torch.as_tensor(kv_wrap, dtype=torch.int32)
    j = torch.arange(skv, dtype=torch.int32, device=w.device)[None, :]
    w = w.reshape(-1)[:, None]
    ring = w - 1 - torch.remainder(w - 1 - j, window)
    tail = w + (j - ring_len)
    return torch.where(j < ring_len, ring, tail)


def _offsets(q_offset, b: int, device) -> torch.Tensor:
    """Scalar or [B] query offset -> [B] int64."""
    off = torch.as_tensor(q_offset if q_offset is not None else 0,
                          device=device)
    return off.to(torch.int64).reshape(-1).expand(b)


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None, q_offset=0,
                  kv_wrap=None, ring_len: Optional[int] = None
                  ) -> torch.Tensor:
    """``q_offset``: scalar or [B] per-row query-position offset (query i of
    row b sits at absolute position q_offset[b] + i).  ``kv_wrap`` and
    ``ring_len`` select the ring layout; they need ``causal`` and a
    ``window``."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, sq, d).float()
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    qpos = (torch.arange(sq, device=q.device)[None, :]
            + _offsets(q_offset, b, q.device)[:, None])          # [B, Sq]
    if kv_wrap is not None:
        if not (causal and window is not None and ring_len is not None):
            raise ValueError("ring KV layout requires causal attention and "
                             "a window")
        kpos = ring_kv_positions(kv_wrap, window, ring_len, skv).to(
            q.device).long().expand(b, skv)[:, None, :]
        mask = (kpos >= 0).expand(b, sq, skv)
    else:
        kpos = torch.arange(skv, device=q.device)[None, None, :]
        mask = torch.ones((b, sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qpos[:, :, None] >= kpos)
    if window is not None:
        mask = mask & ((qpos[:, :, None] - kpos) < window)
    s = torch.where(mask[:, None, None], s, torch.full((), NEG_INF,
                                                       device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)
