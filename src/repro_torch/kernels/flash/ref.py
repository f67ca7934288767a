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


def full_mask(sq: int, skv: int, causal: bool, window: Optional[int],
              device) -> torch.Tensor:
    """[Sq, Skv] bool: key j seen by query i of a full sequence (query i
    at position i): ``j <= i`` when causal, ``i - j < window`` with a
    window, every key otherwise."""
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (i >= j)
    if window is not None:
        mask = mask & ((i - j) < window)
    return mask


def attention_lse_ref(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None):
    """Attention over a full sequence (query i at position i) as
    ``attention_ref`` computes it, and each query row's log-sum-exp of its
    scaled, masked scores (fp32 [B, H, Sq]): what the forward saves for
    the backward."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, sq, d).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * (1.0 / math.sqrt(d))
    mask = full_mask(sq, skv, causal, window, q.device)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    lse = torch.logsumexp(s, dim=-1).reshape(b, h, sq)
    return o.reshape(b, h, sq, d).to(q.dtype), lse


def flash_bwd_ref(q, k, v, o, do, lse, *, causal: bool = True,
                  window: Optional[int] = None):
    """Backward of attention over a full sequence, as ``csrc/flash_bwd.cu``
    computes it, in fp32: P = exp(scale q.k - lse) under the mask
    (:func:`full_mask`), Dr = rowsum(dO o), dV = P^T dO, dS = P (dO V^T -
    Dr), dQ = scale dS K, dK = scale dS^T Q, dK and dV summed over each KV
    head's query heads.  Returns (dq, dk, dv) in q's dtype."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    qf = q.reshape(b, kvh, g, sq, d).float()
    dof = do.reshape(b, kvh, g, sq, d).float()
    of = o.reshape(b, kvh, g, sq, d).float()
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    mask = full_mask(sq, skv, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse.reshape(b, kvh, g, sq, 1)
                                    .float()), torch.zeros((), device=q.device))
    dr = (dof * of).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dof, vf) - dr)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * scale
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))
