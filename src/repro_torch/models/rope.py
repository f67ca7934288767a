"""Rotary position embeddings.

``rope_tables`` builds fp32 ``(sin, cos)`` tables once per ``(length,
head_dim, theta, device)`` and keeps them: every decode step and prefill
chunk reuses the same tensors instead of rebuilding them.  The cached
tensors are shared by all callers and must not be written to, and are
never evicted: a captured CUDA graph of a decode burst reads them by
address.
``rope_at`` takes one call's rows of them, once for all its layers.
Sliding-window (``local``) layers rotate with their own table at
``LOCAL_ROPE_THETA``, the value the reference's ``_rope_for`` fixes.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.scope import scope

LOCAL_ROPE_THETA = 10_000.0


@functools.lru_cache(maxsize=None)
def _tables(seq_len: int, head_dim: int, theta: float,
            device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=device) / half))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    ang = torch.outer(t, freqs)
    return torch.sin(ang), torch.cos(ang)


def rope_tables(seq_len: int, head_dim: int, theta: float = 10_000.0,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) fp32 tables of shape [seq_len, head_dim//2]."""
    return _tables(int(seq_len), int(head_dim), float(theta),
                   torch.device(device or "cpu"))


def rope_at(tables: Tuple[torch.Tensor, torch.Tensor],
            pos: Optional[torch.Tensor], s: int,
            dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows of ``tables`` at one call's ``s`` token positions, cast to
    ``dtype``: ``[s, half]`` for positions ``0..s-1`` (``pos`` None), else
    ``[B, s, half]`` at ``pos[b] + i``, clipped to the table as in the
    reference (an overrun row stays finite).  A model builds them once per
    call and every attention layer applies them."""
    sin, cos = tables
    if pos is None:
        return sin[:s].to(dtype), cos[:s].to(dtype)
    idx = (pos.long()[:, None] + torch.arange(s, device=pos.device)).clamp(
        0, sin.shape[0] - 1)
    return sin[idx].to(dtype), cos[idx].to(dtype)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, hd]; sin/cos: [S, hd//2] (or [B, S, hd//2] gathered at
    per-row positions).  The tables are cast to ``x.dtype`` before the
    multiply, as in the reference (a no-op for :func:`rope_at`'s)."""
    with scope("rope"):
        half = x.shape[-1] // 2
        x1, x2 = x[..., :half], x[..., half:]
        if sin.dim() == 2:
            s, c = sin[None, :, None, :], cos[None, :, None, :]
        else:
            s, c = sin[:, :, None, :], cos[:, :, None, :]
        s, c = s.to(x.dtype), c.to(x.dtype)
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
