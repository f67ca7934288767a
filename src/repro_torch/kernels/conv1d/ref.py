"""Plain PyTorch causal depthwise conv1d (the reference oracle's math).

Used by the CPU path of :mod:`repro_torch.kernels.conv1d.ops`, by the
tests, and as the kernel's comparison on the card.  Taps accumulate in
fp32 in the order ``i = 0 .. K-1`` starting from zero, then the bias,
then SiLU as ``y * sigmoid(y)`` — the reference's order and formula.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def silu(y: torch.Tensor) -> torch.Tensor:
    return y * torch.sigmoid(y)


def causal_conv1d_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      initial_state: Optional[torch.Tensor] = None,
                      activation: str = "silu"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, C]; w: [C, K]; b: [C].  Returns (y [B,S,C], state [B,K-1,C]):
    the state carries the last K-1 inputs for streaming decode."""
    bsz, s, c = x.shape
    k = w.shape[-1]
    if initial_state is None:
        initial_state = x.new_zeros((bsz, k - 1, c))
    xp = torch.cat([initial_state.to(x.dtype), x], dim=1)
    wf = w.float()
    y = torch.zeros((bsz, s, c), dtype=torch.float32, device=x.device)
    for i in range(k):
        y = y + xp[:, i:i + s, :].float() * wf[:, i]
    y = y + b.float()
    if activation == "silu":
        y = silu(y)
    return y.to(x.dtype), xp[:, s:, :]


def conv1d_decode_ref(state: torch.Tensor, x_t: torch.Tensor,
                      w: torch.Tensor, b: torch.Tensor,
                      activation: str = "silu"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """state: [B, K-1, C]; x_t: [B, C].  Returns (y_t [B,C], new window
    [B,K-1,C] in the promoted dtype of ``state`` and ``x_t``)."""
    dt = torch.promote_types(state.dtype, x_t.dtype)
    window = torch.cat([state.to(dt), x_t[:, None, :].to(dt)], dim=1)
    y = torch.einsum("bkc,ck->bc", window.float(), w.float()) + b.float()
    if activation == "silu":
        y = silu(y)
    return y.to(x_t.dtype), window[:, 1:, :]
