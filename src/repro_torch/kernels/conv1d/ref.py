"""Plain PyTorch causal depthwise conv1d (the reference oracle's math).

Used by the CPU path of :mod:`repro_torch.kernels.conv1d.ops`, by the
tests, and as the kernel's comparison on the card.  Taps accumulate in
fp32 in the order ``i = 0 .. K-1`` starting from zero, then the bias,
then SiLU as ``y * sigmoid(y)`` — the reference's order and formula.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd.ref import into


def silu(y: torch.Tensor) -> torch.Tensor:
    return y * torch.sigmoid(y)


def window_at(src: torch.Tensor, lengths: torch.Tensor, k: int
              ) -> torch.Tensor:
    """Rows ``lengths[b] .. lengths[b] + k - 2`` of each row of ``src``
    ([B, K-1+S, C], the old window then the inputs): the conv state after
    a row's first ``lengths[b]`` inputs."""
    b, _, c = src.shape
    rows = lengths.long()[:, None] + torch.arange(k - 1, device=src.device)
    return torch.gather(src, 1, rows[:, :, None].expand(b, k - 1, c))


def causal_conv1d_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      initial_state: Optional[torch.Tensor] = None,
                      activation: str = "silu", *,
                      lengths: Optional[torch.Tensor] = None,
                      out_state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, C]; w: [C, K]; b: [C].  Returns (y [B,S,C], state [B,K-1,C]):
    the state carries the K-1 inputs that end each row's valid prefix
    (``lengths``, None for all S) for streaming decode; ``out_state``,
    when given, receives a copy of it and is returned in its place, as the
    kernel writes its destination."""
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
    state = xp[:, s:, :] if lengths is None else window_at(xp, lengths, k)
    return y.to(x.dtype), into(out_state, state)


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


def causal_conv1d_bwd_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          dy: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of ``causal_conv1d_ref`` with SiLU and no initial state
    (training's case), as ``csrc/conv1d_bwd.cu`` computes it, in fp32:
    dz = dy * silu'(z); dx[s] = sum_i dz[s + K - 1 - i] w_i; dw_i = sum over
    batch and steps of dz[t] x[t - K + 1 + i]; db = sum of dz.  Returns
    (dx in x's dtype, dw [C,K] fp32, db [C] fp32)."""
    bsz, s, c = x.shape
    k = w.shape[-1]
    xp = torch.cat([x.new_zeros((bsz, k - 1, c)), x], dim=1).float()
    wf = w.float()
    z = torch.zeros((bsz, s, c), dtype=torch.float32, device=x.device)
    for i in range(k):
        z = z + xp[:, i:i + s, :] * wf[:, i]
    z = z + b.float()
    sg = torch.sigmoid(z)
    dz = dy.float() * sg * (1.0 + z * (1.0 - sg))
    dzp = torch.cat([dz, dz.new_zeros((bsz, k - 1, c))], dim=1)
    dx = torch.zeros_like(dz)
    for i in range(k):
        dx = dx + dzp[:, k - 1 - i:k - 1 - i + s, :] * wf[:, i]
    dw = torch.stack([(dz * xp[:, i:i + s, :]).sum((0, 1)) for i in range(k)],
                     dim=1)
    return dx.to(x.dtype), dw, dz.sum((0, 1))
