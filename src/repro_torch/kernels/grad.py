"""Which kernel calls take part in a gradient.

A wrapper whose inputs need a gradient (grad mode on and one input with
``requires_grad``) runs its ``torch.autograd.Function`` where the port has
a backward kernel, on the card and on the CPU alike (the CPU's forward
and backward are the plain versions):

* flash attention over a full sequence (no offsets or ring, Sq = Skv):
  causal, causal in a sliding window, or non-causal (``FlashFn``);
* the SSD scan without an initial state (``SSDFn``);
* conv1d without a state or valid lengths (``Conv1dFn``);
* the Mamba-1 selective scan from a zero initial state, without a
  destination (``ScanFn``).

On the card every other such call raises: flash attention's ring and
offset modes (chunked serving), the decode kernels, and SSD, conv1d and
the selective scan from a state.  The kernel writes through ``ctypes``
into a fresh tensor, which autograd cannot see through, so running it
would leave every input without a gradient and say nothing.  Under
``torch.no_grad`` or ``torch.inference_mode``, or with no input that
needs a gradient, every wrapper launches its kernel as before.  The MoE
layers have no kernel of their own: autograd differentiates their torch
ops (:mod:`repro_torch.models.moe`).
"""
from __future__ import annotations

import torch


def needs_grad(*tensors) -> bool:
    """Whether a call on ``tensors`` (None entries ignored) is recorded for
    a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def no_backward(kernel: str, what: str) -> NotImplementedError:
    """The error of a kernel call on the card that needs a gradient the
    port has no backward kernel for yet."""
    return NotImplementedError(
        f"{kernel}: no backward kernel for {what} yet; training through it "
        "on the card waits for a later slice of the port")
