"""Carry weights and state across from the reference package.

``from_jax`` takes a tree of numpy arrays — the caller runs
``jax.tree_util.tree_map(np.asarray, tree)`` on the reference's params or
cache — and returns the same tree (dicts, lists and tuples, same keys) of
tensors on ``device``.  The port never imports JAX; the test does the
``np.asarray``.  bfloat16 leaves (numpy's ``ml_dtypes`` bfloat16, which
torch cannot read) go through float32, which holds every bfloat16 value
exactly, and come back as ``torch.bfloat16``.  ``opt_state_from_jax``
carries an optimizer state (``{"m", "v", "step"}``,
``repro_torch.train.optimizer``'s layout and the reference's) across the
same way, the step as an int32 scalar.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.params import tree_map


def _leaf(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.tensor(arr, device=device)


def from_jax(tree: Any, device: Optional[Union[str, torch.device]] = None):
    """numpy tree (the reference's layout) -> tensor tree on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf(a, dev), tree)


def opt_state_from_jax(state: Any,
                       device: Optional[Union[str, torch.device]] = None):
    """The reference's AdamW state as numpy (``{"m", "v", "step"}``) ->
    the port's on ``device``: the moments as :func:`from_jax` carries
    them, ``step`` an int32 scalar tensor."""
    dev = resolve_device(device)
    return {"m": from_jax(state["m"], dev), "v": from_jax(state["v"], dev),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev)}


def to_numpy(tree: Any):
    """tensor tree -> numpy tree (bfloat16 leaves as float32)."""
    def f(t):
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.detach().cpu().numpy()
    return tree_map(f, tree)
