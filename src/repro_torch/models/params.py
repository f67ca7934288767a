"""Parameter definition / initialization utilities.

Params are plain nested dicts (and lists / tuples) of tensors, laid out
exactly like the reference's pytrees.  Structure is described by a parallel
tree of :class:`ParamDef`; :func:`init_params` draws every leaf from the
same distribution as the reference's initializer.  The numbers differ (a
``torch.Generator`` is not ``jax.random``); tests that need both sides to
hold the same weights convert the reference's tree with
:func:`repro_torch.convert.from_jax`.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names (documentation)
    init: str = "normal"              # normal | zeros | ones | a_log | dt_bias | normal_out
    fan_in: Optional[int] = None      # override fan-in for "normal"
    scale: float = 1.0


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of a dict / list / tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, ParamDef):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, ParamDef):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """``leaves`` (in :func:`tree_leaves` order) in the layout of
    ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def cast_tree(params, dtype: torch.dtype):
    """Every floating-point leaf in ``dtype``, the rest as they are: the
    training loss casts the fp32 masters to the compute dtype once a step,
    so their gradients land on the fp32 leaves (the reference's
    ``cast_tree``)."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    params)


def param_axes(defs):
    """The logical axes of every leaf of a ParamDef tree."""
    return tree_map(lambda d: d.axes, defs)


def stack_defs(defs, n: int, axis_name: str = "layers"):
    """Add a leading stacked-layers dim to every ParamDef in the tree."""
    return tree_map(lambda d: ParamDef((n,) + d.shape, (axis_name,) + d.axes,
                                       d.init, d.fan_in, d.scale), defs)


# a normal leaf of more elements than this (8 GiB in fp32: the stacked
# experts of a MoE model) is drawn piece by piece along its leading axes
# into its own dtype, so the fp32 draw never holds more than this; every
# smaller leaf is one draw, as before
DRAW_LIMIT = 1 << 31


def _normal_into(out: torch.Tensor, gen: torch.Generator,
                 std: float) -> None:
    if out.numel() <= DRAW_LIMIT:
        out.copy_(torch.randn(out.shape, generator=gen, dtype=torch.float32,
                              device=out.device) * std)
        return
    for piece in out:
        _normal_into(piece, gen, std)


def _init_leaf(d: ParamDef, gen: torch.Generator, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    f32 = dict(dtype=torch.float32, device=device)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "a_log":
        # Mamba: A uniform in [1, 16], stored as log.
        u = torch.rand(d.shape, generator=gen, **f32) * 15.0 + 1.0
        return torch.log(u).to(dtype)
    if d.init == "dt_bias":
        # Inverse softplus of dt ~ LogUniform[1e-3, 1e-1].
        u = torch.rand(d.shape, generator=gen, **f32)
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    if d.init in ("normal", "normal_out"):
        fan_in = d.fan_in
        if fan_in is None:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / math.sqrt(max(fan_in, 1))
        if d.init == "normal_out":
            std = std / 2.0
        if math.prod(d.shape) > DRAW_LIMIT:
            out = torch.empty(d.shape, dtype=dtype, device=device)
            _normal_into(out, gen, std)
            return out
        return (torch.randn(d.shape, generator=gen, **f32) * std).to(dtype)
    raise ValueError(f"unknown init {d.init!r}")


def init_params(defs, generator: torch.Generator, dtype: torch.dtype,
                device: torch.device) -> Any:
    """Initialize a param tree from its defs, drawing leaves in tree order
    from ``generator`` (which must live on ``device``)."""
    return tree_map(lambda d: _init_leaf(d, generator, dtype, device), defs)
