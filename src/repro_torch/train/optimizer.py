"""AdamW over param trees, with gradient clipping and a linear warmup.

The port of the reference's ``repro.train.optimizer``: the same
``OptConfig`` fields and defaults and the same math, in fp32 whatever the
leaves' types (clip by the global norm, the warmup schedule, bias-corrected
moments, weight decay only on leaves of two or more dims, ``m`` and ``v``
kept in ``state_dtype``), in the ``optimizer`` scope.  ``grad_dtype``
(the reference's gradient compression for its data-parallel reduce) is the
type the train step accumulates gradients in.  The reference returns new
trees; :func:`adamw_update` writes the new values into the params and
moments it is given (the trees it returns hold the same tensors), which
keeps one copy of each in device memory.

ZeRO-1: where a param is a DTensor its moments are DTensors placed by
``zero1_rules(plan)`` (``init_opt_state(..., shardings=)``), and the
update runs on each rank's moment shard: the gradient and the param are
taken to the moments' placements (a local cut), the new param shard is
gathered back to the param's own placements.  Each element's arithmetic
is the unsharded one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.scope import scope
from repro_torch.models.params import tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    grad_dtype: str = "bfloat16"     # accumulation type of the gradients
    state_dtype: str = "float32"     # m/v dtype (bf16 halves optimizer memory)


def init_opt_state(params, cfg: OptConfig, shardings=None) -> Dict[str, Any]:
    """Zero moments in ``state_dtype`` beside each leaf, and the step count
    (an int32 scalar on the params' device).  ``shardings`` (a tree of
    ``(mesh, placements)`` matching the params, ``zero1_rules``') makes
    each moment a DTensor of those placements."""
    sd = getattr(torch, cfg.state_dtype)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=sd, device=p.device)  # noqa: E731
    if shardings is None:
        m, v = tree_map(zeros, params), tree_map(zeros, params)
    else:
        from repro_torch.distributed.sharding import place
        from repro_torch.models.params import tree_unflatten
        shs = _sharding_leaves(shardings)
        m = tree_unflatten(params, [place(zeros(p), s)
                                    for p, s in zip(leaves, shs)])
        v = tree_unflatten(params, [place(zeros(p), s)
                                    for p, s in zip(leaves, shs)])
    return {"m": m, "v": v,
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _sharding_leaves(tree):
    from repro_torch.distributed.sharding import is_sharding
    if is_sharding(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _sharding_leaves(v)]
    return [x for v in tree for x in _sharding_leaves(v)]


def _schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1).float() / max(cfg.warmup_steps, 1),
                       max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (fp32)."""
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in tree_leaves(tree)]).sum())


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (params, state, {"grad_norm", "lr"}).  The params'
    and moments' tensors are updated in place (DTensor moments shard by
    shard: ZeRO-1)."""
    if any(isinstance(p, DTensor) for p in tree_leaves(params)):
        from repro_torch.distributed.sharding import implicit_replication
        with implicit_replication():
            return _adamw(params, grads, state, cfg)
    return _adamw(params, grads, state, cfg)


def _adamw(params, grads, state, cfg: OptConfig):
    with scope("optimizer"):
        step = state["step"] + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        lr = _schedule(cfg, state["step"])
        sd = getattr(torch, cfg.state_dtype)
        c1 = 1 - cfg.b1 ** step.float()
        c2 = 1 - cfg.b2 ** step.float()
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            if isinstance(m, DTensor):
                _zero1_leaf(p, g, m, v, scale, lr, c1, c2, cfg, sd)
                continue
            g = g.float() * scale
            m1 = cfg.b1 * m.float() + (1 - cfg.b1) * g
            v1 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
            delta = (m1 / c1) / (torch.sqrt(v1 / c2) + cfg.eps)
            if p.dim() >= 2:   # no decay on norms/scalars/biases
                delta = delta + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(m1.to(sd))
            v.copy_(v1.to(sd))
    return (params, {"m": state["m"], "v": state["v"], "step": step},
            {"grad_norm": gnorm, "lr": lr})


def _zero1_leaf(p, g, m, v, scale, lr, c1, c2, cfg: OptConfig, sd) -> None:
    """One leaf's AdamW on this rank's moment shard: the gradient and the
    param cut to the moments' placements, the new param shard gathered
    back into the param's placements."""
    mesh, zp = m.device_mesh, m.placements
    g = g.redistribute(mesh, zp).float() * scale
    pz = p.redistribute(mesh, zp).float()
    m1 = cfg.b1 * m.float() + (1 - cfg.b1) * g
    v1 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
    delta = (m1 / c1) / (torch.sqrt(v1 / c2) + cfg.eps)
    if p.dim() >= 2:   # no decay on norms/scalars/biases
        delta = delta + cfg.weight_decay * pz
    p.copy_((pz - lr * delta).redistribute(p.device_mesh, p.placements))
    m.copy_(m1.to(sd))
    v.copy_(v1.to(sd))
