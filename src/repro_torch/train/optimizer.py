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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

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


def init_opt_state(params, cfg: OptConfig) -> Dict[str, Any]:
    """Zero moments in ``state_dtype`` beside each leaf, and the step count
    (an int32 scalar on the params' device)."""
    sd = getattr(torch, cfg.state_dtype)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda p: torch.zeros(p.shape, dtype=sd, device=p.device)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


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
    and moments' tensors are updated in place."""
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
