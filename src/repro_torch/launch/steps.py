"""Step builders shared by the dry run, the trainer and the server.

The port of the reference's ``repro.launch.steps``.  Given (ModelConfig,
WorkloadConfig, mesh) a :class:`Cell` is built: the step function, its
argument trees as ``meta`` tensors (the reference's ShapeDtypeStructs:
nothing is allocated), and the placements of every argument and result
from the cell's :class:`~repro_torch.distributed.sharding.ShardingPlan`,
each a :class:`~repro_torch.distributed.sharding.Sharding` (mesh,
placements).  On an abstract mesh a cell is a plan and its shapes; on a
``DeviceMesh``, :func:`place_cell` places concrete trees by the cell's
shardings (DTensors) and ``cell.step`` runs on them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import Replicate

from repro_torch.core.config import ModelConfig, WorkloadConfig
from repro_torch.core.workload import input_specs
from repro_torch.distributed.sharding import (Sharding, ShardingPlan,
                                              distribute_tree, mesh_axis_names,
                                              plan_sharding, zero1_rules)
from repro_torch.models.lm import init_lm_cache, model_param_defs
from repro_torch.models.params import tree_map
from repro_torch.serving.engine import (make_decode_step, make_encode_step,
                                        make_prefill_step)
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step


@dataclass
class Cell:
    cfg: ModelConfig
    wl: WorkloadConfig
    plan: ShardingPlan
    step: Callable
    args: Tuple[Any, ...]            # meta-tensor trees
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    donate: Tuple[int, ...] = ()     # arguments the step updates in place


def _replicated(mesh) -> Sharding:
    return Sharding(mesh, (Replicate(),) * len(mesh_axis_names(mesh)))


def param_sds(cfg: ModelConfig, dtype: Optional[str] = None) -> Any:
    """Every param as a ``meta`` tensor of its shape in ``dtype``
    (default: the config's param dtype)."""
    dt = getattr(torch, dtype or cfg.param_dtype)
    return tree_map(lambda d: torch.empty(d.shape, dtype=dt, device="meta"),
                    model_param_defs(cfg))


def param_specs(cfg: ModelConfig, plan: ShardingPlan,
                rules_plan: Optional[ShardingPlan] = None) -> Any:
    """Every param's spec (:meth:`ShardingPlan.spec`) under ``rules_plan``
    (default: ``plan``), in the params' layout."""
    rp = rules_plan or plan
    return tree_map(lambda d: rp.spec(d.axes, d.shape),
                    model_param_defs(cfg))


def param_shardings(cfg: ModelConfig, plan: ShardingPlan,
                    rules_plan: Optional[ShardingPlan] = None) -> Any:
    """Every param's :class:`Sharding` under ``rules_plan`` (default:
    ``plan``; ``zero1_rules(plan)`` for the optimizer's moments)."""
    rp = rules_plan or plan
    return tree_map(lambda d: Sharding(plan.mesh,
                                       rp.placements(d.axes, d.shape)),
                    model_param_defs(cfg))


_CACHE_AXES = {
    "k": ("layers", "batch", "kv_seq", "kv_heads", None),
    "v": ("layers", "batch", "kv_seq", "kv_heads", None),
    "conv": ("layers", "batch", None, "conv_dim"),
    "ssm": ("layers", "batch", "ssm_heads", None, None),
}


def _cache_map(fn, tree, key=None):
    """``fn(axes or None, leaf)`` over a cache tree: ``axes`` are the
    logical axes of the nearest enclosing key in ``_CACHE_AXES``."""
    if isinstance(tree, dict):
        return {k: _cache_map(fn, v, k if k in _CACHE_AXES else key)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cache_map(fn, v, key) for v in tree)
    return fn(_CACHE_AXES.get(key), tree)


def cache_specs(cache, plan: ShardingPlan) -> Any:
    """Every cache leaf's activation spec; ``pos`` replicated."""
    return _cache_map(lambda axes, leaf: (
        tuple(None for _ in leaf.shape) if axes is None
        else plan.spec(axes, leaf.shape, activation=True)), cache)


def cache_shardings(cache, plan: ShardingPlan) -> Any:
    """Every cache leaf's :class:`Sharding` (the reference's
    ``_CACHE_AXES``: KV leaves over batch, ``kv_seq`` and ``kv_heads``,
    conv states over ``conv_dim``, SSM states over ``ssm_heads``);
    ``pos`` and anything else replicated."""
    return _cache_map(lambda axes, leaf: (
        _replicated(plan.mesh) if axes is None
        else Sharding(plan.mesh, plan.placements(axes, leaf.shape,
                                                 activation=True))), cache)


def input_shardings(cfg: ModelConfig, specs: Dict[str, Any],
                    plan: ShardingPlan) -> Dict[str, Sharding]:
    out = {}
    for name, sd in specs.items():
        axes = ("batch", "seq", None) if name == "features" else ("batch",
                                                                  "seq")
        out[name] = Sharding(plan.mesh, plan.placements(axes, sd.shape,
                                                        activation=True))
    return out


def build_cell(cfg: ModelConfig, wl: WorkloadConfig, mesh, *,
               opt: Optional[OptConfig] = None,
               microbatches: int = 1,
               sequence_parallel: bool = False) -> Cell:
    """The reference's ``build_cell``: a train cell (fp32 master params,
    ZeRO-1 moments, the batch), an encode cell (encoder and audio models'
    prefill), a prefill cell (tokens and the cache) or a decode cell (one
    token against a ``seq_len`` cache).  Inference cells hold the params
    in the compute dtype."""
    if wl.kind != "train":
        microbatches = 1
    plan = plan_sharding(cfg, wl, mesh, microbatches=microbatches,
                         sequence_parallel=sequence_parallel)
    specs = input_specs(cfg, wl)
    in_sh = input_shardings(cfg, specs, plan)
    rep = _replicated(mesh)

    if wl.kind == "train":
        opt = opt or OptConfig()
        psds = param_sds(cfg)                         # fp32 master params
        osds = init_opt_state(psds, opt)
        psh = param_shardings(cfg, plan)
        zplan = zero1_rules(plan)
        osh = {"m": param_shardings(cfg, plan, zplan),
               "v": param_shardings(cfg, plan, zplan), "step": rep}
        step = make_train_step(cfg, opt, plan, microbatches=microbatches)
        metrics_sh = {"loss": rep, "grad_norm": rep, "lr": rep}
        return Cell(cfg, wl, plan, step, args=(psds, osds, specs),
                    in_shardings=(psh, osh, in_sh),
                    out_shardings=(psh, osh, metrics_sh), donate=(0, 1))

    psds = param_sds(cfg, dtype=cfg.compute_dtype)
    psh = param_shardings(cfg, plan)
    logits_sh = Sharding(mesh, plan.placements(
        ("batch", "seq", "vocab"), (1, 1, cfg.padded_vocab), activation=True))

    if wl.kind == "prefill" and cfg.family in ("encoder", "audio"):
        dev = getattr(mesh, "device_type", "meta")
        step = make_encode_step(cfg, plan, device=dev)
        return Cell(cfg, wl, plan, step, args=(psds, specs),
                    in_shardings=(psh, in_sh), out_shardings=logits_sh)

    csds = init_lm_cache(cfg, wl.global_batch, wl.seq_len, device="meta")
    csh = cache_shardings(csds, plan)
    if wl.kind == "prefill":
        return Cell(cfg, wl, plan, make_prefill_step(cfg, plan),
                    args=(psds, specs, csds), in_shardings=(psh, in_sh, csh),
                    out_shardings=(logits_sh, csh), donate=(2,))

    # decode: one token against a seq_len cache
    tok_sh = Sharding(mesh, plan.placements(
        ("batch", None), specs["tokens"].shape, activation=True))
    return Cell(cfg, wl, plan, make_decode_step(cfg, plan),
                args=(psds, specs["tokens"], csds),
                in_shardings=(psh, tok_sh, csh),
                out_shardings=(logits_sh, csh), donate=(2,))


def place_cell(cell: Cell, *trees) -> Tuple[Any, ...]:
    """Concrete trees for the cell's arguments (every rank holding the
    same values) placed by ``cell.in_shardings``, in order: each leaf a
    DTensor holding this rank's shard (``sharding.place``: nothing is
    communicated).  The port's stand-in for the reference's
    ``lower_cell``: torch has no ahead-of-time partitioner to lower to,
    so a cell is run by placing its inputs and calling ``cell.step``.
    Needs the plan's mesh to be a ``DeviceMesh``."""
    if not hasattr(cell.plan.mesh, "mesh_dim_names"):
        raise ValueError("place_cell needs a cell built on a DeviceMesh")
    if len(trees) > len(cell.in_shardings):
        raise ValueError(f"{len(trees)} trees for {len(cell.in_shardings)} "
                         "arguments")
    return tuple(distribute_tree(t, s)
                 for t, s in zip(trees, cell.in_shardings))
