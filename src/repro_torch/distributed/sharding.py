"""Logical-axis sharding rules and the per-(arch x workload x mesh) plan.

The port of the reference's ``repro.distributed.sharding``.  The model
code names *logical* axes ("batch", "seq", "heads", "ff", "experts",
...); a :class:`ShardingPlan` maps them to mesh axes for one
(ModelConfig, WorkloadConfig, mesh) cell, deciding between head-sharded
and sequence-sharded attention, the expert-parallel layout, KV-head
replication and ZeRO-1 optimizer sharding.  The rules are the
reference's, rule for rule.

The model code keeps global semantics; only the rules place the tensors.
Where the reference's GSPMD partitions one program, the port runs
``torch.distributed`` DTensors: a tensor placed by the plan (params,
inputs, caches: :mod:`repro_torch.launch.steps`) is a DTensor whose
global shape is the model's, and every torch op on it runs on the
local shards with the collectives DTensor inserts.  :func:`constrain`
is the reference's ``with_sharding_constraint``: inside
:meth:`ShardingPlan.activations` it redistributes a DTensor to the
placements the plan gives its logical axes; outside a plan, or on a
plain tensor, it returns its input.  A hand-written kernel sees only
local tensors: each wrapper's DTensor path
(:mod:`repro_torch.kernels.sharded`) redistributes its inputs to the
placements in which the kernel's work is independent and runs the
kernel on the shards.

A plan needs only the mesh's axis names and sizes: :class:`AbstractMesh`
plans without devices (the reference's tests plan on
``jax.sharding.AbstractMesh``); :meth:`ShardingPlan.placements` turns a
spec into DTensor placements over either kind of mesh, and a real
``torch.distributed.device_mesh.DeviceMesh`` (with ``mesh_dim_names``)
places tensors.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.config import ModelConfig, WorkloadConfig

MeshAxes = Union[None, str, Tuple[str, ...]]

_CTX = threading.local()


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh of axis names and sizes, without devices: enough to plan."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} sizes")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a plan's DeviceMesh needs mesh_dim_names")
    return tuple(names)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} in the mesh's order, for either kind of mesh."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh_axis_names(mesh), tuple(mesh.shape)))


def _axis_size(shape: Dict[str, int], axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(math.prod(shape[a] for a in axes))


def active_plan() -> Optional["ShardingPlan"]:
    """The plan of the innermost :meth:`ShardingPlan.activations`, or
    None."""
    return getattr(_CTX, "plan", None)


def constrain(x, axes: Sequence[Optional[str]]):
    """Redistribute the DTensor ``x`` to the active plan's placements for
    its logical ``axes``; ``x`` itself without a plan or when it is a plain
    tensor."""
    plan = active_plan()
    if plan is None or not isinstance(x, DTensor):
        return x
    want = plan.placements(tuple(axes), x.shape, activation=True)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


@contextlib.contextmanager
def implicit_replication():
    """DTensor's implicit replication, nestable: torch's context manager
    switches it off on exit whatever it was before, so only the outermost
    of nested uses enters it."""
    from torch.distributed.tensor.experimental import (
        implicit_replication as torch_implicit)
    depth = getattr(_CTX, "implicit", 0)
    _CTX.implicit = depth + 1
    try:
        if depth:
            yield
        else:
            with torch_implicit():
                yield
    finally:
        _CTX.implicit = depth


class _Activation:
    """The plan as the active one, and DTensor's implicit replication: a
    plain tensor the model code makes at a global shape (an ``arange``, a
    rope table, a mask) meets DTensors as a replicated one."""

    def __init__(self, plan):
        self.plan = plan
        self.stack: Optional[contextlib.ExitStack] = None

    def __enter__(self):
        self.prev = getattr(_CTX, "plan", None)
        _CTX.plan = self.plan
        self.stack = contextlib.ExitStack()
        self.stack.enter_context(implicit_replication())
        return self.plan

    def __exit__(self, *exc):
        self.stack.close()
        _CTX.plan = self.prev


def activations(plan: Optional["ShardingPlan"]):
    """``plan.activations()``, or a context that does nothing for None."""
    return plan.activations() if plan is not None else contextlib.nullcontext()


class Sharding(NamedTuple):
    """Where a tensor lives: a DeviceMesh and one placement a mesh dim
    (the port's ``NamedSharding``)."""
    mesh: object
    placements: Tuple


@dataclass
class ShardingPlan:
    mesh: object                    # AbstractMesh or DeviceMesh
    param_rules: Dict[str, MeshAxes]
    act_rules: Dict[str, MeshAxes]
    kv_repeat: int = 1
    moe_groups: int = 1
    attn_mode: str = "head"         # "head" | "seq"
    notes: Tuple[str, ...] = ()

    # ---- spec construction -------------------------------------------------
    def spec(self, axes: Sequence[Optional[str]], shape: Sequence[int],
             activation: bool = False) -> Tuple[MeshAxes, ...]:
        """Per tensor dim, the mesh axes it is split over: None, one name,
        or a tuple of names (the reference's ``PartitionSpec`` entries).
        A dim whose axes do not divide it takes the longest prefix that
        does; a mesh axis is never used twice."""
        rules = self.act_rules if activation else self.param_rules
        sizes = mesh_shape(self.mesh)
        used: set = set()
        parts = []
        for dim, name in zip(shape, axes):
            mapped = rules.get(name) if name is not None else None
            if mapped is None:
                parts.append(None)
                continue
            maxes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
            maxes = tuple(a for a in maxes if a not in used)
            size = _axis_size(sizes, maxes)
            if size <= 1 or dim % size != 0:
                # try a prefix of the axes that divides
                while maxes and (dim % _axis_size(sizes, maxes) != 0):
                    maxes = maxes[:-1]
                if not maxes:
                    parts.append(None)
                    continue
            used.update(maxes)
            parts.append(maxes[0] if len(maxes) == 1 else maxes)
        return tuple(parts)

    def placements(self, axes: Sequence[Optional[str]], shape: Sequence[int],
                   activation: bool = False) -> Tuple:
        """The spec as DTensor placements, one a mesh dim: ``Shard(d)``
        where tensor dim ``d`` is split over that mesh axis (on each of
        them where a dim takes two, as ``("pod", "data")`` does), else
        ``Replicate()``."""
        return spec_placements(self.mesh, self.spec(axes, shape, activation))

    def local_shape(self, axes: Sequence[Optional[str]],
                    shape: Sequence[int],
                    activation: bool = False) -> Tuple[int, ...]:
        """A device's shard shape of a tensor of global ``shape``."""
        sizes = mesh_shape(self.mesh)
        spec = self.spec(axes, shape, activation)
        spec = spec + (None,) * (len(shape) - len(spec))
        return tuple(d // _axis_size(sizes, s) for d, s in zip(shape, spec))

    def activations(self) -> _Activation:
        return _Activation(self)

    @property
    def data_size(self) -> int:
        return _axis_size(mesh_shape(self.mesh), self.act_rules.get("batch"))

    @property
    def model_size(self) -> int:
        return _axis_size(mesh_shape(self.mesh), self.param_rules.get("ff"))


def spec_placements(mesh, spec: Sequence[MeshAxes]) -> Tuple:
    """A spec (:meth:`ShardingPlan.spec`) as one placement a mesh dim.  The
    mesh axes of one tensor dim must come in the mesh's order, as DTensor
    splits a dim sharded on two mesh dims major first.  A mesh axis of
    size 1 splits nothing: its placement is ``Replicate()``."""
    names = mesh_axis_names(mesh)
    sizes = mesh_shape(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"mesh axes {group} of dim {d} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def model_kwargs(plan: Optional[ShardingPlan]) -> Dict[str, int]:
    """The model entry points' knobs ``plan`` sets, as the reference's
    step builders pass them; the defaults without a plan."""
    if plan is None:
        return {"kv_repeat": 1, "shared_kv_repeat": 1, "moe_groups": 1}
    return {"kv_repeat": plan.kv_repeat, "shared_kv_repeat": plan.kv_repeat,
            "moe_groups": plan.moe_groups}


def _batch_axes(shape: Dict[str, int], global_batch: int) -> MeshAxes:
    """Pick the largest prefix of (pod, data) that divides the batch."""
    cand = [a for a in ("pod", "data") if a in shape]
    while cand and global_batch % _axis_size(shape, tuple(cand)) != 0:
        cand.pop()
    return tuple(cand) if cand else None


def plan_sharding(cfg: ModelConfig, wl: WorkloadConfig, mesh,
                  microbatches: int = 1,
                  sequence_parallel: bool = False) -> ShardingPlan:
    """The reference's ``plan_sharding``, rule for rule."""
    shape = mesh_shape(mesh)
    model = "model" if "model" in shape else None
    model_size = shape.get("model", 1)
    notes = []

    # ---- attention mode ----------------------------------------------------
    kv_repeat, attn_mode = 1, "head"
    if cfg.attn is not None and model is not None:
        H, KV = cfg.attn.n_heads, cfg.attn.n_kv_heads
        if H % model_size == 0 and model_size % KV == 0:
            kv_repeat = model_size // KV
            attn_mode = "head"
        elif H % model_size == 0 and KV % model_size == 0:
            kv_repeat, attn_mode = 1, "head"
        else:
            attn_mode = "seq"
            notes.append(f"heads ({H}/{KV}) not divisible by model={model_size}: "
                         "sequence-sharded attention")

    batch = _batch_axes(shape, wl.global_batch)
    if batch is None:
        notes.append(f"global_batch={wl.global_batch} < data-parallel size: "
                     "batch replicated (long-context single-stream cell)")

    # sequence sharding: in seq attention mode (or batch-replicated decode),
    # put seq / kv_seq on the model axis (context parallelism)
    seq_axes: MeshAxes = None
    kv_seq_axes: MeshAxes = None
    if attn_mode == "seq":
        seq_axes = model
        kv_seq_axes = model
    # KV caches store exact (unreplicated) kv heads; when those can't shard
    # over the model axis, shard the cache's sequence dim instead
    if (cfg.attn is not None and model is not None
            and cfg.attn.n_kv_heads % model_size != 0):
        kv_seq_axes = model
    if batch is None and cfg.attn is not None:
        # single-stream decode: shard the KV cache over data too
        if attn_mode == "seq":
            kv_seq_axes = ("data", "model") if "data" in shape else model

    heads_axes = model if attn_mode == "head" else None

    fsdp_axes: MeshAxes = None
    if getattr(cfg, "fsdp", False) and "data" in shape:
        fsdp_axes = "data"
        notes.append("FSDP: params' d_model dim sharded over data (ZeRO-3)")

    param_rules: Dict[str, MeshAxes] = {
        "embed": fsdp_axes,
        "layers": None,
        "heads": heads_axes,
        "kv_heads": heads_axes,
        "ff": model,
        "vocab": model,
        "ssm_heads": model,
        "conv_dim": model,
        "ssm_groups": None,
        "dstate": None,
        "experts": ("pod", "data") if "pod" in shape else "data",
        "expert_ff": model,
        "dt_rank": None,
    }
    act_rules: Dict[str, MeshAxes] = {
        "batch": batch,
        "seq": seq_axes,
        "kv_seq": kv_seq_axes,
        "heads": heads_axes,
        "kv_heads": heads_axes,
        "embed": None,
        "ff": model,
        "vocab": model,
        "ssm_heads": model,
        "conv_dim": model,
        # dispatch/combine (token-major) shard experts on the model axis;
        # ex_in/ex_out (expert-major) shard experts on the data axis: the
        # reshard between them is the EP all-to-all.  Capacity rows TP-shard
        "experts": model,
        "experts_ep": ("pod", "data") if "pod" in shape else "data",
        "expert_cap": model,
        "groups": batch,
        "dstate": None,
        # Megatron-style sequence parallelism of the residual stream,
        # enabled by sequence_parallel=True
        "residual_seq": None,
    }

    if attn_mode == "seq":
        # seq-mode archs already live sequence-sharded: the residual
        # constraint must preserve that layout, not pin replication
        act_rules["residual_seq"] = model
    if sequence_parallel and attn_mode == "head" and model is not None:
        act_rules["residual_seq"] = model
        notes.append("sequence-parallel residual stream (RS/AG instead of AR)")

    moe_groups = 1
    if cfg.moe is not None:
        # group size ~4K tokens bounds the [G,Tg,E,C] dispatch working set
        # (GShard sizing); groups stay a multiple of the batch shards
        bsz = _axis_size(shape, batch) if batch else 1
        tokens = wl.tokens // max(microbatches, 1)
        g = max(bsz, tokens // 4096)
        g = min(g, tokens)
        while g > bsz and (tokens % g or g % max(bsz, 1)):
            g -= 1
        moe_groups = max(g, 1)

    return ShardingPlan(mesh=mesh, param_rules=param_rules, act_rules=act_rules,
                        kv_repeat=kv_repeat, moe_groups=moe_groups,
                        attn_mode=attn_mode, notes=tuple(notes))


def zero1_rules(plan: ShardingPlan) -> ShardingPlan:
    """Optimizer-state plan: like params but with 'data' added to the
    replicated logical axes (ZeRO-1 partitioning of m/v)."""
    rules = dict(plan.param_rules)
    rules["embed"] = "data"
    rules["layers"] = None
    return ShardingPlan(mesh=plan.mesh, param_rules=rules,
                        act_rules=plan.act_rules, kv_repeat=plan.kv_repeat,
                        moe_groups=plan.moe_groups, attn_mode=plan.attn_mode,
                        notes=plan.notes + ("zero1",))


# ---------------------------------------------------------------------------
# placing concrete tensors
# ---------------------------------------------------------------------------

def is_sharding(x) -> bool:
    """A leaf of a shardings tree: a :class:`Sharding`, or a (DeviceMesh,
    placements) pair."""
    if isinstance(x, Sharding):
        return True
    return (isinstance(x, tuple) and len(x) == 2
            and not isinstance(x[0], (tuple, list, dict))
            and hasattr(x[0], "mesh_dim_names")
            and isinstance(x[1], (tuple, list)))


def shard_offsets(mesh, placements: Sequence, shape: Sequence[int]
                  ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """This rank's (local shape, global offset) of a tensor of global
    ``shape`` under ``placements``.  Shards are even: a plan's spec only
    splits a dim its axes divide, and :func:`place` checks it."""
    local = list(shape)
    off = [0] * len(shape)
    for i, pl in enumerate(placements):
        if not isinstance(pl, Shard):
            continue
        n = mesh.size(i)
        d = pl.dim
        if local[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"evenly over mesh dim {i} ({n})")
        local[d] //= n
        off[d] += mesh.get_local_rank(i) * local[d]
    return tuple(local), tuple(off)


def local_shard(full: torch.Tensor, mesh, placements: Sequence
                ) -> torch.Tensor:
    """This rank's shard of ``full`` (every rank holds the same value) as
    a view: no communication."""
    local, off = shard_offsets(mesh, placements, full.shape)
    out = full
    for d, (n, o) in enumerate(zip(local, off)):
        if n != full.shape[d]:
            out = out.narrow(d, o, n)
    return out


def place(full: torch.Tensor, sharding) -> DTensor:
    """``full`` (the same value on every rank) as a DTensor by
    ``sharding`` ((mesh, placements)): each rank keeps its own shard, a
    contiguous copy, and nothing is communicated."""
    mesh, placements = sharding
    local = local_shard(full, mesh, placements).contiguous()
    if local.data_ptr() == full.data_ptr():
        local = local.clone()
    return wrap_local(local, mesh, placements, full.shape)


def wrap_local(local: torch.Tensor, mesh, placements: Sequence,
               shape: Sequence[int]) -> DTensor:
    """This rank's shard ``local`` as the DTensor of global ``shape``
    (contiguous) under ``placements``; nothing is communicated."""
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(local, mesh, tuple(placements),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def full_value(x) -> torch.Tensor:
    """The global value of a DTensor (gathered on every rank), or ``x``."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def distribute_tree(tree, shardings):
    """Every leaf of ``tree`` placed by the matching leaf of ``shardings``
    (:func:`place`); a leaf whose sharding is None stays as it is."""
    if is_sharding(shardings):
        return place(tree, shardings)
    if shardings is None:
        return tree
    if isinstance(tree, dict):
        return {k: distribute_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, s)
                          for v, s in zip(tree, shardings))
    raise TypeError(f"no sharding for leaf {type(tree).__name__}")
