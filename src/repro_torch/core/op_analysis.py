"""Static operator costs: per-kernel FLOPs and HBM bytes of one call.

The port's counterpart of the reference's ``core/hlo_analysis.py``
(``KernelCost``, ``CostSummary``, ``analyze_compiled``).  There is no HLO
here: :func:`analyze` runs the function once under a
``TorchDispatchMode`` and turns every aten op that launches work into one
:class:`KernelCost`, classed by :func:`repro_torch.core.classify.classify`
over the scopes open at that op (:mod:`repro_torch.core.scope`):

* products: 2·M·N·K FLOPs (a convolution 2·out·K·C_in/groups; a
  grouped product, the ragged MoE's, 2·rows·N·K: each row meets one
  group's weight);
  elementwise ops and reductions one FLOP per output element; the rest
  none;
* bytes: operands plus results; a gather reads only what it gathers
  (indices plus twice its result), an indexed write moves only its
  update (its operands but the target, plus the update written), a
  ``copy_`` reads its source and writes its target;
* views, allocations and metadata ops cost nothing and are not listed,
  as ``bitcast`` and ``parameter`` in the reference.

The tensors passed in pick the path, as everywhere in the port.  On CPU
tensors the walk runs and counts the plain path (the reference's ``ref``
backend).  On ``meta`` tensors it stands for the card and allocates
nothing: each hand-written kernel wrapper counts as one kernel
(:func:`kernel_cost`: its operands plus results, the kernel's own
operation count, classed by its scope: SSD, conv1d, both decode steps and
the scan ``ssm``, flash and decode attention in ``attn_core`` ``other``),
as a Pallas custom call is one op in the reference, and its plain body is
not walked.  :func:`meta_params` and :func:`meta_like` make full-width
params and caches on ``meta``, so a walk at full size runs on the CPU.

The reference's fused-region summary (``summarize_fused``) has no
counterpart: the port fuses nothing beyond its kernels.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core import scope as _scope
from repro_torch.core.classify import (ARITH_OPS, GEMM_OPS, ZERO_COST_OPS,
                                       base_op, classify, scope_of)


@dataclass
class KernelCost:
    name: str
    opcode: str
    clazz: str
    scope: str
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0     # per-device wire bytes
    count: float = 1.0


@dataclass
class CostSummary:
    kernels: List[KernelCost] = field(default_factory=list)
    # every scope name open at any op of the walk
    scopes: Set[str] = field(default_factory=set)

    @property
    def flops(self) -> float:
        return sum(k.flops * k.count for k in self.kernels)

    @property
    def bytes(self) -> float:
        return sum(k.bytes * k.count for k in self.kernels)

    @property
    def coll_bytes(self) -> float:
        return sum(k.coll_bytes * k.count for k in self.kernels)

    def by_class(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"flops": 0.0, "bytes": 0.0, "coll_bytes": 0.0, "n": 0.0})
        for k in self.kernels:
            c = out[k.clazz]
            c["flops"] += k.flops * k.count
            c["bytes"] += k.bytes * k.count
            c["coll_bytes"] += k.coll_bytes * k.count
            c["n"] += k.count
        return dict(out)

    def by_scope(self, depth: int = 1) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"flops": 0.0, "bytes": 0.0})
        for k in self.kernels:
            c = out[k.scope or "(unscoped)"]
            c["flops"] += k.flops * k.count
            c["bytes"] += k.bytes * k.count
        return dict(out)


# gathers read what they gather; indexed writes move their update only
_GATHER_OPS = frozenset({"index", "gather", "index_select", "embedding",
                         "take"})
_INDEXED_WRITES = frozenset({"index_put", "_index_put_impl", "index_copy",
                             "index_add", "scatter", "scatter_add",
                             "masked_scatter", "slice_scatter",
                             "select_scatter"})


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _gemm_flops(name: str, args: Sequence[Any], outs) -> float:
    out = outs[0]
    if name in ("convolution", "_convolution", "conv1d", "conv2d"):
        w = args[1]
        k = 1
        for d in w.shape[2:]:
            k *= int(d)
        return 2.0 * out.numel() * k * int(w.shape[1])
    # the contracted length: the last dim of the left product operand
    left = {"mm": 0, "bmm": 0, "matmul": 0, "mv": 0, "dot": 0,
            "linear": 0, "_grouped_mm": 0}.get(name, 1)
    a = args[left]
    return 2.0 * out.numel() * int(a.shape[-1])


def op_cost(name: str, args: Sequence[Any], kwargs: Dict[str, Any],
            out) -> Tuple[float, float]:
    """(FLOPs, bytes) of one aten op ``name`` (its in-place underscore
    kept) on ``args`` giving ``out`` (module docstring)."""
    base = base_op(name)
    ins = _tensors((args, kwargs))
    outs = _tensors(out)
    if base in GEMM_OPS:
        flops = _gemm_flops(base, args, outs)
    elif base in ARITH_OPS:
        flops = float(sum(o.numel() for o in outs))
    else:
        flops = 0.0
    if base in _GATHER_OPS:
        byts = sum(map(_nbytes, ins[1:])) + 2 * sum(map(_nbytes, outs))
    elif base in _INDEXED_WRITES:
        rest = ins[1:]
        byts = sum(map(_nbytes, rest)) + max(map(_nbytes, rest), default=0)
    elif name == "copy_":
        byts = _nbytes(ins[0]) + _nbytes(ins[1])
    elif name in ("fill_", "zero_"):
        byts = _nbytes(ins[0])
    else:
        byts = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
    return flops, float(byts)


class _Walk(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.summary = CostSummary()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        path = _scope.current()
        self.summary.scopes.update(path)
        name = func._overloadpacket.__name__
        if func.is_view or name in ZERO_COST_OPS:
            return out
        flops, byts = op_cost(name, args, kwargs, out)
        self.summary.kernels.append(KernelCost(
            name=name, opcode=name, clazz=classify(path, name),
            scope=scope_of(path), flops=flops, bytes=byts))
        return out


_WALKS: List[_Walk] = []


def analyze(fn, *args, **kwargs) -> CostSummary:
    """Run ``fn(*args, **kwargs)`` once and return its
    :class:`CostSummary` (module docstring).  The result of ``fn`` is
    dropped."""
    walk = _Walk()
    _WALKS.append(walk)
    try:
        with _scope.recording(), walk:
            fn(*args, **kwargs)
    finally:
        _WALKS.pop()
    return walk.summary


def kernel_cost(name: str, flops: float, ins: Sequence[Optional[Any]],
                outs: Sequence[torch.Tensor]) -> None:
    """Record one hand-written kernel's launch in the running walk (a
    wrapper's ``meta`` branch calls it; no walk, no record): its bytes are
    its tensor operands plus its results."""
    if not _WALKS:
        return
    path = _scope.current()
    byts = (sum(_nbytes(t) for t in _tensors(list(ins)))
            + sum(_nbytes(t) for t in _tensors(list(outs))))
    _WALKS[-1].summary.kernels.append(KernelCost(
        name=name, opcode="kernel", clazz=classify(path, name),
        scope=scope_of(path), flops=float(flops), bytes=float(byts)))


def meta_like(tree):
    """A tree of ``meta`` tensors of ``tree``'s shapes and types."""
    from repro_torch.models.params import tree_map
    return tree_map(lambda t: torch.empty_like(t, device="meta"), tree)


def meta_params(cfg, dtype: Optional[torch.dtype] = None):
    """``cfg``'s params on ``meta`` as :func:`repro_torch.models.lm.
    prepare_params` gives them (the projections in the compute dtype)."""
    from repro_torch.models.lm import model_param_defs, prepare_params
    from repro_torch.models.params import tree_map
    dt = dtype or getattr(torch, cfg.param_dtype)
    raw = tree_map(lambda d: torch.empty(d.shape, dtype=dt, device="meta"),
                   model_param_defs(cfg))
    return prepare_params(cfg, raw)
