"""Three-term roofline from the static cost summary.

The port's copy of the reference's ``core/roofline.py``, over the port's
:class:`~repro_torch.core.op_analysis.CostSummary` and
:class:`~repro_torch.core.config.HardwareSpec`:

  compute    = HLO_FLOPs(per device)      / peak_FLOP/s
  memory     = HLO_bytes(per device)      / HBM_bw
  collective = wire_bytes(per device)     / (links × link_bw)

The walk (:func:`repro_torch.core.op_analysis.analyze`) counts one
device's program, so all terms are per chip.  ``useful_ratio`` =
MODEL_FLOPS/chips / walked FLOPs (catches redundancy and padding waste).
``hlo_flops`` and ``hlo_bytes`` keep the reference's field names.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core.config import HardwareSpec, ModelConfig, WorkloadConfig
from repro_torch.core.memmodel import active_param_count
from repro_torch.core.op_analysis import CostSummary

# TPU v5e: 4 ICI links per chip in a 2D torus.
DEFAULT_LINKS = 4


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    t_compute: float
    t_memory: float
    t_collective: float
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    model_flops: float
    class_breakdown: Dict[str, Dict[str, float]] = field(default_factory=dict)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Lower-bound step time: perfectly overlapped terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def t_serial(self) -> float:
        """Upper-bound step time: no overlap at all."""
        return self.t_compute + self.t_memory + self.t_collective

    @property
    def useful_ratio(self) -> float:
        per_dev = self.model_flops / max(self.chips, 1)
        return per_dev / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline bound."""
        if self.t_bound <= 0:
            return 0.0
        per_dev = self.model_flops / max(self.chips, 1)
        return per_dev / self.t_bound  # FLOP/s achieved per chip


def model_flops(cfg: ModelConfig, wl: WorkloadConfig) -> float:
    """6·N·D for training, 2·N·D for inference (N_active for MoE)."""
    n = active_param_count(cfg)
    if wl.kind == "train":
        tokens = wl.tokens
        return 6.0 * n * tokens
    if wl.kind == "prefill":
        return 2.0 * n * wl.tokens
    # decode: one token per sequence in the batch
    return 2.0 * n * wl.global_batch


def compute_roofline(cost: CostSummary, hw: HardwareSpec, *, chips: int,
                     arch: str, shape: str, mesh: str,
                     mflops: float, links: int = DEFAULT_LINKS
                     ) -> RooflineReport:
    t_c = cost.flops / hw.peak_flops
    t_m = cost.bytes / hw.hbm_bw
    t_l = (cost.coll_bytes / (links * hw.link_bw)) if hw.link_bw else 0.0
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        t_compute=t_c, t_memory=t_m, t_collective=t_l,
        hlo_flops=cost.flops, hlo_bytes=cost.bytes,
        coll_bytes=cost.coll_bytes, model_flops=mflops,
        class_breakdown=cost.by_class())


def op_class_times(cost: CostSummary, hw: HardwareSpec) -> Dict[str, float]:
    """Per-operator-class modeled latency (paper Figs. 7-9 analog):
    each kernel takes max(compute, memory) on this device; collectives take
    wire time."""
    times: Dict[str, float] = {}
    for k in cost.kernels:
        t = max(k.flops / hw.peak_flops,
                k.bytes / hw.hbm_bw)
        if k.clazz == "collective" and hw.link_bw:
            t = max(t, k.coll_bytes / (DEFAULT_LINKS * hw.link_bw))
        times[k.clazz] = times.get(k.clazz, 0.0) + t * k.count
    return times


def op_scope_times(cost: CostSummary, hw: HardwareSpec) -> Dict[str, float]:
    times: Dict[str, float] = {}
    for k in cost.kernels:
        t = max(k.flops / hw.peak_flops, k.bytes / hw.hbm_bw) * k.count
        times[k.scope or "(unscoped)"] = times.get(k.scope or "(unscoped)", 0.0) + t
    return times
