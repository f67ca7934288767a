"""Energy model (paper Fig. 6a analog); the port's copy of the
reference's ``core/energy.py``.

The paper integrates nvidia-smi power over the run.  We model
  E = T_modeled × P_active + T_modeled × P_idle_residual
with T from the per-kernel roofline times (max of compute/memory per
kernel, summed — the no-overlap upper bound matches eager-mode execution,
which is what the paper measured with the HF pipeline).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.config import HardwareSpec
from repro_torch.core.op_analysis import CostSummary
from repro_torch.core.roofline import op_class_times


def modeled_time(cost: CostSummary, hw: HardwareSpec) -> float:
    return sum(op_class_times(cost, hw).values())


def modeled_energy(cost: CostSummary, hw: HardwareSpec) -> float:
    t = modeled_time(cost, hw)
    # compute-heavy kernels draw near peak power; memory-bound ones less.
    times = op_class_times(cost, hw)
    e = 0.0
    for clazz, tc in times.items():
        util = 0.9 if clazz == "gemm" else 0.55
        e += tc * (hw.idle_w + util * (hw.power_w - hw.idle_w))
    return e


def energy_report(cost: CostSummary, hw: HardwareSpec) -> Dict[str, float]:
    return {"time_s": modeled_time(cost, hw),
            "energy_j": modeled_energy(cost, hw)}
