"""Collective-communication helpers and their wire-cost models.

The port of the reference's ``repro.distributed.collectives``: (a)
:func:`tp_matmul_rs`, a tensor-parallel product whose result is
constrained to the sequence-sharded layout, so its partial sums leave as
a reduce-scatter (DTensor's ``Partial`` -> ``Shard`` redistribution)
instead of an all-reduce; (b) the analytic ring-algorithm wire costs the
roofline reads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import constrain


def tp_matmul_rs(x: torch.Tensor, w: torch.Tensor,
                 out_axes: Sequence[Optional[str]]) -> torch.Tensor:
    """x: [B, S, K/tp] (contracted dim sharded); w: [K/tp, M].  The
    product constrained to ``out_axes``."""
    y = torch.einsum("bsk,km->bsm", x, w)
    return constrain(y, tuple(out_axes))


@dataclass(frozen=True)
class WireCost:
    """Ring-algorithm wire bytes per device for a collective over n ranks."""
    n: int
    link_bw: float = 50e9
    links: int = 4

    def all_reduce(self, nbytes: float) -> float:
        return 2.0 * nbytes * (self.n - 1) / self.n

    def all_gather(self, out_bytes: float) -> float:
        return out_bytes * (self.n - 1) / self.n

    def reduce_scatter(self, in_bytes: float) -> float:
        return in_bytes * (self.n - 1) / self.n

    def all_to_all(self, in_bytes: float) -> float:
        return in_bytes * (self.n - 1) / self.n

    def time(self, wire_bytes: float) -> float:
        return wire_bytes / (self.links * self.link_bw)


def overlap_headroom(t_compute: float, t_collective: float) -> float:
    """Fraction of the collective time hidable behind compute: 1.0 = fully
    hidden."""
    if t_collective <= 0:
        return 1.0
    return min(1.0, t_compute / t_collective)


def grad_reduce_dtype_saving(param_bytes_f32: float, n_data: int,
                             compressed: bool = True) -> Tuple[float, float]:
    """Wire bytes of the DP gradient reduce-scatter with/without bf16
    gradient compression (the OptConfig.grad_dtype knob)."""
    wc = WireCost(n_data)
    full = wc.reduce_scatter(param_bytes_f32)
    comp = wc.reduce_scatter(param_bytes_f32 / 2)
    return full, comp if compressed else full
