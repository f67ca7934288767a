"""Model configuration dataclasses (the port's own copy of the reference's).

Field names, defaults and the derived ``padded_vocab`` / ``layer_kinds`` /
``segments`` rules are the reference's, so a config built on either side
describes the same network and the same parameter / cache layout.
``AttnConfig`` describes the attention of the ``dense`` and ``local``
layers (``sliding_window`` is the local layers' window) and of the
shared block of ``mamba2+shared`` layers; ``MoEConfig`` is kept only
as far as ``ModelConfig`` needs its fields, since no MoE layer is ported
yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None
    causal: bool = True
    impl: str = "auto"
    dense_cutoff: int = 8192
    qk_norm: bool = False


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    variant: str = "mamba2"   # "mamba2" (SSD) | "mamba1" (selective scan)
    headdim: int = 64         # mamba2 head dim (P)
    expand: int = 2
    n_groups: int = 1         # B/C groups (mamba2)
    conv_kernel: int = 4
    chunk: int = 128          # SSD chunk length
    dt_rank: Optional[int] = None

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_ssm_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    experts_per_token: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    interleave_step: int = 1
    shared_expert: bool = False
    router_dtype: str = "float32"
    impl: str = "gshard"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: Optional[AttnConfig] = None
    ssm: Optional[SSMConfig] = None
    moe: Optional[MoEConfig] = None
    layer_pattern: Tuple[str, ...] = ("dense",)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"
    frontend: str = "none"
    frontend_feature_dim: int = 0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256
    shared_attn: Optional[AttnConfig] = None
    shared_attn_d_ff: int = 0

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Full per-layer kind list of length n_layers."""
        reps = math.ceil(self.n_layers / len(self.layer_pattern))
        return (self.layer_pattern * reps)[: self.n_layers]

    def segments(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        """Decompose the layer list into (unit, n_repeat) segments."""
        kinds = self.layer_kinds
        unit = self.layer_pattern
        n_full, rem = divmod(self.n_layers, len(unit))
        segs = []
        if n_full:
            segs.append((unit, n_full))
        if rem:
            segs.append((tuple(kinds[-rem:]), 1))
        return tuple(segs)
