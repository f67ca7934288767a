"""Model configuration dataclasses (the port's own copy of the reference's).

Field names, defaults and the derived ``padded_vocab`` / ``layer_kinds`` /
``segments`` rules are the reference's, so a config built on either side
describes the same network and the same parameter / cache layout.
``AttnConfig`` describes the attention of every attention layer kind
(``sliding_window`` is the ``local`` layers' window, ``causal`` False
for ``encoder`` layers) and of the shared block of ``mamba2+shared``
layers; ``MoEConfig`` the feed-forward of ``moe`` layers
(``repro_torch.models.moe``: ``impl`` picks the ``gshard`` or the
``ragged`` dispatch).  ``remat`` is the reference's: ``"block"``
rematerialises each layer unit in the backward of a training forward
(``lm_forward(..., train=True)``), ``"none"`` keeps its activations.
``fsdp`` is the reference's sharding knob: under a plan
(:func:`repro_torch.distributed.sharding.plan_sharding`) it shards the
params' ``embed`` dim over the ``data`` mesh axis (ZeRO-3).  The
reference's ``scan_layers`` is not copied: the port loops over its
layers and has no scan to switch.  ``WorkloadConfig`` / ``SHAPES`` and ``HardwareSpec`` / ``HARDWARE``
are the reference's too, with one more device, :data:`H100_SXM`, the card
the port runs on.
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
    remat: str = "block"         # "none" | "block" (remat each layer unit)
    fsdp: bool = False           # params' embed dim sharded over "data"

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


@dataclass(frozen=True)
class WorkloadConfig:
    """One characterization cell: what step is modeled at which shape."""
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int
    gen_len: int = 1     # decode: number of generated tokens modeled
    dtype: str = "bfloat16"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The reference's four canonical shapes.
TRAIN_4K = WorkloadConfig("train_4k", "train", seq_len=4096, global_batch=256)
PREFILL_32K = WorkloadConfig("prefill_32k", "prefill", seq_len=32768,
                             global_batch=32)
DECODE_32K = WorkloadConfig("decode_32k", "decode", seq_len=32768,
                            global_batch=128)
LONG_500K = WorkloadConfig("long_500k", "decode", seq_len=524288,
                           global_batch=1)
SHAPES = {w.name: w for w in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclass(frozen=True)
class HardwareSpec:
    """Per-chip capability used by the roofline and energy models."""
    name: str
    peak_flops: float          # FLOP/s at the benchmark dtype
    hbm_bw: float              # bytes/s
    hbm_bytes: float           # capacity
    link_bw: float = 0.0       # bytes/s per ICI/NVLink link
    power_w: float = 0.0       # sustained board power for the energy model
    idle_w: float = 0.0

    def time_compute(self, flops: float) -> float:
        return flops / self.peak_flops

    def time_memory(self, bytes_: float) -> float:
        return bytes_ / self.hbm_bw


TPU_V5E = HardwareSpec("tpu_v5e", peak_flops=197e12, hbm_bw=819e9,
                       hbm_bytes=16e9, link_bw=50e9, power_w=170.0,
                       idle_w=60.0)
RTX_4090 = HardwareSpec("rtx4090", peak_flops=165e12, hbm_bw=1008e9,
                        hbm_bytes=24e9, link_bw=32e9, power_w=450.0,
                        idle_w=30.0)
JETSON_ORIN_NANO = HardwareSpec("jetson_orin_nano", peak_flops=20e12,
                                hbm_bw=68e9, hbm_bytes=8e9, link_bw=0.0,
                                power_w=15.0, idle_w=5.0)
# NVIDIA H100 SXM (the card "NVIDIA H100 80GB HBM3" at its 700 W power
# limit, as nvidia-smi reports it): dense bf16 tensor-core peak and HBM3
# rate from NVIDIA's data sheet, 80 GB of HBM, one NVLink 4 link's rate in
# one direction (18 links carry 900 GB/s both ways), board power at the
# power limit, and the draw of the idle card (``power.draw``, as
# chip_smoke.py's phase 1 reads it; PERF.md section 2).
H100_SXM = HardwareSpec("h100_sxm", peak_flops=989e12, hbm_bw=3.35e12,
                        hbm_bytes=80e9, link_bw=25e9, power_w=700.0,
                        idle_w=71.22)
HARDWARE = {h.name: h for h in (TPU_V5E, RTX_4090, JETSON_ORIN_NANO,
                                H100_SXM)}
