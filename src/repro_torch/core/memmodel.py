"""Analytic inference-memory model + OOM frontier (paper Fig. 5, eqs. 2-3).

The port's copy of the reference's ``core/memmodel.py``, arithmetic on
:class:`~repro_torch.core.config.ModelConfig` only:

  weights      = N_params × p
  KV cache     = B × S × Σ_attn-layers (2 × n_kv × head_dim) × p   (eq. 2, GQA-aware)
  SSM state    = B × Σ_ssm-layers (H×P×N × 4 + conv window)         (constant in S)
  activations  ≈ B × S × D × C × p                                  (eq. 3)

It computes what the reference computes, its two known gaps included
(ROADMAP.md §3): :func:`kv_cache_bytes` and :func:`ssm_state_bytes`
count no ``hybrid_par`` layer, and SSM states are counted at 4 bytes
(``p_state``).  The reference's ``ModelConfig.param_count`` method is
:func:`param_count` here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.config import ModelConfig

# Paper Sec. II-B: "C: number of layers to keep their activations on memory".
DEFAULT_ACT_LAYERS = 2
# Allocator/framework overhead fraction observed with eager HF pipelines.
DEFAULT_OVERHEAD = 0.08


def _layer_params(cfg: ModelConfig, kind: str) -> int:
    D, F = cfg.d_model, cfg.d_ff
    if kind in ("dense", "local", "encoder", "dense_moe"):
        a = cfg.attn
        q, kv = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
        return D * (q + 2 * kv) + q * D + 3 * D * F + 2 * D
    if kind == "moe":
        a, m = cfg.attn, cfg.moe
        q, kv = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
        ff = m.n_experts * 3 * D * m.d_ff_expert + D * m.n_experts
        if m.shared_expert:
            ff += 3 * D * m.d_ff_expert
        return D * (q + 2 * kv) + q * D + ff + 2 * D
    if kind == "hybrid_par":
        a, s = cfg.attn, cfg.ssm
        q, kv = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
        di = s.d_inner(D)
        ng, ns = s.n_groups, s.d_state
        nh = s.n_ssm_heads(D)
        conv_dim = di + 2 * ng * ns
        attn = D * (q + 2 * kv) + q * D
        mamba = (D * (2 * di + 2 * ng * ns + nh) + conv_dim * s.conv_kernel
                 + nh * 3 + di + di * D)
        return attn + mamba + 3 * D * F + 2 * D
    if kind in ("mamba2", "mamba2+shared", "mamba1"):
        s = cfg.ssm
        di = s.d_inner(D)
        if s.variant == "mamba2" or kind.startswith("mamba2"):
            ng, ns = s.n_groups, s.d_state
            nh = s.n_ssm_heads(D)
            conv_dim = di + 2 * ng * ns
            return (D * (2 * di + 2 * ng * ns + nh) + conv_dim * s.conv_kernel
                    + nh * 3 + di + di * D + D)
        dtr = s.dt_rank or max(1, math.ceil(D / 16))
        return (D * 2 * di + di * s.conv_kernel + di
                + di * (dtr + 2 * s.d_state) + dtr * di
                + di * s.d_state + di + di * D + D)
    raise ValueError(f"unknown layer kind {kind!r}")


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (embedding included once if tied)."""
    D, V = cfg.d_model, cfg.vocab_size
    total = V * D
    if not cfg.tie_embeddings:
        total += V * D
    total += D
    for kind in cfg.layer_kinds:
        total += _layer_params(cfg, kind)
    if cfg.shared_attn is not None:
        a = cfg.shared_attn
        q, kv = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
        total += (D * (q + 2 * kv) + q * D + 3 * D * cfg.shared_attn_d_ff
                  + 2 * D)
    return total


def weight_bytes(cfg: ModelConfig, p: int = 2) -> int:
    return param_count(cfg) * p


def kv_cache_bytes(cfg: ModelConfig, batch: int, seq: int, p: int = 2) -> int:
    total = 0
    a = cfg.attn
    for kind in cfg.layer_kinds:
        if kind in ("dense", "moe", "dense_moe", "encoder"):
            total += 2 * batch * seq * a.n_kv_heads * a.head_dim * p
        elif kind == "local":
            # rolling caches always span the full window
            s_eff = a.sliding_window or seq
            total += 2 * batch * s_eff * a.n_kv_heads * a.head_dim * p
        elif kind == "mamba2+shared" and cfg.shared_attn is not None:
            sa = cfg.shared_attn
            total += 2 * batch * seq * sa.n_kv_heads * sa.head_dim * p
    return total


def ssm_state_bytes(cfg: ModelConfig, batch: int, p_state: int = 4,
                    p: int = 2) -> int:
    if cfg.ssm is None:
        return 0
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    total = 0
    for kind in cfg.layer_kinds:
        if kind in ("mamba2", "mamba2+shared"):
            nh = s.n_ssm_heads(cfg.d_model)
            conv_dim = di + 2 * s.n_groups * s.d_state
            total += batch * (nh * s.headdim * s.d_state * p_state
                              + (s.conv_kernel - 1) * conv_dim * p)
        elif kind == "mamba1":
            total += batch * (di * s.d_state * p_state
                              + (s.conv_kernel - 1) * di * p)
    return total


def activation_bytes(cfg: ModelConfig, batch: int, seq: int, p: int = 2,
                     c_layers: int = DEFAULT_ACT_LAYERS,
                     logits_mode: Optional[str] = None,
                     eager_attention: bool = False) -> int:
    """eq. 3 plus full-sequence logits (``"full"``: [B, S, V] at prefill,
    the default for attention-bearing families; ``"last"``: last-token
    logits, the default for pure SSM) and, with ``eager_attention``, the
    [B, H, S, S] fp32 scores and their softmax copy."""
    act = batch * seq * cfg.d_model * c_layers * p
    if logits_mode is None:
        logits_mode = "last" if cfg.family == "ssm" else "full"
    if logits_mode == "full":
        logits = batch * seq * cfg.padded_vocab * p
    else:
        logits = batch * cfg.padded_vocab * 4
    scores = 0
    if eager_attention and cfg.attn is not None:
        scores = 2 * batch * cfg.attn.n_heads * seq * seq * 4
    return act + logits + scores


@dataclass
class MemoryBreakdown:
    weights: int
    kv_cache: int
    ssm_state: int
    activations: int
    overhead: int

    @property
    def total(self) -> int:
        return (self.weights + self.kv_cache + self.ssm_state
                + self.activations + self.overhead)

    def as_dict(self) -> Dict[str, int]:
        return {"weights": self.weights, "kv_cache": self.kv_cache,
                "ssm_state": self.ssm_state, "activations": self.activations,
                "overhead": self.overhead, "total": self.total}


def inference_memory(cfg: ModelConfig, batch: int, seq: int, p: int = 2,
                     overhead_frac: float = DEFAULT_OVERHEAD,
                     logits_mode: Optional[str] = None,
                     eager_attention: bool = False) -> MemoryBreakdown:
    w = weight_bytes(cfg, p)
    kv = kv_cache_bytes(cfg, batch, seq, p)
    ssm = ssm_state_bytes(cfg, batch, p=p)
    act = activation_bytes(cfg, batch, seq, p, logits_mode=logits_mode,
                           eager_attention=eager_attention)
    ovh = int((w + kv + ssm + act) * overhead_frac)
    return MemoryBreakdown(w, kv, ssm, act, ovh)


def max_seq_len(cfg: ModelConfig, capacity_bytes: float, batch: int = 1,
                p: int = 2, hi: int = 1 << 22,
                logits_mode: Optional[str] = None,
                eager_attention: bool = False) -> int:
    """OOM frontier: largest prefill length fitting in ``capacity_bytes``."""
    def fits(s):
        return inference_memory(
            cfg, batch, s, p, logits_mode=logits_mode,
            eager_attention=eager_attention).total <= capacity_bytes
    if not fits(1):
        return 0
    lo, h = 1, hi
    while lo < h:
        mid = (lo + h + 1) // 2
        if fits(mid):
            lo = mid
        else:
            h = mid - 1
    return lo
