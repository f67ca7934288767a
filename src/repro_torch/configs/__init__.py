"""Configs the port serves, plus ``reduced`` for CPU-sized copies.

Importing this package registers every config with the model registry:
the reference's ten assigned architectures (``ASSIGNED``) and the
paper's own suite (``paper_models``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.config import ModelConfig
from repro_torch.configs.zamba2_2p7b import CONFIG as zamba2_2p7b  # noqa: F401
from repro_torch.configs.hubert_xlarge import CONFIG as hubert_xlarge  # noqa: F401
from repro_torch.configs.qwen3_moe_235b import (  # noqa: F401
    CONFIG as qwen3_moe_235b)
from repro_torch.configs.llama4_maverick import (  # noqa: F401
    CONFIG as llama4_maverick)
from repro_torch.configs.glm4_9b import CONFIG as glm4_9b  # noqa: F401
from repro_torch.configs.llama3_8b import CONFIG as llama3_8b  # noqa: F401
from repro_torch.configs.gemma3_1b import CONFIG as gemma3_1b  # noqa: F401
from repro_torch.configs.smollm_135m import CONFIG as smollm_135m  # noqa: F401
from repro_torch.configs.mamba2_2p7b import CONFIG as mamba2_2p7b  # noqa: F401
from repro_torch.configs.llava_next_mistral_7b import (  # noqa: F401
    CONFIG as llava_next)
from repro_torch.configs.paper_models import (  # noqa: F401
    FALCON_H1_05B as falcon_h1_05b, HYMBA_15B as hymba_15b,
    MAMBA1_130M as mamba_130m)

ASSIGNED = (
    "zamba2-2.7b", "hubert-xlarge", "qwen3-moe-235b-a22b",
    "llama4-maverick-400b-a17b", "glm4-9b", "llama3-8b", "gemma3-1b",
    "smollm-135m", "mamba2-2.7b", "llava-next-mistral-7b",
)


def reduced(cfg: ModelConfig, *, d_model: int = 64, vocab: int = 256,
            n_units: int = 2) -> ModelConfig:
    """Shrink an arch to a CPU-smoke size, preserving family / layer pattern
    / head-grouping structure (same code paths, tiny shapes).  The same
    rule as the reference's ``reduced``, so both sides shrink alike."""
    unit = cfg.layer_pattern
    n_layers = len(unit) * n_units

    def shrink_attn(a):
        if a is None:
            return None
        kv = max(1, min(a.n_kv_heads, 2))
        heads = max(kv, min(a.n_heads, 4))
        heads = (heads // kv) * kv or kv
        return dataclasses.replace(
            a, n_heads=heads, n_kv_heads=kv, head_dim=d_model // 4,
            sliding_window=(8 if a.sliding_window else None),
            dense_cutoff=a.dense_cutoff)

    ssm = cfg.ssm
    if ssm is not None:
        ssm = dataclasses.replace(ssm, d_state=16, headdim=16, chunk=16)
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, n_experts=8,
                                  experts_per_token=min(
                                      moe.experts_per_token, 2),
                                  d_ff_expert=d_model * 2)
    return dataclasses.replace(
        cfg, name=cfg.name + "-reduced", n_layers=n_layers, d_model=d_model,
        d_ff=d_model * 2 if cfg.d_ff else 0, vocab_size=vocab,
        attn=shrink_attn(cfg.attn), ssm=ssm, moe=moe,
        shared_attn=shrink_attn(cfg.shared_attn),
        shared_attn_d_ff=d_model * 2 if cfg.shared_attn_d_ff else 0,
        frontend_feature_dim=32 if cfg.frontend != "none" else 0,
        vocab_pad_multiple=16)
