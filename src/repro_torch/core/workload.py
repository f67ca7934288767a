"""Workload -> model-input specs (``meta`` tensors; never allocates).

The port of the reference's ``repro.core.workload``.  Modality stubs as
in the reference: audio archs take precomputed frame embeddings, vision
archs precomputed patch embeddings beside their tokens.  A spec is a
tensor on the ``meta`` device, of the reference's shape and dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core.config import ModelConfig, WorkloadConfig

VLM_PATCHES = 576          # llava-next: 24x24 patch grid per image
VLM_FEAT_DIM = 1024        # CLIP-L vision features
AUDIO_FEAT_DIM = 512       # wav2vec2/hubert conv-extractor features


def _spec(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, wl: WorkloadConfig
                ) -> Dict[str, torch.Tensor]:
    """Specs of the *model inputs* of the step for this workload.

    train:   full-sequence inputs + labels
    prefill: full-sequence inputs
    decode:  one-token inputs (the cache is built separately)
    """
    b, s = wl.global_batch, wl.seq_len
    tok = torch.int32
    if wl.kind == "decode":
        if cfg.frontend == "audio":
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        return {"tokens": _spec((b, 1), tok)}
    if cfg.frontend == "audio":
        specs = {"features": _spec((b, s, AUDIO_FEAT_DIM), torch.bfloat16)}
        if wl.kind == "train":
            specs["labels"] = _spec((b, s), tok)
        return specs
    if cfg.frontend == "vision":
        specs = {"tokens": _spec((b, s - VLM_PATCHES), tok),
                 "features": _spec((b, VLM_PATCHES, VLM_FEAT_DIM),
                                   torch.bfloat16)}
        if wl.kind == "train":
            specs["labels"] = _spec((b, s), tok)
        return specs
    specs = {"tokens": _spec((b, s), tok)}
    if wl.kind == "train":
        specs["labels"] = _spec((b, s), tok)
    return specs


def realize(specs: Dict[str, torch.Tensor], seed: int = 0, *,
            device: Optional[Union[str, torch.device]] = "cpu"
            ) -> Dict[str, torch.Tensor]:
    """Concrete tensors for the specs, drawn in the specs' order from one
    ``torch.Generator`` seeded with ``seed``: integers uniform in [0, 100),
    floats standard normal (drawn in fp32, then cast)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    out = {}
    for name, sd in specs.items():
        if sd.dtype.is_floating_point:
            t = torch.randn(sd.shape, generator=gen).to(sd.dtype)
        else:
            t = torch.randint(0, 100, sd.shape, generator=gen,
                              dtype=torch.int64).to(sd.dtype)
        out[name] = t.to(device)
    return out


def applicable(cfg: ModelConfig, wl: WorkloadConfig) -> Tuple[bool, str]:
    """Assignment rules: encoder-only archs skip decode; long_500k requires
    sub-quadratic attention."""
    if cfg.family in ("encoder", "audio") and wl.kind == "decode":
        return False, "encoder-only: no decode step"
    if wl.name == "long_500k":
        kinds = set(cfg.layer_kinds)
        full_attn = kinds & {"dense", "moe", "dense_moe", "encoder"}
        sub_quadratic = kinds & {"mamba2", "mamba1", "mamba2+shared", "local"}
        if not sub_quadratic:
            return False, "pure full-attention arch: long_500k skipped"
        if full_attn and "local" not in kinds:
            return False, ("full-attention layers present: long_500k skipped "
                           "(quadratic prefill history)")
        # local:global archs (gemma3) run: decode is linear per step and the
        # global-layer KV cache is sequence-sharded
    return True, ""
