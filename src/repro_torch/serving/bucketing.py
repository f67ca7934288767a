"""Static KV bucketing: bound attention reads to the live prefix.

The port's copy of the reference's ladder rules.  Before a chunk or decode
burst the caller picks the smallest power-of-two KV extent covering
``max(pos) + chunk``, capped at the model's largest KV-cache extent.  The
ported kinds that hold KV caches are ``dense`` layers, the attention
half of ``hybrid_par`` (Falcon-H1, Hymba) layers, the shared attention of
``mamba2+shared`` (Zamba2) layers and the ``window``-slot rings of
``local`` layers; a model with none (pure SSM stacks such as mamba2)
gets ``None``: no bucketing.  A ring cut to a bucket below its
window has not wrapped: the bucket covers ``max(pos) + chunk``.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core.config import ModelConfig

# Smallest rung: below this, slicing saves nothing.
MIN_BUCKET = 128


def bucket_ladder(max_seq: int, min_bucket: int = MIN_BUCKET) -> Tuple[int, ...]:
    """Power-of-two rungs ``min_bucket, 2*min_bucket, ... < max_seq`` plus
    ``max_seq`` itself as the top rung."""
    if max_seq <= 0:
        raise ValueError(f"max_seq must be positive, got {max_seq}")
    rungs = []
    b = min_bucket
    while b < max_seq:
        rungs.append(b)
        b *= 2
    rungs.append(max_seq)
    return tuple(rungs)


def select_kv_bucket(needed: int, max_seq: int,
                     min_bucket: int = MIN_BUCKET) -> int:
    """Smallest rung >= ``needed``; ``needed == rung`` returns that rung."""
    if needed > max_seq:
        raise ValueError(
            f"needed KV extent {needed} exceeds max_seq {max_seq}")
    for b in bucket_ladder(max_seq, min_bucket):
        if b >= needed:
            return b
    return max_seq  # pragma: no cover — ladder always ends at max_seq


def clamped_bucket(needed: int, extent: Optional[int],
                   min_bucket: int = MIN_BUCKET) -> Optional[int]:
    """The rung a program covering ``needed`` KV rows runs under, with
    ``needed`` capped at the ladder top ``extent``; None without KV."""
    if extent is None:
        return None
    return select_kv_bucket(min(max(needed, 1), extent), extent, min_bucket)


def kv_cache_extent(cfg: ModelConfig, max_seq: int) -> Optional[int]:
    """Largest KV-cache leaf extent the model allocates at ``max_seq``;
    None when no layer holds a KV cache."""
    kinds = set(cfg.layer_kinds)
    extents = []
    if kinds & {"dense", "moe", "dense_moe", "hybrid_par"}:
        extents.append(max_seq)
    if cfg.shared_attn is not None and "mamba2+shared" in kinds:
        extents.append(max_seq)
    if "local" in kinds:
        window = cfg.attn.sliding_window if cfg.attn is not None else None
        extents.append(window if window is not None else max_seq)
    return max(extents) if extents else None


def rope_len_for(cfg: ModelConfig, max_seq: int) -> Optional[int]:
    """Rope-table override, needed when the largest KV cache (the window,
    for rolling archs) is smaller than the positions served."""
    extent = kv_cache_extent(cfg, max_seq)
    return max_seq if extent is not None and extent < max_seq else None
