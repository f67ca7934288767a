"""Synthetic long-context data pipeline (BABILong-style needle retrieval).

The port's own copy of the reference's ``repro.data.synthetic`` (numpy
only): the same streams, bit for bit, from the same seeds.

Restart-deterministic by construction: batch(step) is a pure function of
(seed, step), so resuming from a checkpoint at step k replays the exact
stream — the data-side half of fault tolerance.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    needle_len: int = 8        # copy-task needle planted in the haystack
    needle_offset_frac: float = 0.5


class SyntheticLM:
    """Needle-in-a-haystack token stream: random haystack, a needle span is
    planted, and repeated near the end — the LM must retrieve across long
    context (the paper's motivating workload)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([c.seed, step]))
        toks = rng.integers(2, c.vocab_size,
                            size=(c.global_batch, c.seq_len), dtype=np.int64)
        nl = min(c.needle_len, max(c.seq_len // 8, 1))
        ins = int(c.seq_len * c.needle_offset_frac * 0.5)
        rep = max(c.seq_len - 2 * nl - 1, ins + nl)
        needle = rng.integers(2, c.vocab_size,
                              size=(c.global_batch, nl), dtype=np.int64)
        toks[:, ins:ins + nl] = needle
        toks[:, rep:rep + nl] = needle          # retrieval target
        toks[:, rep - 1] = 1                    # "recall" marker token
        return {"tokens": toks.astype(np.int32),
                "labels": toks.astype(np.int32)}

    def iter(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


class SyntheticAudio:
    """Frame-feature stream for the [audio] stub frontend."""

    def __init__(self, cfg: DataConfig, feat_dim: int = 512):
        self.cfg = cfg
        self.feat_dim = feat_dim

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([c.seed, step, 7]))
        feats = rng.standard_normal(
            (c.global_batch, c.seq_len, self.feat_dim)).astype(np.float32)
        labels = rng.integers(0, c.vocab_size,
                              size=(c.global_batch, c.seq_len), dtype=np.int64)
        return {"features": feats, "labels": labels.astype(np.int32)}


class SyntheticVision:
    """Patch-feature stream for the [vision] stub frontend: ``n_patches``
    feature rows before the needle stream's first ``seq_len - n_patches``
    tokens, with labels over the whole sequence (0 at the patch
    positions), as the reference's loss takes a vision model's labels."""

    def __init__(self, cfg: DataConfig, feat_dim: int, n_patches: int):
        if not 0 < n_patches < cfg.seq_len:
            raise ValueError(f"n_patches must be in (0, {cfg.seq_len}), got "
                             f"{n_patches}")
        self.cfg = cfg
        self.feat_dim = feat_dim
        self.n_patches = n_patches
        self.text = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=cfg.seq_len - n_patches,
            global_batch=cfg.global_batch, seed=cfg.seed,
            needle_len=cfg.needle_len,
            needle_offset_frac=cfg.needle_offset_frac))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        toks = self.text.batch(step)["tokens"]
        rng = np.random.default_rng(np.random.SeedSequence([c.seed, step, 11]))
        feats = rng.standard_normal(
            (c.global_batch, self.n_patches, self.feat_dim)).astype(
            np.float32)
        labels = np.zeros((c.global_batch, c.seq_len), dtype=np.int32)
        labels[:, self.n_patches:] = toks
        return {"tokens": toks, "features": feats, "labels": labels}


# patch rows a synthetic vision batch carries at most (llava-next's base
# resolution: 24 x 24 patches)
VISION_PATCHES = 576


def synthetic_for(cfg, seq_len: int, global_batch: int, seed: int = 0):
    """The synthetic stream a model of ``cfg`` trains on: frame features
    (an ``audio`` frontend), patch features before tokens (``vision``:
    min(576, seq_len / 2) patches), else the needle token stream."""
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                    global_batch=global_batch, seed=seed)
    if cfg.frontend == "audio":
        return SyntheticAudio(dc, feat_dim=cfg.frontend_feature_dim)
    if cfg.frontend == "vision":
        return SyntheticVision(dc, cfg.frontend_feature_dim,
                               min(VISION_PATCHES, seq_len // 2))
    return SyntheticLM(dc)


def needle_accuracy(pred: np.ndarray, batch: Dict[str, np.ndarray],
                    cfg: DataConfig) -> float:
    """Fraction of needle-repeat tokens predicted correctly (retrieval metric)."""
    nl = min(cfg.needle_len, max(cfg.seq_len // 8, 1))
    rep = max(cfg.seq_len - 2 * nl - 1, 0)
    tgt = batch["labels"][:, rep:rep + nl]
    got = pred[:, rep - 1:rep + nl - 1] if rep >= 1 else pred[:, :nl]
    return float((tgt == got).mean())
