"""Chunked prefill: state-carrying long-context prefill in fixed chunks.

Prompts are right-padded onto the chunk grid and driven through
:func:`repro_torch.models.lm.lm_prefill_chunk`, which carries the conv and
SSM states from chunk to chunk and writes each chunk's KV at the row's
running offset; a per-row ``lengths`` vector makes padding inert.  Chunk
``i`` runs under the KV bucket covering ``(i + 1) * chunk`` rows
(:mod:`repro_torch.serving.bucketing`), so early chunks read only the
early prefix, and with rope tables that cover the positions served
(``rope_len``), which pass a window-sized ring's extent.  :class:`ChunkedPrefill` owns one in-flight group: one
:meth:`~ChunkedPrefill.step` advances it by exactly one chunk, so the
engine can interleave one chunk with one decode burst, and a row is
emitted as soon as its own prompt completes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.config import ModelConfig
from repro_torch.models.lm import (cache_kv_extent, init_lm_cache,
                                   lm_prefill_chunk)
from repro_torch.serving.bucketing import (clamped_bucket, kv_cache_extent,
                                           rope_len_for)


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked prefill needs a causal, state-carrying model: encoder layers
    and audio frontends have no prefix-extension recurrence."""
    if cfg.frontend == "audio":
        return False
    return "encoder" not in cfg.layer_kinds


def chunk_schedule(lens: np.ndarray, chunk: int,
                   idx: int) -> Tuple[int, np.ndarray, np.ndarray]:
    """Returns ``(offset, valid_lens, finished)`` for chunk ``idx``: how many
    of the chunk's tokens are valid per row, and which rows' prompts end
    inside this chunk."""
    off = idx * chunk
    clens = np.clip(lens - off, 0, chunk).astype(np.int32)
    fin = (lens > off) & (lens <= off + chunk)
    return off, clens, fin


def chunked_prefill(cfg: ModelConfig, params, tokens: torch.Tensor, cache, *,
                    chunk_size: int,
                    lengths: Optional[Sequence[int]] = None
                    ) -> Tuple[torch.Tensor, Any]:
    """Prefill ``tokens`` [B, S] (right-padded, per-row valid ``lengths``)
    in ``chunk_size`` chunks.  Returns (last-valid-token logits [B,1,V],
    filled cache), as :func:`repro_torch.models.lm.lm_prefill` does.  The
    cache's KV leaves are written in place.  Where the KV extent is
    shorter than the prompt (a model whose largest KV leaf is a ring), the
    rope tables reach past it as the reference sizes them: to the next
    power of two at or above ``S``."""
    b, total = tokens.shape
    dev = tokens.device
    extent = cache_kv_extent(cache)
    rope_len = None
    if extent is not None and extent < total:
        rope_len = max(extent, 1 << (total - 1).bit_length())
    lens = (np.full((b,), total, np.int64) if lengths is None
            else np.asarray(lengths, np.int64))
    n_chunks = max(1, -(-total // chunk_size))
    pad = n_chunks * chunk_size - total
    if pad:
        tokens = torch.nn.functional.pad(tokens, (0, pad))
    logits = None
    for i in range(n_chunks):
        off, clens, fin = chunk_schedule(lens, chunk_size, i)
        lg, cache = lm_prefill_chunk(
            cfg, params, tokens[:, off:off + chunk_size], cache,
            lengths=torch.from_numpy(clens).to(dev),
            kv_bucket=clamped_bucket(off + chunk_size, extent),
            rope_len=rope_len)
        if logits is None:
            logits = lg
        elif fin.any():
            logits = torch.where(torch.from_numpy(fin).to(dev)[:, None, None],
                                 lg, logits)
    return logits, cache


class ChunkedPrefill:
    """Incremental chunked-prefill scheduler for the serving engine: one
    group at a time, one chunk per :meth:`step`.  The group cache template
    is allocated once per batch size and reused.  Prefill leaves the
    template's conv and SSM states as they were (each chunk returns new
    ones) but writes its KV leaves in place, so a later group starts on
    the earlier group's KV rows.  No stale row is ever read: chunk ``i``
    of a row writes rows ``[pos, pos + chunk)`` before it attends, and
    attends only rows ``<= pos + j`` (causal), all written earlier in the
    same group; decode reads rows ``< pos + 1`` only.  The tests hold two
    groups in a row through one scheduler against two fresh ones."""

    def __init__(self, cfg: ModelConfig, params, *, max_seq: int,
                 chunk_size: int = 256):
        if not supports_chunked_prefill(cfg):
            raise ValueError(f"{cfg.name}: architecture does not support "
                             "chunked prefill")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.max_seq = max_seq
        self.chunk = int(chunk_size)
        self.kv_extent = kv_cache_extent(cfg, max_seq)
        self.rope_len = rope_len_for(cfg, max_seq)
        self._templates: Dict[int, Any] = {}
        self._group: Optional[Dict[str, Any]] = None

    @property
    def active(self) -> bool:
        return self._group is not None

    @property
    def group_cache(self):
        """The in-flight group's cache (scatter emitted rows from here)."""
        if self._group is None:
            raise RuntimeError("no prefill group in flight")
        return self._group["cache"]

    def _template(self, batch: int):
        if batch not in self._templates:
            self._templates[batch] = init_lm_cache(
                self.cfg, batch, self.max_seq, device=self.device)
        return self._templates[batch]

    def start(self, prompts: List[np.ndarray],
              batch: Optional[int] = None) -> None:
        """Begin a group over mixed-length ``prompts`` (1-D int arrays).
        ``batch`` pads the batch dimension; rows past ``len(prompts)`` get
        zero-length prompts and are inert."""
        if self._group is not None:
            raise RuntimeError("one prefill group at a time")
        k = len(prompts)
        kb = batch or k
        if kb < k:
            raise ValueError(f"batch {kb} < {k} prompts")
        lens = np.zeros((kb,), np.int64)
        lens[:k] = [len(p) for p in prompts]
        if lens.max() > self.max_seq:
            raise ValueError(f"prompt length {int(lens.max())} exceeds "
                             f"max_seq {self.max_seq}")
        n_chunks = max(1, -(-int(lens.max()) // self.chunk))
        toks = np.zeros((kb, n_chunks * self.chunk), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = np.asarray(p, np.int32)
        self._group = {"tokens": torch.from_numpy(toks).to(self.device),
                       "lens": lens, "n_chunks": n_chunks, "idx": 0, "k": k,
                       "emitted": np.zeros(kb, bool),
                       "cache": self._template(kb)}

    def cancel_row(self, row: int) -> None:
        """Withdraw one group row: its remaining chunks go inert and it
        never emits."""
        g = self._group
        if g is None or not (0 <= row < g["lens"].shape[0]):
            return
        g["lens"][row] = 0
        g["emitted"][row] = True

    def step(self) -> Tuple[List[Tuple[int, int, int]], bool]:
        """Run ONE chunk for the in-flight group.  Returns ``(emitted,
        done)``: ``emitted`` lists ``(row, first_token, prompt_len)`` for
        rows whose prompt completed this chunk (their rows of
        :attr:`group_cache` are final); ``done`` is True once every chunk
        has run — call :meth:`finish` then."""
        g = self._group
        if g is None:
            raise RuntimeError("no prefill group in flight")
        off, clens, fin = chunk_schedule(g["lens"], self.chunk, g["idx"])
        logits, g["cache"] = lm_prefill_chunk(
            self.cfg, self.params, g["tokens"][:, off:off + self.chunk],
            g["cache"], lengths=torch.from_numpy(clens).to(self.device),
            kv_bucket=clamped_bucket(off + self.chunk, self.kv_extent),
            rope_len=self.rope_len)
        g["idx"] += 1
        fin &= ~g["emitted"]
        fin[g["k"]:] = False
        emitted: List[Tuple[int, int, int]] = []
        if fin.any():
            nxt = torch.argmax(logits[:, -1, :self.cfg.vocab_size], -1
                               ).cpu().numpy()
            emitted = [(int(r), int(nxt[r]), int(g["lens"][r]))
                       for r in np.nonzero(fin)[0]]
            g["emitted"] |= fin
        return emitted, g["idx"] >= g["n_chunks"]

    def finish(self) -> None:
        """Retire the completed group (its template is reused)."""
        self._group = None
