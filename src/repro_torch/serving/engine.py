"""Serving runtime: greedy generation and a slot-based batch engine.

The engine keeps a fixed batch of decode slots.  Each :meth:`step` runs
one admission move — one chunk of the in-flight mixed-length prefill group
(:mod:`repro_torch.serving.prefill`) — then advances every live slot by
``decode_block`` tokens through ``make_decode_tokens``'s burst, which
selects tokens on the device; on the card it runs as one captured CUDA
graph per (batch, burst, bucket) key (:mod:`repro_torch.serving.graphs`),
and the burst's tokens reach the host in one transfer.  The engine keeps
one spare set of the cache's state leaves, made with the cache, so a
burst updates the cache's state leaves where they are.  The cache
carries a per-slot ``pos`` vector, so slots admitted at different times
decode at their own offsets.  Admission is fifo, in submit order, which
is what the reference's default scheduler does.

Not ported yet (ROADMAP.md): preemption and offload/restore, the
engine's divergence sentinel flag (the burst has ``with_sentinel``),
checkpoints, deadlines, the watchdog, telemetry, metrics, the profiler,
the durable store and the other scheduler policies.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.config import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models.lm import (init_lm_cache, init_spare_states,
                                   lm_prefill, prepare_params)
from repro_torch.models.params import tree_leaves
from repro_torch.serving.bucketing import (clamped_bucket, kv_cache_extent,
                                           rope_len_for)
from repro_torch.serving.graphs import make_decode_tokens
from repro_torch.serving.prefill import ChunkedPrefill, supports_chunked_prefill


def _on_device(params, dev: torch.device) -> None:
    bad = {str(t.device) for t in tree_leaves(params)
           if t.device.type != dev.type}
    if bad:
        raise ValueError(f"params live on {sorted(bad)}, not {dev}")


def greedy_generate(cfg: ModelConfig, params, inputs: Dict[str, torch.Tensor],
                    max_seq: int, gen_len: int, *,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Tuple[torch.Tensor, Any]:
    """Prefill + greedy decode, the decode as one ``make_decode_tokens``
    burst.  Returns (tokens [B, gen_len], cache)."""
    dev = resolve_device(device)
    _on_device(params, dev)
    params = prepare_params(cfg, params)
    tokens = inputs["tokens"].to(dev)
    cache = init_lm_cache(cfg, tokens.shape[0], max_seq, device=dev)
    logits, cache = lm_prefill(cfg, params, tokens, cache)
    first = torch.argmax(logits[..., :cfg.vocab_size], -1).to(torch.int32)
    if gen_len <= 1:
        return first, cache
    rest, cache = make_decode_tokens(cfg)(params, cache, first, gen_len - 1,
                                          rope_len=rope_len_for(cfg, max_seq),
                                          spare=init_spare_states(cache))
    return torch.cat([first, rest], dim=1), cache


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False
    status: str = "pending"       # terminal: ok
    submit_t: float = 0.0         # engine clock at submit
    first_t: Optional[float] = None   # engine clock when the first token came
    finish_t: Optional[float] = None


def _scatter_group(batch_cache, src_cache, dst: np.ndarray) -> None:
    """Copy rows ``i`` of a batch-k prefill cache into slots ``dst[i]`` of the
    engine's cache, in place (the engine owns that cache).  Rows with
    ``dst[i] < 0`` are skipped.  Leaves are stacked [n_rep, B, ...]: the
    batch dim is axis 1.  Row by row, slice to slice, so no gathered copy
    of a row's KV leaves is made on the way."""
    rows = np.nonzero(dst >= 0)[0]
    for full_seg, one_seg in zip(batch_cache["segments"],
                                 src_cache["segments"]):
        for full, one in zip(tree_leaves(full_seg), tree_leaves(one_seg)):
            for i in rows:
                full[:, int(dst[i])].copy_(one[:, int(i)])


class ServingEngine:
    """Fixed-slot continuous batching over chunked prefill and greedy decode
    bursts.  ``device`` None means the card."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int, max_seq: int,
                 decode_block: int = 8, chunk_size: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if not supports_chunked_prefill(cfg):
            raise ValueError(
                f"{cfg.name}: no autoregressive serving path (encoder / "
                "audio-frontend architecture)")
        self.device = resolve_device(device)
        _on_device(params, self.device)
        self.cfg = cfg
        self.params = prepare_params(cfg, params)
        self.slots = slots
        self.max_seq = max_seq
        self.decode_block = decode_block
        self.chunk_size = chunk_size or min(256, max_seq)
        self._clock = clock or time.monotonic
        self.kv_extent = kv_cache_extent(cfg, max_seq)
        self.rope_len = rope_len_for(cfg, max_seq)
        self.cache = init_lm_cache(cfg, slots, max_seq, device=self.device)
        self._spare = init_spare_states(self.cache)
        self._decode_n = make_decode_tokens(cfg)
        self._prefill = ChunkedPrefill(cfg, self.params, max_seq=max_seq,
                                       chunk_size=self.chunk_size)
        # slots reserved for the in-flight prefill group: row i of the
        # group lands in slot _pending[i][0] when its prompt completes
        self._pending: List[Tuple[int, Request]] = []
        self.live: List[Optional[Request]] = [None] * slots
        self.tokens = np.zeros((slots, 1), np.int32)
        self.pos = np.zeros((slots,), np.int64)
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.stats = {"iters": 0, "decode_tokens": 0, "prefill_chunks": 0}

    def submit(self, req: Request) -> None:
        """Queue a request; raises ValueError for a prompt the engine
        cannot serve."""
        if len(req.prompt) == 0:
            raise ValueError(f"rid={req.rid}: empty prompt")
        # decode room is max_seq - 1 - pos, so a prompt needs at least two
        # cache rows beyond itself to emit any decoded token
        if len(req.prompt) > self.max_seq - 2:
            raise ValueError(
                f"rid={req.rid}: prompt length {len(req.prompt)} exceeds "
                f"max_seq-2 ({self.max_seq - 2}); no room to decode")
        p = np.asarray(req.prompt)
        if not np.issubdtype(p.dtype, np.integer):
            raise ValueError(f"rid={req.rid}: prompt dtype {p.dtype} is not "
                             "an integer token array")
        lo, hi = int(p.min()), int(p.max())
        if lo < 0 or hi >= self.cfg.vocab_size:
            raise ValueError(
                f"rid={req.rid}: prompt token ids [{lo}, {hi}] fall outside "
                f"the vocab [0, {self.cfg.vocab_size})")
        req.submit_t = self._clock()
        self.queue.append(req)

    def _admit(self) -> None:
        ch = self._prefill
        reserved = {b for b, _ in self._pending}
        free = [b for b in range(self.slots)
                if self.live[b] is None and b not in reserved]
        # fifo: queued prompts fill free slots in submit order and form one
        # mixed-length prefill group; none joins a group already in flight
        fresh: List[Request] = []
        while self.queue and free and not ch.active:
            req = self.queue.pop(0)
            fresh.append(req)
            self._pending.append((free.pop(0), req))
        if fresh:
            ch.start([r.prompt for r in fresh],
                     batch=self.slots if len(fresh) > 1 else 1)
        if not ch.active:
            return
        emitted, done = ch.step()
        self.stats["prefill_chunks"] += 1
        if emitted:
            dst = np.full((ch.group_cache["pos"].shape[0],), -1, np.int64)
            now = self._clock()
            for row, tok, plen in emitted:
                b, req = self._pending[row]
                dst[row] = b
                req.out.append(tok)
                req.first_t = now
                self.tokens[b, 0] = tok
                self.pos[b] = plen
                self.live[b] = req
            _scatter_group(self.cache, ch.group_cache, dst)
        if done:
            ch.finish()
            self._pending = []

    def step(self) -> int:
        """One engine iteration: one prefill chunk, then a ``decode_block``
        burst for all live slots.  Returns live + queued + in-prefill."""
        self.stats["iters"] += 1
        self._admit()
        if not any(r is not None for r in self.live):
            return len(self.queue) + len(self._pending)
        kblk = self.decode_block
        live_pos = [int(self.pos[b]) for b, r in enumerate(self.live)
                    if r is not None]
        kv_bucket = clamped_bucket(max(live_pos) + kblk, self.kv_extent)
        # host tokens and positions: the burst copies them into its inputs
        toks_d, self.cache = self._decode_n(
            self.params,
            dict(self.cache, pos=torch.from_numpy(self.pos.astype(np.int32))),
            torch.from_numpy(self.tokens), kblk, kv_bucket=kv_bucket,
            rope_len=self.rope_len, spare=self._spare)
        toks = toks_d.cpu().numpy()      # the burst's one host sync
        now = self._clock()
        n_live = 0
        for b, req in enumerate(self.live):
            if req is None:
                continue
            room = min(req.max_new - len(req.out),
                       self.max_seq - 1 - int(self.pos[b]))
            take = min(kblk, max(room, 0))
            req.out.extend(int(t) for t in toks[b, :take])
            self.stats["decode_tokens"] += take
            if take:
                self.tokens[b, 0] = int(toks[b, take - 1])
            self.pos[b] += take
            if len(req.out) >= req.max_new or self.pos[b] >= self.max_seq - 1:
                req.done = True
                req.status = "ok"
                req.finish_t = now
                self.finished.append(req)
                self.live[b] = None
            else:
                n_live += 1
        return n_live + len(self.queue) + len(self._pending)

    def run(self) -> List[Request]:
        """Drive :meth:`step` until every request is finished."""
        while self.step() or self.queue or self._pending:
            pass
        return self.finished
