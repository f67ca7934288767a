"""Serving runtime: greedy generation and a slot-based batch engine with
the reference's control layer.

The engine keeps a fixed batch of decode slots.  Each :meth:`step` runs
one admission move — one chunk of the in-flight mixed-length prefill
group (:mod:`repro_torch.serving.prefill`), or the restore of a
preempted request — then advances every live slot by ``decode_block``
tokens through ``make_decode_tokens``'s burst, which selects tokens on
the device; on the card it runs as one captured CUDA graph per (batch,
burst, bucket, sentinel) key (:mod:`repro_torch.serving.graphs`), and
the burst's tokens and sentinel flags reach the host in one transfer.
The engine keeps one spare set of the cache's state leaves, made with
the cache, so a burst updates the cache's state leaves where they are.
The cache carries a per-slot ``pos`` vector, so slots admitted at
different times decode at their own offsets.

The control layer is the reference's, method for method:

* **Scheduling** (:mod:`repro_torch.serving.scheduler`): admission
  order, preemption urgency and victim, starvation expiry and prefill
  interleave shares come from a ``fifo``, ``strict_tiers`` or
  ``weighted_fair`` policy over ``Request.priority``.  A starved queue
  preempts a live slot: it is offloaded to host memory
  (:mod:`repro_torch.serving.cache`) and restored bit-exactly when a slot
  frees.
* **Faults** (:mod:`repro_torch.serving.faults`): every request ends
  ``ok``, ``failed``, ``cancelled`` or ``timed_out`` on
  :attr:`ServingEngine.finished`.  A row whose burst or chunk turns
  non-finite (the sentinel) is restored from its last checkpoint (every
  ``checkpoint_every`` iterations, and at its first burst) and replayed
  once, then failed with ``DivergenceDetected``; blobs are crc and schema
  checked (``CacheCorruption``); deadlines are enforced at admission and
  in flight; a no-progress watchdog and ``run(max_iters=...)`` bound the
  loop.  :mod:`repro_torch.serving.fault_inject` pokes each fault.
* **Telemetry and metrics** (:mod:`repro_torch.serving.telemetry`,
  :mod:`repro_torch.serving.metrics`): the per-(phase, bucket) latency
  model that admission and victim slack read (the first burst at a key,
  an eager run plus a capture on the card, is kept apart as a compile
  sample), per-request spans, and the reference's instruments.
* **Durability** (:mod:`repro_torch.serving.store`): with a
  ``CheckpointStore``, checkpoints, preemption blobs and request records
  persist under an atomically committed manifest, and a fresh engine
  over the store resumes every request bit-identically.
* **Profiling** (:mod:`repro_torch.serving.profiler`): the engine hands
  each prefill chunk's and decode burst's wall time to its ``profiler``
  (off by default), which in trace mode also learns every decode graph;
  :meth:`ServingEngine.profile_snapshot` gives the time by operator
  class.

On the card every write into the engine's cache (restore, quarantine,
the NaN poke, the admission scatter) copies into the existing leaves, so
the decode graphs' keys, which hold the leaves' addresses, stay the same.

Encoder-only and audio models have no autoregressive path: the engine
refuses them, as the reference's does, and :func:`make_encode_step`
serves them (one full forward).  A vision model is served token-only;
:func:`greedy_generate` takes its patch features.  MoE models run with
one dispatch group, as the reference's do without a sharding plan.

Not ported yet (ROADMAP.md): the reference's sharding ``plan=``.
"""
from __future__ import annotations

import logging
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.config import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.op_analysis import analyze, meta_like
from repro_torch.models.lm import (decode_tokens, init_lm_cache,
                                   init_spare_states, lm_forward, lm_prefill,
                                   lm_prefill_chunk, prepare_params)
from repro_torch.models.params import tree_leaves
from repro_torch.serving.bucketing import (clamped_bucket, kv_cache_extent,
                                           rope_len_for)
from repro_torch.serving.cache import (blob_nbytes, blob_tags, offload_slot,
                                       offload_slots, restore_slot,
                                       slot_schema, validate_blob)
from repro_torch.serving.fault_inject import (FaultPlan, SimulatedCrash,
                                              poison_slot)
from repro_torch.serving.faults import (CacheCorruption, DeadlineExceeded,
                                        DivergenceDetected, RecoveryFailed,
                                        RequestError, SlotStalled,
                                        StarvationTimeout)
from repro_torch.serving.graphs import make_decode_tokens
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.prefill import ChunkedPrefill, supports_chunked_prefill
from repro_torch.serving.profiler import Profiler
from repro_torch.serving.scheduler import (Scheduler, VictimCandidate,
                                           make_scheduler)
from repro_torch.serving.store import CheckpointStore, layout_fingerprint
from repro_torch.serving.telemetry import Telemetry

log = logging.getLogger("repro_torch.serving.engine")


def _on_device(params, dev: torch.device) -> None:
    bad = {str(t.device) for t in tree_leaves(params)
           if t.device.type != dev.type}
    if bad:
        raise ValueError(f"params live on {sorted(bad)}, not {dev}")


def make_encode_step(cfg: ModelConfig, *,
                     device: Optional[Union[str, torch.device]] = None):
    """The serve step of an encoder-only model (hubert): one full forward,
    :func:`~repro_torch.models.lm.lm_forward` with no cache.  The step
    takes (params, inputs): ``inputs`` holds ``features`` (an audio
    model's frames [B, S, F]) and/or ``tokens``, and is moved to the
    device; params from :func:`~repro_torch.models.lm.prepare_params`
    are read as they are, raw ones are cast on every use.  Returns the
    logits [B, S, V]."""
    dev = resolve_device(device)

    def encode_step(params, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        _on_device(params, dev)
        tokens, feats = inputs.get("tokens"), inputs.get("features")
        return lm_forward(cfg, params,
                          None if tokens is None else tokens.to(dev),
                          features=None if feats is None else feats.to(dev),
                          train=False)

    return encode_step


def greedy_generate(cfg: ModelConfig, params, inputs: Dict[str, torch.Tensor],
                    max_seq: int, gen_len: int, *,
                    features: Optional[torch.Tensor] = None,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Tuple[torch.Tensor, Any]:
    """Prefill + greedy decode, the decode as one :func:`decode_tokens`
    burst with a spare state set (nothing is captured: a single burst
    would never replay a graph).  A vision model's ``features`` [B, N, F]
    go before the prompt, so decoding starts at position N + T.  Returns
    (tokens [B, gen_len], cache)."""
    dev = resolve_device(device)
    _on_device(params, dev)
    params = prepare_params(cfg, params)
    tokens = inputs["tokens"].to(dev)
    cache = init_lm_cache(cfg, tokens.shape[0], max_seq, device=dev)
    logits, cache = lm_prefill(
        cfg, params, tokens, cache,
        features=None if features is None else features.to(dev))
    first = torch.argmax(logits[..., :cfg.vocab_size], -1).to(torch.int32)
    if gen_len <= 1:
        return first, cache
    rest, cache = decode_tokens(cfg, params, cache, first, gen_len - 1,
                                rope_len=rope_len_for(cfg, max_seq),
                                _spare_states=init_spare_states(cache))
    return torch.cat([first, rest], dim=1), cache


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new: int
    deadline_ms: Optional[float] = None   # TTL from submit; None = no SLO
    priority: int = 0             # scheduling class; higher = more important
    out: List[int] = field(default_factory=list)
    done: bool = False
    status: str = "pending"       # terminal: ok/failed/cancelled/timed_out
    error: Optional[RequestError] = None
    submit_t: float = 0.0         # engine clock at submit (deadline base)
    first_t: Optional[float] = None   # engine clock when the first token came
    finish_t: Optional[float] = None  # engine clock when it finished ok
    # preemption state (set when the engine offloads this request's slot)
    blob: Optional[Dict[str, Any]] = None
    next_token: int = 0
    resume_pos: int = 0
    preemptions: int = 0
    # last-good checkpoint (divergence replay target)
    ckpt_blob: Optional[Dict[str, Any]] = None
    ckpt_token: int = 0
    ckpt_pos: int = 0
    ckpt_out: int = 0
    replays: int = 0


def _scatter_group(batch_cache, src_cache, dst: np.ndarray) -> None:
    """Copy rows ``i`` of a batch-k prefill cache into slots ``dst[i]`` of the
    engine's cache, in place (the engine owns that cache).  Rows with
    ``dst[i] < 0`` are skipped.  Leaves are stacked [n_rep, B, ...]: the
    batch dim is axis 1.  Row by row, slice to slice, so no gathered copy
    of a row's KV leaves is made on the way; full rows, so a slot that
    held a failed request is overwritten whole."""
    rows = np.nonzero(dst >= 0)[0]
    for full_seg, one_seg in zip(batch_cache["segments"],
                                 src_cache["segments"]):
        for full, one in zip(tree_leaves(full_seg), tree_leaves(one_seg)):
            for i in rows:
                full[:, int(dst[i])].copy_(one[:, int(i)])


class ServingEngine:
    """Fixed-slot continuous batching over chunked prefill and greedy decode
    bursts, with the reference's scheduling, fault handling, telemetry
    and durable store (module docstring).  ``device`` None means the card.

    Knobs, with the reference's defaults: ``preempt_after`` (iterations
    a queue may starve before a victim is offloaded), ``checkpoint_every``
    (0 disables checkpoints, and divergence then fails without replay),
    ``stall_after`` (the watchdog), ``sentinel``, ``fault_plan``,
    ``clock`` (every engine timing reads it), ``telemetry`` /
    ``trace_path`` / ``warmstart_path``, ``metrics``, ``scheduler`` or
    ``sched_policy`` / ``sched_weights`` / ``starve_ms``, ``store`` or
    ``store_dir``, and ``profiler`` (a
    :class:`~repro_torch.serving.profiler.Profiler`; default off).

    Co-batch isolation: rows are independent across the batch in every
    kernel, quarantine restores full slot rows, and a failed slot is
    overwritten whole at re-admission, so a healthy request decodes
    bit-identically whether or not a neighbour faulted."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int, max_seq: int,
                 decode_block: int = 8, chunk_size: Optional[int] = None,
                 preempt_after: int = 4, checkpoint_every: int = 8,
                 stall_after: int = 32, sentinel: bool = True,
                 fault_plan: Optional[FaultPlan] = None,
                 clock: Optional[Callable[[], float]] = None,
                 telemetry: Optional[Telemetry] = None,
                 trace_path: Optional[str] = None,
                 warmstart_path: Optional[str] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 scheduler: Optional[Scheduler] = None,
                 sched_policy: Optional[str] = None,
                 sched_weights: Optional[Dict[int, float]] = None,
                 starve_ms: Optional[float] = None,
                 store: Optional[CheckpointStore] = None,
                 store_dir: Optional[str] = None,
                 profiler: Optional[Profiler] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if not supports_chunked_prefill(cfg):
            raise ValueError(
                f"{cfg.name}: no autoregressive serving path (encoder / "
                "audio-frontend architectures serve through "
                "make_encode_step, not the slot engine)")
        self.device = resolve_device(device)
        _on_device(params, self.device)
        self.cfg = cfg
        self.params = prepare_params(cfg, params)
        self.slots = slots
        self.max_seq = max_seq
        self.decode_block = decode_block
        self.chunk_size = chunk_size or min(256, max_seq)
        self.preempt_after = preempt_after
        self.checkpoint_every = int(checkpoint_every)
        self.stall_after = int(stall_after)
        self.sentinel = bool(sentinel)
        self.faults = fault_plan if fault_plan is not None else FaultPlan()
        self.scheduler = scheduler if scheduler is not None else \
            make_scheduler(sched_policy, sched_weights, starve_ms)
        self._clock = clock or time.monotonic
        self.telemetry = telemetry if telemetry is not None else Telemetry(
            clock=self._clock, trace_path=trace_path, arch=cfg.name,
            warmstart_path=warmstart_path)
        self.metrics = metrics if metrics is not None else MetricsRegistry(
            clock=self._clock)
        self.profiler = profiler if profiler is not None else Profiler(
            mode="off", clock=self._clock)
        self._init_metrics()
        self.kv_extent = kv_cache_extent(cfg, max_seq)
        self.kv_buckets = self.kv_extent is not None
        self.rope_len = rope_len_for(cfg, max_seq)
        self.cache = init_lm_cache(cfg, slots, max_seq, device=self.device)
        self._spare = init_spare_states(self.cache)
        self._decode_n = make_decode_tokens(cfg, self.profiler)
        self._chunked_prefill = ChunkedPrefill(
            cfg, self.params, max_seq=max_seq, chunk_size=self.chunk_size,
            sentinel=self.sentinel, fault_plan=self.faults,
            metrics=self.metrics)
        # slots reserved for the in-flight prefill group: row i of the
        # group lands in slot _pending[i][0] when its prompt completes
        self._pending: List[Tuple[int, Request]] = []
        self._starved = 0
        self._no_progress = 0
        # fractional-interleave accumulator (policy interleave shares)
        self._prefill_credit = 0.0
        self.live: List[Optional[Request]] = [None] * slots
        self.tokens = np.zeros((slots, 1), np.int32)
        self.pos = np.zeros((slots,), np.int64)
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.stats = {"iters": 0, "decode_tokens": 0, "prefill_chunks": 0,
                      "preemptions": 0, "restores": 0,
                      "interleave_iters": 0, "interleave_decode_iters": 0,
                      "checkpoints": 0, "ckpt_ms": 0.0, "divergences": 0,
                      "replays": 0, "failures": 0, "timeouts": 0,
                      "cancelled": 0, "watchdog_trips": 0,
                      "starvation_timeouts": 0}
        # distinct KV buckets the decode bursts ran in
        self.buckets_used: set = set()
        # decode bucket keys already dispatched: the first burst at a key
        # (on the card an eager run plus a capture) is a compile sample
        self._decode_seen: set = set()
        # (group batch, KV bucket) of every prefill chunk dispatched
        self._prefill_seen: set = set()
        self._max_bucket = -1     # deepest decode rung seen (climb counter)
        if store is None and store_dir:
            store = CheckpointStore(store_dir)
        self.store = store
        self._slot_schema = slot_schema(self.cache)
        self._template_keys = list(self._slot_schema)
        self._store_fp = layout_fingerprint(cfg.name, max_seq,
                                            self._slot_schema)
        self._store_order = 0
        self._rehydrate()

    def _init_metrics(self) -> None:
        """Register this engine's instruments on the (possibly shared)
        registry; get-or-create, so several engines can share one."""
        m = self.metrics
        self._m_queue = m.gauge(
            "repro_queue_depth", "requests waiting for a slot")
        self._m_live = m.gauge("repro_live_slots", "slots decoding now")
        self._m_tps = m.gauge(
            "repro_tokens_per_s", "steady-state token throughput per phase")
        self._m_submitted = m.counter(
            "repro_submitted_total", "requests submitted")
        self._m_admitted = m.counter(
            "repro_admitted_total", "requests admitted into a prefill group")
        self._m_finished = m.counter(
            "repro_finished_total",
            "terminal requests by status (ok/failed/cancelled/timed_out)")
        self._m_tokens = m.counter(
            "repro_tokens_total", "tokens processed per phase")
        self._m_preempt = m.counter(
            "repro_preemptions_total", "slot offloads for starved queues")
        self._m_restore = m.counter(
            "repro_restores_total", "preempted slots restored")
        self._m_ckpts = m.counter(
            "repro_checkpoints_total", "replay checkpoints taken")
        self._m_ckpt_bytes = m.counter(
            "repro_checkpoint_bytes_total",
            "host bytes offloaded by checkpointing")
        self._m_climbs = m.counter(
            "repro_bucket_climbs_total",
            "decode dispatches entering a deeper KV rung (each pays "
            "trace+compile)")
        self._m_diverg = m.counter(
            "repro_divergences_total", "sentinel trips")
        self._m_replays = m.counter(
            "repro_replays_total", "checkpoint replays after divergence")
        self._m_watchdog = m.counter(
            "repro_watchdog_trips_total", "no-progress watchdog trips")
        self._m_decode_ms = m.histogram(
            "repro_decode_burst_ms", "decode burst wall time (ms)")
        self._m_prefill_ms = m.histogram(
            "repro_prefill_chunk_ms", "prefill chunk wall time (ms)")
        self._m_ttft = m.histogram(
            "repro_ttft_ms",
            "time to first token (ms), labelled by priority class")
        self._m_class_tokens = m.counter(
            "repro_class_tokens_total",
            "tokens served per priority class and phase")
        self._m_starved = m.counter(
            "repro_starvation_timeouts_total",
            "queued requests failed by the scheduler's starvation bound")
        self._m_recoveries = m.counter(
            "repro_recoveries_total",
            "requests rehydrated from the durable checkpoint store at "
            "engine restart, by outcome (restored/replayed/requeued/"
            "expired/unrecoverable)")
        self._m_recovery_ms = m.histogram(
            "repro_recovery_ms",
            "wall time of one engine-restart rehydration pass (ms)")

    def submit(self, req: Request) -> None:
        """Queue a request; raises ValueError for a prompt the engine
        cannot serve (a caller bug).  In-flight faults never raise."""
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
                f"the vocab [0, {self.cfg.vocab_size}) — out-of-vocab ids "
                "index garbage embedding rows")
        req.submit_t = self._clock()
        self.telemetry.begin_span(req.rid, prompt_len=len(req.prompt),
                                  max_new=req.max_new,
                                  deadline_ms=req.deadline_ms,
                                  priority=req.priority,
                                  t=req.submit_t)
        self.queue.append(req)
        self._m_submitted.inc()
        self._m_queue.set(len(self.queue))
        if self.store is not None:
            self._persist_request(req, state="queued")
            self.store.commit()

    # -------------------------------------------------------- durability
    def _persist_request(self, req: Request, *, state: str,
                         next_token: int = 0, pos: int = 0) -> None:
        """Write/refresh ``req``'s manifest record (uncommitted): enough to
        replay it from its prompt, and with a staged blob to restore it
        mid-stream.  ``age_ms`` and the clock reading let the next engine
        resume the deadline as the remaining budget; ``prompt_crc`` guards
        against a record whose replay would decode another request."""
        p = np.asarray(req.prompt, np.int64)
        rec = self.store.record(
            req.rid, state=state,
            prompt=[int(x) for x in req.prompt],
            prompt_crc=zlib.crc32(p.tobytes()),
            max_new=int(req.max_new), priority=int(req.priority),
            deadline_ms=req.deadline_ms,
            age_ms=(self._clock() - req.submit_t) * 1e3, t=self._clock(),
            out=list(req.out), next_token=int(next_token), pos=int(pos))
        if "order" not in rec:           # admission order survives restart
            rec["order"] = self._store_order
            self._store_order += 1

    def _forget_request(self, req: Request) -> None:
        """Terminal state reached: the durable record has nothing left to
        recover."""
        if self.store is not None:
            self.store.forget(req.rid)
            self.store.commit()

    def _rehydrate(self) -> None:
        """Resurrect a crashed engine's work from the durable store, in
        admission order: requests whose deadline expired while the engine
        was down fail (``DeadlineExceeded``); a prompt failing its crc
        fails (``RecoveryFailed``); an in-flight request with a good newest
        blob re-enters as a restore ("restored"), with a bad one it
        replays from its prompt ("replayed"); a queued one is requeued
        ("requeued").  ``submit_t`` is back-dated by the budget consumed.
        Outcome counts land on :attr:`recovery`."""
        self.recovery: Dict[str, int] = {
            "restored": 0, "replayed": 0, "requeued": 0,
            "expired": 0, "unrecoverable": 0}
        if self.store is None:
            return
        fp = self.store.manifest.get("fingerprint")
        if fp is not None and fp != self._store_fp:
            log.warning(
                "checkpoint store %s: layout fingerprint %s does not "
                "match this engine's %s (config %r, max_seq %d); "
                "ignoring the store", self.store.root, fp, self._store_fp,
                self.cfg.name, self.max_seq)
            self.store = None
            return
        t0 = self._clock()
        recs = sorted(self.store.requests.values(),
                      key=lambda r: r.get("order", 0))
        if recs:
            self._store_order = max(r.get("order", 0) for r in recs) + 1
        for rec in list(recs):
            rid = int(rec["rid"])
            prompt = np.asarray(rec.get("prompt") or [], np.int32)
            req = Request(rid=rid, prompt=prompt,
                          max_new=int(rec.get("max_new", 0)),
                          deadline_ms=rec.get("deadline_ms"),
                          priority=int(rec.get("priority", 0)))
            now = self._clock()
            downtime_ms = max(0.0, (now - float(rec.get("t", now))) * 1e3)
            consumed_ms = float(rec.get("age_ms", 0.0)) + downtime_ms
            req.submit_t = now - consumed_ms / 1e3
            self.telemetry.begin_span(
                rid, prompt_len=len(prompt), max_new=req.max_new,
                deadline_ms=req.deadline_ms, priority=req.priority,
                t=req.submit_t, rehydrated=rec.get("state", "queued"))
            if (req.deadline_ms is not None
                    and consumed_ms >= req.deadline_ms):
                self.recovery["expired"] += 1
                self._m_recoveries.labels(outcome="expired").inc()
                self._fail(req, "timed_out", DeadlineExceeded(
                    f"deadline expired while the engine was down "
                    f"({consumed_ms:.1f}ms consumed of "
                    f"{req.deadline_ms:.1f}ms)", rid=rid))
                continue
            crc = rec.get("prompt_crc")
            if (len(prompt) == 0 or (crc is not None and int(crc) !=
                    zlib.crc32(np.asarray(prompt, np.int64).tobytes()))):
                self.recovery["unrecoverable"] += 1
                self._m_recoveries.labels(outcome="unrecoverable").inc()
                self._fail(req, "failed", RecoveryFailed(
                    "persisted prompt fails its recorded crc32 — replay "
                    "would decode a different request", rid=rid))
                continue
            outcome = "requeued"
            if rec.get("state") != "queued":
                outcome = "replayed"
                # only the newest blob matches the record's resume point
                rels = rec.get("blobs") or []
                if rels:
                    try:
                        blob = self.store.load_blob(rels[0])
                        validate_blob(blob, self._template_keys, rid=rid)
                        tags = blob_tags(blob)
                        if "rid" in tags and tags["rid"] != rid:
                            raise CacheCorruption(
                                f"durable blob carries rid {tags['rid']!r}",
                                rid=rid)
                        req.blob = blob
                        req.next_token = int(rec.get("next_token", 0))
                        req.resume_pos = int(rec.get("pos", 0))
                        req.out = [int(x) for x in rec.get("out") or []]
                        outcome = "restored"
                    except CacheCorruption as e:
                        log.warning("rid=%d: durable blob rejected (%s); "
                                    "replaying from prompt", rid, e)
            self.queue.append(req)
            self.recovery[outcome] += 1
            self._m_recoveries.labels(outcome=outcome).inc()
            self.telemetry.event(rid, "rehydrate", detail=outcome)
        self.store.set_fingerprint(self._store_fp)
        self.store.commit()
        self._m_queue.set(len(self.queue))
        if recs:
            self._m_recovery_ms.observe((self._clock() - t0) * 1e3)

    # ------------------------------------------------------------ failures
    def _fail(self, req: Request, status: str,
              err: Optional[RequestError]) -> None:
        """Move a request to a non-ok terminal state (never raises)."""
        req.status = status
        req.error = err
        req.done = True
        req.blob = None
        req.ckpt_blob = None
        self.finished.append(req)
        self.telemetry.end_span(req.rid, status,
                                error=str(err) if err else None,
                                tokens_out=len(req.out))
        self.stats[{"failed": "failures", "timed_out": "timeouts",
                    "cancelled": "cancelled"}[status]] += 1
        self._m_finished.labels(status=status).inc()
        self._forget_request(req)

    def _expired(self, req: Request, now: float) -> bool:
        return self.scheduler.expired(req, now)

    def _expire_deadlines(self) -> None:
        """Cancel queued / mid-prefill / mid-decode requests whose TTL has
        run out (the scheduler decides, the engine reclaims slots and group
        rows), then fail queued requests past the policy's starvation
        bound."""
        now = self._clock()
        for req in [r for r in self.queue if self._expired(r, now)]:
            self.queue.remove(req)
            self._fail(req, "timed_out", DeadlineExceeded(
                "deadline expired while queued "
                f"({req.deadline_ms:.1f}ms)", rid=req.rid))
        for row, (b, req) in enumerate(self._pending):
            if not req.done and self._expired(req, now):
                self._chunked_prefill.cancel_row(row)
                self._fail(req, "timed_out", DeadlineExceeded(
                    "deadline expired mid-prefill "
                    f"({req.deadline_ms:.1f}ms)", rid=req.rid))
        for b, req in enumerate(self.live):
            if req is not None and self._expired(req, now):
                self.live[b] = None
                self._fail(req, "timed_out", DeadlineExceeded(
                    "deadline expired mid-decode after "
                    f"{len(req.out)} tokens ({req.deadline_ms:.1f}ms)",
                    rid=req.rid))
        for req in self.scheduler.starved_out(self.queue, self.live, now):
            self.queue.remove(req)
            wait_ms = (now - req.submit_t) * 1e3
            self._fail(req, "timed_out", StarvationTimeout(
                f"class-{req.priority} request starved for {wait_ms:.1f}ms "
                f"(> {self.scheduler.starve_ms:.1f}ms bound) behind "
                "higher-priority work", rid=req.rid))
            self.stats["starvation_timeouts"] += 1
            self._m_starved.inc()

    def _admission_estimate_ms(self, req: Request) -> Optional[float]:
        """Latency estimate from the per-(phase, bucket) latency model:
        prefill at the rung covering the prompt, decode at the rung the
        request finishes under; None until either phase has a steady
        sample."""
        plen, mnew = len(req.prompt), req.max_new
        ptok = self.telemetry.estimate(
            "prefill", clamped_bucket(plen, self.kv_extent))
        tpot = self.telemetry.estimate(
            "decode", clamped_bucket(plen + mnew, self.kv_extent))
        if ptok is None and tpot is None:
            return None
        return plen * (ptok or 0.0) + mnew * (tpot or 0.0)

    def _host_pos_cache(self):
        """The cache with the host's per-slot positions as its ``pos``."""
        return dict(self.cache,
                    pos=torch.from_numpy(self.pos.astype(np.int32)))

    # ----------------------------------------------------------- admission
    def _restore(self, b: int, req: Request) -> bool:
        """Re-admit a preempted request from its host blob into slot ``b``,
        in place.  A corrupted blob fails the request (CacheCorruption),
        not the engine; returns False and leaves the slot free."""
        try:
            restore_slot(self.cache, req.blob, b, rid=req.rid,
                         metrics=self.metrics, expect_tags={"rid": req.rid})
        except CacheCorruption as e:
            self._fail(req, "failed", e)
            return False
        self.tokens[b, 0] = req.next_token
        self.pos[b] = req.resume_pos
        self.live[b] = req
        # the validated preemption blob doubles as the replay checkpoint
        req.ckpt_blob = req.blob
        req.ckpt_token = req.next_token
        req.ckpt_pos = req.resume_pos
        req.ckpt_out = len(req.out)
        req.blob = None
        self.stats["restores"] += 1
        self._m_restore.inc()
        self.telemetry.event(req.rid, "restore", pos=req.resume_pos)
        return True

    def _admit(self, it: int) -> None:
        ch = self._chunked_prefill
        # a group whose every request already reached a terminal state is
        # inert work: drop it
        if ch.active and self._pending and all(r.done
                                               for _, r in self._pending):
            ch.finish()
            self._pending = []
        reserved = {b for b, r in self._pending if not r.done}
        free = [b for b in range(self.slots)
                if self.live[b] is None and b not in reserved]
        # fill free slots in scheduler order: preempted requests restore in
        # place, fresh prompts form one mixed-length prefill group; a fresh
        # prompt that cannot start (a group is in flight) ends the walk
        fresh: List[Request] = []
        order = self.scheduler.admission_order(self.queue, self._clock())
        for req in order:
            if not free:
                break
            if req.blob is not None:
                self.queue.remove(req)
                b = free.pop(0)
                if self._restore(b, req):
                    self._progress = True
                else:
                    free.insert(0, b)
            elif not ch.active:
                if req.deadline_ms is not None:
                    est = self._admission_estimate_ms(req)
                    left = (req.deadline_ms
                            - (self._clock() - req.submit_t) * 1e3)
                    if est is not None and est > left:
                        self.queue.remove(req)
                        self._fail(req, "cancelled", DeadlineExceeded(
                            f"admission reject: estimated {est:.1f}ms "
                            f"exceeds remaining {left:.1f}ms budget",
                            rid=req.rid))
                        continue
                self.queue.remove(req)
                fresh.append(req)
                self._pending.append((free.pop(0), req))
            else:
                break
        if fresh:
            ch.start([r.prompt for r in fresh],
                     batch=self.slots if len(fresh) > 1 else 1,
                     priorities=[r.priority for r in fresh])
            self._m_admitted.inc(len(fresh))
            self._m_queue.set(len(self.queue))
        stalled = self.faults.active and self.faults.stalled(it)
        run_chunk = ch.active and not stalled
        if run_chunk:
            # a policy may grant the group a fractional share next to
            # higher-class decode slots; with none live it always runs
            live_cls = [r.priority for r in self.live if r is not None]
            share = 1.0 if not live_cls else min(1.0, max(
                0.0, self.scheduler.interleave_share(
                    [r.priority for _, r in self._pending if not r.done],
                    live_cls)))
            self._prefill_credit += share
            if self._prefill_credit >= 1.0:
                self._prefill_credit -= 1.0
            else:
                run_chunk = False
                self._starved = 0
        if run_chunk:
            self._run_chunk(ch)
        elif self.queue and not free and not ch.active and not stalled:
            # queue starved: no slot freed and nothing is prefilling; the
            # policy may demand preemption at once (a higher class waits)
            self._starved += 1
            if (self._starved >= self.preempt_after
                    or self.scheduler.urgent_preempt(self.queue, self.live)):
                self._preempt()
        elif not stalled and not ch.active:
            self._starved = 0

    def _run_chunk(self, ch: ChunkedPrefill) -> None:
        t0 = self._clock()
        emitted, done, diverged = ch.step()
        t1 = self._clock()
        dt_ms = (t1 - t0) * 1e3
        info = ch.last_chunk
        self._chunk_ran = True
        self._progress = True
        self.stats["prefill_chunks"] += 1
        # per-token cost over the group's valid tokens, the first dispatch
        # of a (batch, bucket) combination kept apart as a compile sample
        if info["valid_tokens"] > 0:
            tok_ms = dt_ms / info["valid_tokens"]
            self.telemetry.record_latency(
                "prefill", info["bucket"], tok_ms,
                compiled=info["fresh_compile"])
            if not info["fresh_compile"] and tok_ms > 0:
                self._m_tps.labels(phase="prefill").set(1e3 / tok_ms)
            self._m_tokens.labels(phase="prefill").inc(info["valid_tokens"])
        self._m_prefill_ms.observe(dt_ms)
        self.profiler.observe("prefill", dt_ms)
        self._prefill_seen.add((ch.group_cache["pos"].shape[0],
                                info["bucket"]))
        for row, (b, req) in enumerate(self._pending):
            if not req.done and info["valid_per_row"][row]:
                tokens = int(info["valid_per_row"][row])
                self.telemetry.event(req.rid, "prefill",
                                     bucket=info["bucket"], tokens=tokens)
                self.scheduler.note_service(req.priority, tokens)
                self._m_class_tokens.labels(
                    priority=str(req.priority), phase="prefill").inc(tokens)
        for row in diverged:
            b, req = self._pending[row]
            if not req.done:
                self.telemetry.event(req.rid, "fault",
                                     detail="prefill_divergence")
                self._fail(req, "failed", DivergenceDetected(
                    "non-finite activations in prefill chunk "
                    f"{ch._group['idx'] - 1}", rid=req.rid))
        if emitted:
            dst = np.full((ch.group_cache["pos"].shape[0],), -1, np.int64)
            for row, tok, plen in emitted:
                b, req = self._pending[row]
                if req.done:                 # expired/failed while pending
                    continue
                dst[row] = b
                req.out.append(tok)
                req.first_t = t1
                self.tokens[b, 0] = tok
                self.pos[b] = plen
                self.live[b] = req
                ttft = self.telemetry.first_token(req.rid)
                if ttft is not None:
                    self._m_ttft.labels(
                        priority=str(req.priority)).observe(ttft)
            _scatter_group(self.cache, ch.group_cache, dst)
        if done:
            ch.finish()
            self._pending = []
        self._starved = 0

    def _preempt(self) -> None:
        """Offload one live slot so a starved queued prompt can take it next
        iteration.  Every live slot's deadline slack is costed under the
        latency model (deadline-less slots: infinite slack) and the
        scheduler names the victim."""
        now = self._clock()
        candidates: List[VictimCandidate] = []
        for b, req in enumerate(self.live):
            if req is None:
                continue
            remaining = req.max_new - len(req.out)
            if req.deadline_ms is None:
                slack = float("inf")
            else:
                tpot = self.telemetry.estimate("decode", clamped_bucket(
                    int(self.pos[b]) + remaining, self.kv_extent)) or 0.0
                slack = (req.deadline_ms - (now - req.submit_t) * 1e3
                         - remaining * tpot)
            candidates.append(VictimCandidate(
                slot=b, priority=req.priority, slack=slack,
                remaining=remaining))
        b = self.scheduler.preempt_victim(candidates, self.queue)
        if b is None:
            return
        req = self.live[b]
        blob = offload_slot(self._host_pos_cache(), b,
                            tags={"rid": req.rid, "priority": req.priority})
        if self.faults.active:
            blob = self.faults.corrupt_blob(req.rid, blob)
        req.blob = blob
        req.next_token = int(self.tokens[b, 0])
        req.resume_pos = int(self.pos[b])
        req.preemptions += 1
        if self.store is not None:
            # a preemption blob is a consistent resume point: persist it
            self.store.stage_blob(req.rid, blob)
            self._persist_request(req, state="preempted",
                                  next_token=req.next_token,
                                  pos=req.resume_pos)
            self.store.commit()
        self.telemetry.event(req.rid, "preempt", pos=int(self.pos[b]))
        self.live[b] = None
        self.queue.append(req)
        self._starved = 0
        self.stats["preemptions"] += 1
        self._m_preempt.inc()

    # --------------------------------------------------------- checkpoints
    def _checkpoint(self, it: int) -> None:
        """Offload each live slot as its divergence-replay target every
        ``checkpoint_every`` iterations, and at each request's first burst.
        Taken at a burst boundary, where the host's ``pos``/``tokens`` and
        the cache's own leaves agree; only the due slots' rows cross to
        the host."""
        if not self.checkpoint_every:
            return
        due = it % self.checkpoint_every == 0
        need = [(b, r) for b, r in enumerate(self.live)
                if r is not None and (due or r.ckpt_blob is None)]
        if not need:
            return
        t0 = self._clock()
        blobs = offload_slots(self._host_pos_cache(), [b for b, _ in need],
                              metrics=self.metrics,
                              tags={b: {"rid": r.rid, "priority": r.priority}
                                    for b, r in need})
        for b, req in need:
            blob = blobs[b]
            if self.faults.active:
                blob = self.faults.corrupt_blob(req.rid, blob)
            req.ckpt_blob = blob
            req.ckpt_token = int(self.tokens[b, 0])
            req.ckpt_pos = int(self.pos[b])
            req.ckpt_out = len(req.out)
            if self.store is not None:
                self.store.stage_blob(req.rid, blob)
                self._persist_request(req, state="live",
                                      next_token=req.ckpt_token,
                                      pos=req.ckpt_pos)
            self.stats["checkpoints"] += 1
            self._m_ckpts.inc()
            self._m_ckpt_bytes.inc(blob_nbytes(blob))
            self.telemetry.event(req.rid, "checkpoint")
        if self.store is not None:
            # crash point 1: blob files staged, manifest not yet committed
            if self.faults.active and self.faults.kill_now(it, point=1):
                raise SimulatedCrash(
                    "fault injection: kill between checkpoint stage and "
                    f"manifest commit at iteration {it}")
            self.store.commit()
        # the healthy-path budget: ckpt_ms against the run's wall time
        self.stats["ckpt_ms"] += (self._clock() - t0) * 1e3

    def _quarantine(self, b: int, req: Request) -> None:
        """The sentinel tripped for slot ``b``: none of the burst's tokens
        are taken.  Restore the slot from its last checkpoint, in place,
        and replay once; on a second trip (or without a good checkpoint)
        fail the request with ``DivergenceDetected``."""
        self.stats["divergences"] += 1
        self._m_diverg.inc()
        self.telemetry.event(req.rid, "fault", detail="decode_divergence")
        if (self.checkpoint_every and req.ckpt_blob is not None
                and req.replays < 1):
            try:
                restore_slot(self.cache, req.ckpt_blob, b, rid=req.rid,
                             metrics=self.metrics,
                             expect_tags={"rid": req.rid})
            except CacheCorruption as e:
                self.live[b] = None
                self._fail(req, "failed", e)
                return
            self.tokens[b, 0] = req.ckpt_token
            self.pos[b] = req.ckpt_pos
            del req.out[req.ckpt_out:]
            req.replays += 1
            self.stats["replays"] += 1
            self._m_replays.inc()
            self.telemetry.event(req.rid, "replay", pos=req.ckpt_pos)
        else:
            self.live[b] = None
            self._fail(req, "failed", DivergenceDetected(
                "non-finite logits in decode burst"
                + (" after checkpoint replay" if req.replays else
                   " (no checkpoint to replay)"), rid=req.rid))

    # ------------------------------------------------------------ watchdog
    def _watchdog(self, decoded: int) -> None:
        waiting = bool(self.queue) or any(not r.done
                                          for _, r in self._pending)
        if decoded or self._progress or not waiting:
            self._no_progress = 0
            return
        self._no_progress += 1
        if self._no_progress < self.stall_after:
            return
        self._no_progress = 0
        self.stats["watchdog_trips"] += 1
        self._m_watchdog.inc()
        stuck = [(row, req) for row, (b, req) in enumerate(self._pending)
                 if not req.done]
        if stuck:
            for row, req in stuck:
                self._chunked_prefill.cancel_row(row)
                self._fail(req, "failed", SlotStalled(
                    f"no progress for {self.stall_after} iterations with "
                    "prefill in flight", rid=req.rid))
            if self._chunked_prefill.active:
                self._chunked_prefill.finish()
            self._pending = []
        elif self.queue:
            req = self.queue.pop(0)
            self._fail(req, "failed", SlotStalled(
                f"no progress for {self.stall_after} iterations at the "
                "head of the queue", rid=req.rid))

    def _open_pending(self) -> int:
        return sum(1 for _, r in self._pending if not r.done)

    # ------------------------------------------------------------- decode
    def step(self) -> int:
        """One engine iteration: one admission move (prefill chunk or
        restore), then a ``decode_block`` burst for all live slots.
        Returns live + queued + in-prefill.  Never raises for in-flight
        faults."""
        it = self.stats["iters"]
        # crash point 0: between iterations, before any state mutates
        if self.faults.active and self.faults.kill_now(it):
            raise SimulatedCrash(
                f"fault injection: kill at engine iteration {it}")
        self.stats["iters"] += 1
        self._chunk_ran = False
        self._progress = False
        self._expire_deadlines()
        self._admit(it)
        chunk_ran = self._chunk_ran
        if not any(req is not None for req in self.live):
            self._watchdog(decoded=0)
            return len(self.queue) + self._open_pending()
        self._checkpoint(it)
        if self.faults.active:
            for b in self.faults.nan_decode_slots(it):
                if 0 <= b < self.slots:
                    poison_slot(self.cache, b)
        kblk = self.decode_block
        kv_bucket = None
        if self.kv_buckets:
            live_pos = [int(self.pos[b]) for b, r in enumerate(self.live)
                        if r is not None]
            kv_bucket = clamped_bucket(max(live_pos) + kblk, self.kv_extent)
            self.buckets_used.add(kv_bucket)
        fresh_compile = kv_bucket not in self._decode_seen
        self._decode_seen.add(kv_bucket)
        if kv_bucket is not None and kv_bucket > self._max_bucket:
            if self._max_bucket >= 0:
                self._m_climbs.inc()
            self._max_bucket = kv_bucket
        t0 = self._clock()
        # host tokens and positions: the burst copies them into its inputs
        out = self._decode_n(
            self.params, self._host_pos_cache(),
            torch.from_numpy(self.tokens), kblk, kv_bucket=kv_bucket,
            rope_len=self.rope_len, with_sentinel=self.sentinel,
            spare=self._spare)
        self.cache = out[1]
        # the burst's one host transfer: tokens and sentinel flags together
        if self.sentinel:
            host = torch.cat([out[0], out[2][:, None].to(torch.int32)],
                             1).cpu().numpy()
            toks, okh = host[:, :kblk], host[:, kblk]
        else:
            toks, okh = out[0].cpu().numpy(), None
        t1 = self._clock()
        dt_ms = (t1 - t0) * 1e3
        self.telemetry.record_latency("decode", kv_bucket, dt_ms / kblk,
                                      compiled=fresh_compile)
        self._m_decode_ms.observe(dt_ms)
        self.profiler.observe("decode", dt_ms)
        if not fresh_compile and dt_ms > 0:
            self._m_tps.labels(phase="decode").set(kblk * 1e3 / dt_ms)
        n_live = 0
        decoded = 0
        for b, req in enumerate(self.live):
            if req is None:
                continue
            if okh is not None and not bool(okh[b]):
                self._quarantine(b, req)
                if self.live[b] is not None:
                    n_live += 1
                continue
            room = min(req.max_new - len(req.out),
                       self.max_seq - 1 - int(self.pos[b]))
            take = min(kblk, max(room, 0))
            req.out.extend(int(t) for t in toks[b, :take])
            decoded += take
            if take:
                self.tokens[b, 0] = int(toks[b, take - 1])
                self.telemetry.event(req.rid, "decode", bucket=kv_bucket,
                                     tokens=take)
                self.scheduler.note_service(req.priority, take)
                self._m_class_tokens.labels(
                    priority=str(req.priority), phase="decode").inc(take)
            self.pos[b] += take
            if len(req.out) >= req.max_new or self.pos[b] >= self.max_seq - 1:
                req.done = True
                req.status = "ok"
                req.finish_t = t1
                req.ckpt_blob = None
                self.finished.append(req)
                self._m_finished.labels(status="ok").inc()
                self.telemetry.end_span(req.rid, "ok",
                                        tokens_out=len(req.out))
                self._forget_request(req)
                self.live[b] = None
            else:
                n_live += 1
        self.stats["decode_tokens"] += decoded
        self._m_tokens.labels(phase="decode").inc(decoded)
        self._m_live.set(n_live)
        self._m_queue.set(len(self.queue))
        if chunk_ran:
            self.stats["interleave_iters"] += 1
            if decoded:
                self.stats["interleave_decode_iters"] += 1
        self._watchdog(decoded)
        return n_live + len(self.queue) + self._open_pending()

    def run(self, max_iters: Optional[int] = None) -> List[Request]:
        """Drive :meth:`step` until all work reaches a terminal state.  Past
        ``max_iters`` iterations every queued and in-flight request is
        cancelled (``SlotStalled`` names the bound) and the engine
        returns."""
        try:
            while self.step() or self.queue or self._open_pending():
                if max_iters is not None and self.stats["iters"] >= max_iters:
                    self._abort_inflight("cancelled", SlotStalled(
                        f"run(max_iters={max_iters}) exhausted with work "
                        "outstanding"))
                    break
        finally:
            # persist the latency model and flush metrics (no-ops without
            # a path)
            self.telemetry.save_warmstart()
            self.metrics.export()
            if self.store is not None:
                self.store.commit()
        return self.finished

    def profile_snapshot(self) -> Dict[str, Any]:
        """The profiler's per-kernel-family attribution.  In coarse mode
        the representative programs are registered lazily here, so the
        walk's cost lands on the caller asking for shares, never on the
        serving loop: ``decode``, one burst of ``decode_block`` steps at
        the deepest KV bucket the loop ran, as the reference registers
        it; and ``prefill``, one chunk at the largest (group batch, KV
        bucket) dispatched, which the reference leaves unregistered (its
        prefill wall stays unattributed).  Each is the static walk
        (:mod:`repro_torch.core.op_analysis`) on ``meta`` copies of the
        engine's params and cache: the card's program, each hand-written
        kernel one op, nothing allocated."""
        prof = self.profiler
        if prof.mode == "coarse":
            if not prof.registered("decode") and self._decode_seen:
                kv_bucket = max((b for b in self._decode_seen
                                 if b is not None), default=None)
                cache = meta_like(self.cache)
                prof.register("decode", analyze(
                    decode_tokens, self.cfg, meta_like(self.params), cache,
                    torch.zeros((self.slots, 1), dtype=torch.int32,
                                device="meta"), self.decode_block,
                    kv_bucket=kv_bucket, rope_len=self.rope_len,
                    with_sentinel=self.sentinel,
                    _spare_states=init_spare_states(cache)))
            if not prof.registered("prefill") and self._prefill_seen:
                batch, kv_bucket = max(self._prefill_seen,
                                       key=lambda s: (s[0], s[1] or 0))
                cache = init_lm_cache(self.cfg, batch, self.max_seq,
                                      device="meta")
                prof.register("prefill", analyze(
                    lm_prefill_chunk, self.cfg, meta_like(self.params),
                    torch.zeros((batch, self.chunk_size), dtype=torch.long,
                                device="meta"), cache,
                    lengths=torch.full((batch,), self.chunk_size,
                                       dtype=torch.int32, device="meta"),
                    kv_bucket=kv_bucket, rope_len=self.rope_len,
                    with_sentinel=self.sentinel))
        return prof.snapshot()

    def _abort_inflight(self, status: str, err: RequestError) -> None:
        for req in self.queue:
            self._fail(req, status, err)
        self.queue = []
        for row, (b, req) in enumerate(self._pending):
            if not req.done:
                self._chunked_prefill.cancel_row(row)
                self._fail(req, status, err)
        if self._chunked_prefill.active:
            self._chunked_prefill.finish()
        self._pending = []
        for b, req in enumerate(self.live):
            if req is not None:
                self.live[b] = None
                self._fail(req, status, err)
