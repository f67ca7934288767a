"""Failure taxonomy + request terminal states for the serving layer.

The paper's serving regime — multi-minute 57K-token requests on
memory-constrained edge devices — makes silent corruption the dominant
failure mode: one NaN burst or one bad preemption blob poisons a whole
continuous-batching group unless the engine can name the failure,
quarantine the request, and keep its co-batched neighbours bit-exact.
This module is the shared vocabulary: a structured exception hierarchy
(every engine-surfaced failure is a :class:`RequestError` subclass
carrying the offending ``rid``) and the closed set of per-request
terminal states recorded on ``Request.status``.

The port's copy of the reference's taxonomy, word for word in its
classes and messages.  State machine:

    pending --admit--> live --ok--------------------> ok
       |                |---divergence--> quarantined --replay--> live
       |                |                     `--no checkpoint/2nd trip--> failed
       |                |---deadline------------------------------> timed_out
       |                `---corrupt restore blob------------------> failed
       |---deadline (queued / can't-meet estimate)--> timed_out / cancelled
       |---starved out (strict_tiers starve_ms)-----> timed_out
       `---watchdog (no progress) / max_iters-------> failed / cancelled

The engine NEVER raises one of these during :meth:`ServingEngine.run`:
they are attached to the failing request (``Request.error``) and the
request is moved to ``finished`` with a non-``"ok"`` status.  Raising is
reserved for caller bugs (e.g. submitting an out-of-vocab prompt).
"""
from __future__ import annotations

from typing import Optional

#: Closed set of terminal request states (``Request.status``).
#: ``ok``        — decoded to completion.
#: ``failed``    — quarantined by a fault (divergence after replay, blob
#:                 corruption, watchdog stall) — see ``Request.error``.
#: ``cancelled`` — never ran / cut short by policy (deadline-infeasible at
#:                 admission, ``run(max_iters=...)`` bail-out).
#: ``timed_out`` — the request's ``deadline_ms`` expired while queued or
#:                 in flight.
TERMINAL_STATES = ("ok", "failed", "cancelled", "timed_out")


class RequestError(Exception):
    """Base class for structured serving failures.

    ``rid`` names the offending request where one is known (blob
    corruption detected outside the engine carries ``rid=None``)."""

    def __init__(self, msg: str, *, rid: Optional[int] = None):
        self.rid = rid
        super().__init__(msg if rid is None else f"rid={rid}: {msg}")


class DeadlineExceeded(RequestError):
    """The request's ``deadline_ms`` budget is unmeetable or exhausted —
    rejected at admission (estimated latency exceeds the remaining
    budget) or cancelled in flight (queued / mid-prefill / mid-decode)."""


class DivergenceDetected(RequestError):
    """A decode burst or prefill chunk produced non-finite activations for
    this request's row (per-row on-device ``isfinite`` sentinel).  Raised
    terminally only after the one checkpoint-replay attempt also trips
    (or when no checkpoint exists to replay from)."""


class CacheCorruption(RequestError):
    """An offloaded cache blob failed validation on restore: key set
    differs from the slot template, per-key schema (shape/dtype) does not
    match, or a payload crc32 mismatches.  ``key`` names the first
    offending blob entry when the damage is key-local."""

    def __init__(self, msg: str, *, rid: Optional[int] = None,
                 key: Optional[str] = None):
        self.key = key
        super().__init__(msg if key is None else f"{msg} (key: {key})",
                         rid=rid)


class RecoveryFailed(RequestError):
    """A persisted request record could not be reconstructed at engine
    restart: the stored prompt fails its recorded crc32 (or the record is
    otherwise internally inconsistent), so neither restore-from-blob nor
    replay-from-prompt can produce the original stream.  Corrupt *blobs*
    never raise this — they degrade to replay-from-prompt; this is for
    records where even replay would decode a different request."""


class SlotStalled(RequestError):
    """The engine's no-progress watchdog tripped: N consecutive iterations
    decoded zero tokens and advanced no prefill chunk while work was
    queued — the stranded request is failed so the host loop can't hang
    forever behind it."""


class StarvationTimeout(RequestError):
    """A queued request waited past the scheduler's starvation bound
    (``starve_ms``) while outranked by higher-priority work.  Only the
    ``strict_tiers`` policy gives up this way — strict tiers can starve a
    low class indefinitely under sustained high-class load, and a
    structured failure (status ``timed_out``) beats rotting invisibly at
    the back of the queue.  ``weighted_fair`` honours the same bound by
    escalating (aging) instead of failing."""
