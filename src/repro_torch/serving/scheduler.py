"""Policy-driven request scheduling for the serving engine.

The port's copy of the reference's ``serving/scheduler.py``.  The engine
keeps the mechanism (dispatch, offload and restore, terminal states) and
asks a :class:`Scheduler` for every decision:

* **admission order** — which queued requests (fresh prompts and
  preempted restores alike) are considered first when slots free up;
* **preemption** — whether starvation warrants evicting a live slot now
  (:meth:`Scheduler.urgent_preempt`) and which slot to evict
  (:meth:`Scheduler.preempt_victim` over slack-costed candidates);
* **expiry** — whether a request's deadline has burned out
  (:meth:`Scheduler.expired`) and whether a queued request has waited
  past the policy's starvation bound (:meth:`Scheduler.starved_out`);
* **interleave share** — what fraction of engine iterations the
  in-flight prefill group may claim next to live decode slots.

Requests carry a small non-negative integer ``priority`` class (higher =
more important; default 0).  Three policies: ``fifo`` (submit order,
slack-based victims, the default), ``strict_tiers`` (higher classes
first, immediate upward preemption, ``starve_ms`` fails outranked
waiters) and ``weighted_fair`` (deficit-round-robin token credit per
class, ``starve_ms`` ages waiters to the front).  Policies reorder work,
never math: every request's tokens are the same under each policy.
:func:`make_scheduler` takes the policy, weights and bound as arguments;
the port reads no environment.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

#: policies make_scheduler accepts
POLICIES = ("fifo", "strict_tiers", "weighted_fair")

#: DRR credit quantum (tokens per deficit round per unit weight)
DEFAULT_QUANTUM = 64


@dataclass(frozen=True)
class VictimCandidate:
    """One live slot offered to :meth:`Scheduler.preempt_victim`.

    ``slack`` is the engine-estimated deadline margin in ms (infinite
    for deadline-less requests) under the telemetry latency model —
    cost estimation is mechanism and stays in the engine; the policy
    only ranks the candidates."""

    slot: int
    priority: int
    slack: float
    remaining: int


def parse_weights(spec: Optional[str]) -> Dict[int, float]:
    """Parse a weights string (``"0:1,1:4,2:16"``) into a
    ``{class: weight}`` dict.  Empty/None -> {} (every class weighs 1).
    Malformed entries raise ``ValueError`` naming the offending pair —
    a silently dropped weight would skew fairness without a trace."""
    if not spec:
        return {}
    out: Dict[int, float] = {}
    for pair in spec.split(","):
        pair = pair.strip()
        if not pair:
            continue
        cls_s, sep, w_s = pair.partition(":")
        try:
            if not sep:
                raise ValueError("missing ':'")
            cls, w = int(cls_s), float(w_s)
            if cls < 0 or w <= 0:
                raise ValueError("class must be >= 0 and weight > 0")
        except ValueError as e:
            raise ValueError(
                f"scheduler weights entry {pair!r} is malformed "
                f"(want 'class:weight', e.g. '1:4'): {e}") from None
        out[cls] = w
    return out


class Scheduler:
    """Base policy: FIFO admission, slack-based preemption, deadline
    expiry, no starvation bound, full prefill interleave.  This IS the
    ``fifo`` policy — subclasses override only the decisions they
    change, so the fifo rows below double as the protocol's defaults."""

    policy = "fifo"

    def __init__(self, weights: Optional[Dict[int, float]] = None,
                 starve_ms: Optional[float] = None):
        self.weights = dict(weights or {})
        self.starve_ms = starve_ms
        self._served: Dict[int, float] = {}

    # ------------------------------------------------------------- helpers
    def weight(self, priority: int) -> float:
        return self.weights.get(priority, 1.0)

    def wait_ms(self, req, now: float) -> float:
        return (now - req.submit_t) * 1e3

    # ----------------------------------------------------------- decisions
    def admission_order(self, queue: Sequence, now: float) -> List:
        """Queued requests (fresh + preempted restores) in the order the
        engine should admit them.  Must be a permutation of ``queue``."""
        return list(queue)

    def expired(self, req, now: float) -> bool:
        """Has this request's deadline TTL burned out?"""
        return (req.deadline_ms is not None
                and self.wait_ms(req, now) > req.deadline_ms)

    def starved_out(self, queue: Sequence, live: Sequence,
                    now: float) -> List:
        """Queued requests the policy gives up on (the engine fails them
        with ``StarvationTimeout``).  Default: never — FIFO head-of-line
        order cannot starve, and weighted_fair escalates instead."""
        return []

    def urgent_preempt(self, queue: Sequence, live: Sequence) -> bool:
        """Should the engine preempt NOW, without waiting out its
        ``preempt_after`` starvation counter?"""
        return False

    def preempt_victim(self, candidates: Sequence[VictimCandidate],
                       queue: Sequence) -> Optional[int]:
        """Slot to evict for a starved queue (None = nobody).  Default:
        most deadline slack, ties broken on max remaining decode work —
        deadline-less slots rank as infinite slack."""
        best: Optional[Tuple[Tuple[float, int], int]] = None
        for c in candidates:
            key = (c.slack, c.remaining)
            if best is None or key > best[0]:
                best = (key, c.slot)
        return None if best is None else best[1]

    def interleave_share(self, group_classes: Sequence[int],
                         live_classes: Sequence[int]) -> float:
        """Fraction of engine iterations the in-flight prefill group may
        claim (1.0 = one chunk every iteration, the historical
        behaviour).  The engine clamps to (0, 1] and always runs the
        chunk when no slot is decoding."""
        return 1.0

    # ---------------------------------------------------------- accounting
    def note_service(self, priority: int, tokens: int) -> None:
        """Record ``tokens`` of prefill/decode service for a class (the
        DRR debit hook; base policies only keep the served totals the
        fairness benchmarks read)."""
        if tokens:
            self._served[priority] = self._served.get(priority, 0.0) + tokens

    def class_service(self) -> Dict[int, float]:
        """Tokens served per priority class since construction."""
        return dict(self._served)


class StrictTiersScheduler(Scheduler):
    """Strict priority tiers: a higher class always outranks a lower one.

    Admission sorts by class (descending, submit order within a class),
    a queued request of a strictly higher class triggers immediate
    preemption, and the victim is always the lowest-class live slot
    (slack-ranked within the class).  Strictness is honest about its
    cost: under sustained high-class load a low-class request waits
    unboundedly, so ``starve_ms`` fails outranked waiters with
    ``StarvationTimeout`` instead of letting them rot invisibly."""

    policy = "strict_tiers"

    def admission_order(self, queue: Sequence, now: float) -> List:
        return sorted(queue, key=lambda r: -r.priority)   # stable

    def starved_out(self, queue: Sequence, live: Sequence,
                    now: float) -> List:
        if self.starve_ms is None:
            return []
        classes = [r.priority for r in queue] + \
                  [r.priority for r in live if r is not None]
        top = max(classes, default=0)
        return [r for r in queue
                if r.priority < top and self.wait_ms(r, now) > self.starve_ms]

    def urgent_preempt(self, queue: Sequence, live: Sequence) -> bool:
        live_cls = [r.priority for r in live if r is not None]
        if not queue or not live_cls:
            return False
        return max(r.priority for r in queue) > min(live_cls)

    def preempt_victim(self, candidates: Sequence[VictimCandidate],
                       queue: Sequence) -> Optional[int]:
        if not candidates:
            return None
        top_queued = max((r.priority for r in queue), default=0)
        low = min(c.priority for c in candidates)
        if top_queued <= low:
            # never evict a slot for an equal-or-lower class: strict
            # tiers preempt upward only, equal classes wait their turn
            return None
        pool = [c for c in candidates if c.priority == low]
        return super().preempt_victim(pool, queue)

    def interleave_share(self, group_classes: Sequence[int],
                         live_classes: Sequence[int]) -> float:
        # a lower-class group prefilling next to higher-class decode
        # slots yields half its iterations to decode latency
        if not group_classes or not live_classes:
            return 1.0
        return 1.0 if max(group_classes) >= max(live_classes) else 0.5


class WeightedFairScheduler(Scheduler):
    """Weighted fairness via deficit-round-robin token accounting.

    Each class carries a deficit counter.  A *round* fires only when
    every class with queued work has exhausted its credit (<= 0); the
    round then banks ``quantum x weight(class)`` on top of the residual
    deficit, exactly DRR.  Crediting only on exhaustion is what makes
    the accounting converge: a per-call unconditional credit would pin
    high-weight classes at their cap and degenerate into strict tiers.
    Every prefill/decode token the engine processes debits its class
    (:meth:`note_service`).  Admission order is by credit (most
    under-served first), so sustained-backlog throughput converges to
    the weight ratios.  ``starve_ms`` is an aging bound: a
    request waiting longer jumps the entire order whatever its class,
    so low-weight classes are late, never starved."""

    policy = "weighted_fair"

    def __init__(self, weights: Optional[Dict[int, float]] = None,
                 starve_ms: Optional[float] = None,
                 quantum: int = DEFAULT_QUANTUM):
        super().__init__(weights, starve_ms)
        self.quantum = int(quantum)
        self._credit: Dict[int, float] = {}

    def _credit_round(self, classes) -> None:
        present = set(classes)
        if present and all(self._credit.get(c, 0.0) <= 0.0
                           for c in present):
            for c in present:
                self._credit[c] = (self._credit.get(c, 0.0)
                                   + self.quantum * self.weight(c))

    def admission_order(self, queue: Sequence, now: float) -> List:
        self._credit_round(r.priority for r in queue)
        if self.starve_ms is not None:
            aged = [r for r in queue
                    if self.wait_ms(r, now) > self.starve_ms]
            if aged:
                aged_set = {id(r) for r in aged}
                aged.sort(key=lambda r: -self.wait_ms(r, now))
                rest = [r for r in queue if id(r) not in aged_set]
                rest.sort(key=lambda r: -self._credit.get(r.priority, 0.0))
                return aged + rest
        return sorted(queue,
                      key=lambda r: -self._credit.get(r.priority, 0.0))

    def note_service(self, priority: int, tokens: int) -> None:
        super().note_service(priority, tokens)
        if tokens:
            self._credit[priority] = \
                self._credit.get(priority, 0.0) - tokens

    def preempt_victim(self, candidates: Sequence[VictimCandidate],
                       queue: Sequence) -> Optional[int]:
        if not candidates:
            return None
        # evict the class furthest OVER its weighted share (most-negative
        # normalized credit); slack-rank within that class
        def over_share(c: VictimCandidate) -> float:
            return -self._credit.get(c.priority, 0.0) / self.weight(c.priority)
        worst = max(over_share(c) for c in candidates)
        pool = [c for c in candidates if over_share(c) == worst]
        return super().preempt_victim(pool, queue)

    def interleave_share(self, group_classes: Sequence[int],
                         live_classes: Sequence[int]) -> float:
        if not group_classes or not live_classes:
            return 1.0
        g = sum(self.weight(c) for c in group_classes)
        l = sum(self.weight(c) for c in live_classes)
        return max(0.25, min(1.0, g / (g + l) * 2.0))


_POLICY_CLASSES = {
    "fifo": Scheduler,
    "strict_tiers": StrictTiersScheduler,
    "weighted_fair": WeightedFairScheduler,
}


def make_scheduler(policy: Optional[str] = None,
                   weights: Optional[Dict[int, float]] = None,
                   starve_ms: Optional[float] = None) -> Scheduler:
    """Build a scheduler; ``policy`` None is ``fifo``.  Unknown policies
    raise — a typo'd policy silently degrading to fifo would be
    unobservable."""
    policy = policy or "fifo"
    if policy not in _POLICY_CLASSES:
        raise ValueError(
            f"unknown scheduling policy {policy!r}: expected one of "
            f"{POLICIES} (the engine's sched_policy argument)")
    return _POLICY_CLASSES[policy](weights=weights or {},
                                   starve_ms=starve_ms)
