"""Deterministic fault injection for the serving engine.

The port's copy of the reference's ``serving/fault_inject.py``.  A plan
says which engine iteration poisons which slot, which request's offload
blob gets a bit flipped, when prefill progress freezes and when the
process dies, so every recovery path (divergence sentinels and
checkpoint replay, blob validation, the watchdog, the durable store)
runs reproducibly.  Nothing is random at run time but the flipped bit,
drawn from a ``numpy`` generator seeded from the plan's ``seed`` and the
request id, so one spec and seed corrupt the same byte every run (the
same byte the reference's plan picks).  A plan is built from its spec
string, :meth:`FaultPlan.from_spec`; the port reads no environment.

Spec grammar::

    spec    := clause ("," clause)*
    clause  := kind ["@" param (":" param)*]
    param   := key "=" value          # value: int, or rNN for rid keys

    nan_decode@iter=I[:slot=S][:n=N]   poison slot S's cache with NaN
                                       right before the decode burst of
                                       engine iteration >= I (N times;
                                       n=-1 -> every iteration from I on)
    nan_prefill@chunk=C[:row=R][:n=N]  poison row R of the in-flight
                                       prefill group's cache before its
                                       group-local chunk C runs
    corrupt_blob@rid=R[:n=N]           flip one bit in request R's next
                                       offload blob (preemption or
                                       checkpoint)
    stall@iter=I[:n=N]                 freeze prefill progress starting
                                       at engine iteration I (for N
                                       iterations; default forever)
    kill@iter=I[:point=P][:n=N]        raise :class:`SimulatedCrash` at
                                       engine iteration >= I.  point=0
                                       (default) kills between
                                       iterations; point=1 inside the
                                       checkpoint, after blob files are
                                       staged and before the manifest
                                       commit

An empty plan short-circuits every hook.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

KINDS = ("nan_decode", "nan_prefill", "corrupt_blob", "stall", "kill")

_DEFAULTS = {
    "nan_decode": {"slot": 0, "n": 1},
    "nan_prefill": {"row": 0, "n": 1},
    "corrupt_blob": {"n": 1},
    "stall": {"n": -1},
    "kill": {"point": 0, "n": 1},
}
_REQUIRED = {"nan_decode": ("iter",), "nan_prefill": ("chunk",),
             "corrupt_blob": ("rid",), "stall": ("iter",),
             "kill": ("iter",)}


class SimulatedCrash(RuntimeError):
    """A deterministic process death injected by a ``kill`` clause.  Not a
    :class:`~repro_torch.serving.faults.RequestError`: it escapes
    ``ServingEngine.run`` as a real crash would, and a fresh engine over
    the same :class:`~repro_torch.serving.store.CheckpointStore` resumes."""


@dataclass
class FaultClause:
    kind: str
    params: Dict[str, int]
    fired: int = 0

    @property
    def budget(self) -> int:
        return int(self.params["n"])

    def _spend(self) -> bool:
        if self.budget >= 0 and self.fired >= self.budget:
            return False
        self.fired += 1
        return True


def _parse_value(key: str, val: str) -> int:
    if key == "rid" and val[:1] == "r":
        val = val[1:]
    try:
        return int(val)
    except ValueError:
        raise ValueError(f"fault spec: non-integer value {val!r} for "
                         f"{key!r}") from None


def parse_spec(spec: str) -> List[FaultClause]:
    clauses = []
    for raw in filter(None, (c.strip() for c in spec.split(","))):
        kind, _, rest = raw.partition("@")
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(f"fault spec: unknown kind {kind!r} in {raw!r} "
                             f"(known: {', '.join(KINDS)})")
        params = dict(_DEFAULTS[kind])
        for p in filter(None, rest.split(":")):
            key, eq, val = p.partition("=")
            if not eq:
                raise ValueError(f"fault spec: malformed param {p!r} in "
                                 f"{raw!r} (want key=value)")
            params[key.strip()] = _parse_value(key.strip(), val.strip())
        for req in _REQUIRED[kind]:
            if req not in params:
                raise ValueError(f"fault spec: {kind!r} clause needs "
                                 f"{req}=... ({raw!r})")
        clauses.append(FaultClause(kind, params))
    return clauses


@dataclass
class FaultPlan:
    """A parsed, stateful injection plan.  Each clause tracks how many
    times it has fired; a budget of ``n=-1`` never exhausts."""

    clauses: List[FaultClause] = field(default_factory=list)
    seed: int = 0

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultPlan":
        return cls(parse_spec(spec), seed)

    @property
    def active(self) -> bool:
        return bool(self.clauses)

    # ------------------------------------------------------------ hooks
    def nan_decode_slots(self, it: int) -> List[int]:
        """Slots to poison before iteration ``it``'s decode burst."""
        out = []
        for c in self.clauses:
            if (c.kind == "nan_decode" and it >= c.params["iter"]
                    and c._spend()):
                out.append(int(c.params["slot"]))
        return out

    def nan_prefill_rows(self, chunk_idx: int) -> List[int]:
        """Group rows to poison before group-local chunk ``chunk_idx``."""
        out = []
        for c in self.clauses:
            if (c.kind == "nan_prefill" and chunk_idx >= c.params["chunk"]
                    and c._spend()):
                out.append(int(c.params["row"]))
        return out

    def stalled(self, it: int) -> bool:
        """True when prefill progress is frozen at iteration ``it``."""
        for c in self.clauses:
            if c.kind != "stall":
                continue
            start, n = c.params["iter"], c.params["n"]
            if it >= start and (n < 0 or it < start + n):
                return True
        return False

    def kill_now(self, it: int, point: int = 0) -> bool:
        """True when a ``kill`` clause for crash-point ``point`` fires at
        engine iteration ``it``."""
        for c in self.clauses:
            if (c.kind == "kill" and c.params["point"] == point
                    and it >= c.params["iter"] and c._spend()):
                return True
        return False

    def corrupt_blob(self, rid: int,
                     blob: Dict[str, Any]) -> Dict[str, Any]:
        """Flip one payload bit of ``blob`` if a clause targets ``rid``;
        returns a copy with the damaged entry (the input is untouched),
        else ``blob`` itself.  The flip lands inside the checksummed
        region (a KV leaf's live prefix)."""
        hit = False
        for c in self.clauses:
            if (c.kind == "corrupt_blob" and c.params["rid"] == rid
                    and c._spend()):
                hit = True
        if not hit:
            return blob
        keys = sorted(k for k, v in blob.items()
                      if isinstance(v, torch.Tensor) and v.nbytes > 0)
        if not keys:
            return blob
        rng = np.random.default_rng((self.seed, rid & 0x7FFFFFFF))
        key = keys[int(rng.integers(len(keys)))]
        arr = blob[key].clone()                  # private copy
        live = {}
        try:
            live = json.loads(blob.get("__meta__", "{}")).get("live", {})
        except (TypeError, ValueError):
            pass
        rows = live.get(key)
        region = arr if rows is None else arr[:, :, :int(rows)]
        if region.nbytes == 0:
            rows, region = None, arr
        flat = region.contiguous().reshape(-1).view(torch.uint8).clone()
        byte = int(rng.integers(flat.numel()))
        flat[byte] ^= 1 << int(rng.integers(8))
        if rows is None:
            arr = flat.view(arr.dtype).reshape(arr.shape)
        else:
            arr[:, :, :int(rows)] = flat.view(arr.dtype).reshape(
                region.shape)
        out = dict(blob)
        out[key] = arr
        return out


def poison_slot(cache: Any, b: int) -> Any:
    """Overwrite slot ``b`` of every floating cache leaf with NaN, in
    place (segment leaves are stacked ``[n_rep, B, ...]``; ``pos`` is
    untouched), so the next forward is non-finite for that row only.
    Returns ``cache``."""
    def walk(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)
        elif tree.dim() >= 2 and tree.is_floating_point():
            tree[:, b].fill_(float("nan"))
    for seg in cache["segments"]:
        walk(seg)
    return cache
