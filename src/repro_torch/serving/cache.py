"""Cache administration for the serving layer: sizing, slot extraction and
insertion, and host offload and restore of single slots (preemption,
checkpoints).

The port's copy of the reference's ``serving/cache.py``, with its blob
format key for key.  A blob holds a slot's FULL cache rows, one entry per
cache leaf keyed by its path (``"segments/0/1/attn/k"``, ``"pos"``, in
the reference's leaf order: dict keys sorted, lists by index), plus a
``__meta__`` JSON record: the schema (key -> [shape, dtype name]), its
crc32 fingerprint, a crc32 per key and the caller's tags.  ``pos`` is
also the ring cursor of rolling sliding-window caches, so a preempted
request restores bit-exactly mid-wrap and under another KV bucket.
The crc of an attention KV leaf nested under ``attn`` (zamba2's shared
attention) covers only the slot's live prefix, its first ``pos`` rows
(:func:`_live_rows`, the reference's rule as it is).

Where the port differs:

* **Payloads are CPU tensors**, not numpy arrays: numpy has no bfloat16.
  The schema names a dtype as the reference does (``"bfloat16"``,
  ``"float32"``, ``"int32"``), and each crc runs over the leaf's raw
  bytes (a ``uint8`` view), so it equals the reference's for the same
  bytes.  :func:`validate_blob` compares dtypes by name.
* **Writes are in place.**  :func:`restore_slot` and
  :func:`insert_slot` copy into the cache's existing leaves and return
  the same cache: the decode graphs are keyed on the leaves' addresses
  (``serving/graphs.py``), so a new tensor would make a new key.
* **Only the slots asked for cross the host link.**
  :func:`offload_slots` gathers the due slots' rows on the device, one
  gather and one copy to (pinned) host memory per leaf, and waits once;
  the reference fetches the whole cache.
"""
from __future__ import annotations

import json
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.config import ModelConfig
from repro_torch.core.memmodel import kv_cache_bytes, ssm_state_bytes
from repro_torch.models.params import tree_map
from repro_torch.serving.faults import CacheCorruption

#: Reserved blob key holding the JSON integrity record (not a cache leaf).
BLOB_META_KEY = "__meta__"


def cache_bytes(cfg: ModelConfig, batch: int, max_seq: int) -> int:
    """Analytic cache footprint — the serving admission controller's input."""
    return kv_cache_bytes(cfg, batch, max_seq) + ssm_state_bytes(cfg, batch)


def max_slots(cfg: ModelConfig, max_seq: int, hbm_budget: float,
              weight_bytes: float) -> int:
    """How many concurrent sequences fit next to the weights."""
    per_slot = cache_bytes(cfg, 1, max_seq)
    free = hbm_budget - weight_bytes
    return max(0, int(free // max(per_slot, 1)))


def leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs of a dict / list / tuple tree in the
    reference's leaf order (dict keys sorted, sequences by index), each
    key the path's parts joined by ``/``."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += leaves_with_path(v, f"{prefix}/{k}" if prefix else k)
    return out


def dtype_name(t: torch.Tensor) -> str:
    """A tensor's dtype as the reference's schema writes it."""
    return str(t.dtype).replace("torch.", "")


def _slot_shape(key: str, leaf: torch.Tensor) -> Tuple[int, ...]:
    if key == "pos":                             # [B]: batch on axis 0
        return (1,)
    if leaf.dim() == 0:
        return ()
    return (leaf.shape[0], 1) + tuple(leaf.shape[2:])   # [n_rep, B, ...]


def extract_slot(cache: Any, b: int) -> Any:
    """Slot ``b`` of a batched cache as a batch-1 cache (a copy, on the
    cache's device)."""
    def pick(t):
        return t if t.dim() == 0 else t[:, b:b + 1].clone()
    segs = [tree_map(pick, seg) for seg in cache["segments"]]
    return {"segments": segs, "pos": cache["pos"][b:b + 1].clone()}


def insert_slot(cache: Any, one: Any, b: int) -> Any:
    """Write a batch-1 cache into slot ``b`` of ``cache``, in place (the
    inverse of :func:`extract_slot`).  Returns ``cache``."""
    for (k, full), (_, single) in zip(leaves_with_path(cache),
                                      leaves_with_path(one)):
        _write_slot(k, full, single, b)
    return cache


def _write_slot(key: str, full: torch.Tensor, single: torch.Tensor,
                b: int) -> None:
    if key == "pos":
        full[b:b + 1].copy_(single.to(full.dtype))
    elif full.dim() > 0:
        full[:, b:b + 1].copy_(single.to(full.dtype))


def _blob_schema(arrays: Dict[str, Any]) -> Dict[str, Any]:
    return {k: [list(a.shape), dtype_name(a)]
            for k, a in sorted(arrays.items())}


def slot_schema(cache: Any) -> Dict[str, Any]:
    """The blob schema (key -> [shape, dtype]) an :func:`offload_slot` of
    this cache produces, from leaf metadata alone (no device transfer).
    The durable checkpoint store fingerprints it next to the config."""
    out = {k: [list(_slot_shape(k, leaf)), dtype_name(leaf)]
           for k, leaf in leaves_with_path(cache)}
    return {k: out[k] for k in sorted(out)}


def _schema_fingerprint(schema: Dict[str, Any]) -> str:
    return f"{zlib.crc32(json.dumps(schema, sort_keys=True).encode()):08x}"


def _raw_bytes(t: torch.Tensor) -> np.ndarray:
    """A payload's bytes as a numpy ``uint8`` array (no copy when it is a
    contiguous host tensor)."""
    return t.detach().cpu().contiguous().reshape(-1).view(
        torch.uint8).numpy()


def _payload_crc(t: torch.Tensor) -> int:
    return zlib.crc32(_raw_bytes(t))


def _live_rows(out: Dict[str, Any], pos: int) -> Dict[str, int]:
    """Which blob keys get prefix-bounded checksums, and how many rows:
    attention KV leaves nested under ``attn`` (row axis 2 after slot
    slicing) whose first ``pos`` rows are the slot's live prefix."""
    live: Dict[str, int] = {}
    for k, a in out.items():
        if (k.endswith(("attn/k", "attn/v")) and a.dim() > 2
                and 0 <= pos < a.shape[2]):
            live[k] = pos
    return live


def _payload_crc_live(t: torch.Tensor, rows) -> int:
    if rows is None:
        return _payload_crc(t)
    return _payload_crc(t[:, :, :rows])


def _finalize_blob(out: Dict[str, torch.Tensor],
                   tags: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    pos = int(out["pos"][0]) if "pos" in out else -1
    live = _live_rows(out, pos)
    schema = _blob_schema(out)
    blob: Dict[str, Any] = dict(out)
    meta = {
        "schema": schema,
        "fingerprint": _schema_fingerprint(schema),
        "crc": {k: _payload_crc_live(a, live.get(k))
                for k, a in out.items()},
    }
    if live:
        meta["live"] = live
    if tags:
        meta["tags"] = dict(tags)
    blob[BLOB_META_KEY] = json.dumps(meta)
    return blob


def blob_tags(blob: Dict[str, Any]) -> Dict[str, Any]:
    """The identity/class tags a blob was offloaded with (``{"rid": ...,
    "priority": ...}`` from the engine), or {} for a blob without meta.
    Unreadable meta raises the same CacheCorruption restore would."""
    meta_raw = blob.get(BLOB_META_KEY)
    if meta_raw is None:
        return {}
    try:
        return dict(json.loads(meta_raw).get("tags") or {})
    except (ValueError, AttributeError, TypeError) as e:
        raise CacheCorruption(
            f"unreadable blob __meta__ record: {e}") from None


def blob_nbytes(blob: Dict[str, Any]) -> int:
    return sum(v.nbytes for v in blob.values() if hasattr(v, "nbytes"))


def _count_bytes(metrics, name: str, nbytes: int) -> None:
    if metrics is not None:
        metrics.counter(name, "host<->device cache traffic").inc(nbytes)


def offload_slot(cache: Any, b: int, metrics=None,
                 tags: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Host-offload one slot (a preempted request) as CPU tensors plus the
    ``__meta__`` integrity record :func:`restore_slot` validates.  ``tags``
    (JSON-able) ride in the meta record, so restore can refuse a blob
    offloaded for another request."""
    return offload_slots(cache, [b], metrics=metrics,
                         tags={b: tags} if tags else None)[b]


def offload_slots(cache: Any, bs: Sequence[int], metrics=None,
                  tags: Optional[Dict[int, Dict[str, Any]]] = None
                  ) -> Dict[int, Dict[str, Any]]:
    """Host-offload several slots at once (the periodic checkpoint): per
    leaf one gather of the slots' rows on the leaf's device and one copy
    to host memory (pinned, asynchronous, from a card), then one wait.
    Each blob is the one :func:`offload_slot` makes for its slot.
    ``tags`` maps slot index -> that slot's tag dict."""
    bs = [int(b) for b in bs]
    gathered: List[Tuple[str, torch.Tensor]] = []
    waits = set()
    for key, leaf in leaves_with_path(cache):
        idx = torch.tensor(bs, dtype=torch.long, device=leaf.device)
        if key == "pos":
            sel = leaf.index_select(0, idx)                  # [k]
        elif leaf.dim() == 0:
            sel = leaf
        else:
            # [n_rep, B, ...] -> [k, n_rep, ...]: one gather, contiguous
            sel = leaf.transpose(0, 1)[idx]
        if sel.device.type == "cuda":
            host = torch.empty(sel.shape, dtype=sel.dtype, pin_memory=True)
            host.copy_(sel, non_blocking=True)
            waits.add(sel.device)
            sel = host
        gathered.append((key, sel))
    for dev in waits:
        torch.cuda.current_stream(dev).synchronize()
    blobs: Dict[int, Dict[str, Any]] = {}
    for i, b in enumerate(bs):
        out: Dict[str, torch.Tensor] = {}
        for key, arr in gathered:
            if key == "pos":
                out[key] = arr[i:i + 1]
            elif arr.dim() == 0:
                out[key] = arr
            else:
                out[key] = arr[i].unsqueeze(1)               # [n_rep, 1, ...]
        blobs[b] = _finalize_blob(out, tags=(tags or {}).get(b))
        _count_bytes(metrics, "repro_offload_bytes_total",
                     blob_nbytes(blobs[b]))
    return blobs


def validate_blob(blob: Dict[str, Any], template_keys,
                  rid=None) -> Dict[str, Any]:
    """Check a blob's key set against ``template_keys`` and its payload
    against its own ``__meta__`` record.  Returns the payload dict (meta
    stripped); raises :class:`CacheCorruption` on the first violation —
    key-set mismatches report the full missing/extra diff, schema and
    checksum mismatches name the offending key."""
    data = {k: v for k, v in blob.items() if k != BLOB_META_KEY}
    got, want = set(data), set(template_keys)
    if got != want:
        missing = sorted(want - got)
        extra = sorted(got - want)
        raise CacheCorruption(
            "blob key set does not match the slot template: "
            f"missing={missing or '[]'} extra={extra or '[]'}", rid=rid)
    meta_raw = blob.get(BLOB_META_KEY)
    if meta_raw is None:
        return data                  # blob without meta: key-set check only
    try:
        meta = json.loads(meta_raw)
        schema, crcs = meta["schema"], meta["crc"]
        fingerprint = meta["fingerprint"]
        live = meta.get("live", {})
    except (ValueError, KeyError, TypeError) as e:
        raise CacheCorruption(f"unreadable blob __meta__ record: {e}",
                              rid=rid) from None
    if fingerprint != _schema_fingerprint(schema):
        raise CacheCorruption("blob schema fingerprint mismatch "
                              f"(recorded {fingerprint})", rid=rid)
    for k in sorted(data):
        a = data[k]
        shape, name = tuple(a.shape), dtype_name(a)
        decl = schema.get(k)
        if decl is None or decl != [list(shape), name]:
            raise CacheCorruption(
                f"schema mismatch: got {shape}/{name}, blob declares "
                f"{decl}", rid=rid, key=k)
        rows = live.get(k)
        if rows is not None and not (
                len(shape) > 2 and 0 <= int(rows) < shape[2]):
            raise CacheCorruption(
                f"blob declares live-prefix crc over {rows} rows, which "
                f"does not fit shape {shape}", rid=rid, key=k)
        if _payload_crc_live(a, rows) != crcs.get(k):
            raise CacheCorruption("payload crc32 mismatch", rid=rid, key=k)
    return data


def restore_slot(cache: Any, blob: Dict[str, Any], b: int,
                 rid=None, metrics=None,
                 expect_tags: Optional[Dict[str, Any]] = None) -> Any:
    """Re-admit an offloaded slot into slot ``b`` of ``cache``, in place:
    every leaf keeps its address.  The blob is validated first
    (:func:`validate_blob`), so a malformed or bit-flipped blob raises
    :class:`CacheCorruption` and writes nothing.  ``expect_tags`` pins
    identity: every given key must match the blob's recorded tag (a blob
    without that tag passes).  Full rows are written, the KV tail past
    ``pos`` included.  Returns ``cache``."""
    if expect_tags:
        tags = blob_tags(blob)
        for k, v in expect_tags.items():
            if k in tags and tags[k] != v:
                raise CacheCorruption(
                    f"blob identity tag {k!r} mismatch: blob carries "
                    f"{tags[k]!r}, restore expects {v!r}", rid=rid)
    leaves = leaves_with_path(cache)
    data = validate_blob(blob, [k for k, _ in leaves], rid=rid)
    for k, leaf in leaves:
        want = _slot_shape(k, leaf)
        if tuple(data[k].shape) != want:
            raise CacheCorruption(
                f"blob leaf shape {tuple(data[k].shape)} does not fit the "
                f"slot template {want}", rid=rid, key=k)
    for k, leaf in leaves:
        _write_slot(k, leaf, data[k], b)
    _count_bytes(metrics, "repro_restore_bytes_total", blob_nbytes(data))
    return cache
