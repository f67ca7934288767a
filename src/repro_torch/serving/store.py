"""Durable checkpoint store: crash-surviving persistence for the serving
engine's crc-tagged checkpoint and preemption blobs plus request metadata.

The port's copy of the reference's ``serving/store.py``, same files and
same bytes.  A :class:`CheckpointStore` owns one directory (a path
argument; the port reads no environment)::

    <root>/manifest.json          # atomic write-rename, schema-versioned
    <root>/blobs/r<rid>-<seq>.blob

Every mutation is atomic at the file level (write to a ``.tmp``
sibling, fsync, ``os.replace``), and the manifest is the single commit
point: blob files are staged first, the manifest that references them is
replaced second, and files no manifest entry references are pruned after
the next commit.  A crash between the two leaves the previous manifest
intact and the staged file as ignorable garbage.

Blob container format (:func:`dump_blob` / :func:`parse_blob`): a magic
prefix, an 8-byte little-endian header length, a JSON header declaring
every array's shape, dtype name and offset plus the blob's ``__meta__``
record verbatim, then the concatenated raw bytes.  For the same rows it
is byte for byte the reference's file; a ``"bfloat16"`` array is read
back by name into a torch tensor (numpy has no bfloat16).  A torn or
bit-damaged file fails parsing or the per-key crc32 of
:func:`repro_torch.serving.cache.validate_blob` with
:class:`~repro_torch.serving.faults.CacheCorruption`; the engine then
replays that request from its prompt.

The manifest carries a layout fingerprint (config name + ``max_seq`` +
the slot blob schema): an engine with another config or cache geometry
refuses the store.  Only the newest ``retain`` blob files per request
stay referenced.  This module reads no clock: timestamps in the manifest
come from the engine's injectable clock as plain record fields.
"""
from __future__ import annotations

import json
import logging
import os
import re
import zlib
from typing import Any, Dict, List

import numpy as np

import torch

from repro_torch.serving.cache import BLOB_META_KEY, _raw_bytes, dtype_name
from repro_torch.serving.faults import CacheCorruption

log = logging.getLogger("repro_torch.serving.store")

#: Manifest / blob-container schema version; a mismatch cold-starts the
#: store (with a logged warning) instead of guessing at old layouts.
STORE_VERSION = 1

BLOB_MAGIC = b"RPROBLOB1\n"
MANIFEST_NAME = "manifest.json"
BLOB_DIR = "blobs"

_BLOB_FILE_RE = re.compile(r"^r-?\d+-(\d+)\.blob$")


def layout_fingerprint(cfg_name: str, max_seq: int,
                       schema: Dict[str, Any]) -> str:
    """crc32 fingerprint of (config, cache geometry, slot blob schema).
    Two engines share a store only when this matches — same leaf keys,
    shapes and dtypes, so every persisted blob fits the new cache."""
    blob = json.dumps([cfg_name, int(max_seq), schema], sort_keys=True)
    return f"{zlib.crc32(blob.encode()):08x}"


def _torch_dtype(name) -> torch.dtype:
    """A schema dtype name (``"float32"``, ``"bfloat16"``, ``"int32"``) as
    a torch dtype; ValueError for any other string."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def dump_blob(blob: Dict[str, Any]) -> bytes:
    """Serialize an offload blob (CPU tensors + the ``__meta__`` JSON
    string) to one self-describing byte string.  Key order is sorted, so
    identical blobs serialize identically."""
    payload = bytearray()
    arrays: Dict[str, Any] = {}
    for k in sorted(k for k in blob if k != BLOB_META_KEY):
        raw = _raw_bytes(blob[k])
        arrays[k] = {"shape": list(blob[k].shape),
                     "dtype": dtype_name(blob[k]),
                     "offset": len(payload), "nbytes": int(raw.nbytes)}
        payload += raw.tobytes()
    header = json.dumps({"version": STORE_VERSION, "arrays": arrays,
                         "meta": blob.get(BLOB_META_KEY)},
                        sort_keys=True).encode()
    return (BLOB_MAGIC + len(header).to_bytes(8, "little")
            + header + bytes(payload))


def parse_blob(data: bytes) -> Dict[str, Any]:
    """Inverse of :func:`dump_blob`: CPU tensors, each dtype resolved by
    its name (``"bfloat16"`` included).  Raises :class:`CacheCorruption` on
    ANY malformation — bad magic, torn header, payload shorter than the
    header declares — so a truncated file can never round-trip into a
    silently shorter cache row."""
    if data[:len(BLOB_MAGIC)] != BLOB_MAGIC:
        raise CacheCorruption("durable blob: bad magic (torn or foreign "
                              "file)")
    off = len(BLOB_MAGIC)
    if len(data) < off + 8:
        raise CacheCorruption("durable blob: truncated before header "
                              "length")
    hlen = int.from_bytes(data[off:off + 8], "little")
    off += 8
    if len(data) < off + hlen:
        raise CacheCorruption("durable blob: truncated inside header")
    try:
        header = json.loads(data[off:off + hlen])
        arrays = header["arrays"]
        version = header["version"]
    except (ValueError, KeyError, TypeError) as e:
        raise CacheCorruption(
            f"durable blob: unreadable header ({e})") from None
    if version != STORE_VERSION:
        raise CacheCorruption(
            f"durable blob: container version {version} != {STORE_VERSION}")
    payload = data[off + hlen:]
    out: Dict[str, Any] = {}
    for k, decl in arrays.items():
        try:
            shape = tuple(int(s) for s in decl["shape"])
            dtype = _torch_dtype(decl["dtype"])
            start, nbytes = int(decl["offset"]), int(decl["nbytes"])
        except (KeyError, TypeError, ValueError) as e:
            raise CacheCorruption(
                f"durable blob: bad array declaration ({e})",
                key=k) from None
        if start < 0 or start + nbytes > len(payload):
            raise CacheCorruption(
                f"durable blob: payload truncated ({start + nbytes} bytes "
                f"declared, {len(payload)} present)", key=k)
        item = torch.empty((), dtype=dtype).element_size()
        raw = np.frombuffer(payload, dtype=np.uint8,
                            count=nbytes - nbytes % item, offset=start)
        try:
            out[k] = torch.from_numpy(raw.copy()).view(dtype).reshape(shape)
        except (RuntimeError, ValueError) as e:
            raise CacheCorruption(
                f"durable blob: shape/size mismatch ({e})", key=k) from None
    meta = header.get("meta")
    if meta is not None:
        out[BLOB_META_KEY] = meta
    return out


class CheckpointStore:
    """Versioned on-disk store for one engine's durable state.

    The in-memory ``manifest`` mirrors the last committed state plus
    uncommitted mutations; :meth:`commit` atomically replaces
    ``manifest.json`` and then prunes unreferenced blob files.  Request
    records are plain dicts (see ``ServingEngine._persist_request`` for
    the fields); blobs are referenced by store-relative path,
    newest-first, bounded to ``retain`` entries per request."""

    def __init__(self, root: str, retain: int = 2):
        self.root = root
        self.blob_dir = os.path.join(root, BLOB_DIR)
        os.makedirs(self.blob_dir, exist_ok=True)
        self.retain = max(1, int(retain))
        self.manifest = self._load_manifest()
        self._dirty = False
        # monotonic blob sequence across restarts: a restarted engine must
        # never overwrite a predecessor's still-referenced blob file
        seqs = [int(m.group(1)) for f in os.listdir(self.blob_dir)
                for m in [_BLOB_FILE_RE.match(f)] if m]
        self._seq = max(seqs, default=-1) + 1

    # ------------------------------------------------------------- manifest
    def _load_manifest(self) -> Dict[str, Any]:
        empty = {"version": STORE_VERSION, "fingerprint": None,
                 "requests": {}}
        path = os.path.join(self.root, MANIFEST_NAME)
        if not os.path.exists(path):
            return empty
        try:
            with open(path) as f:
                man = json.load(f)
            if man.get("version") != STORE_VERSION:
                log.warning("checkpoint store %s: manifest version %r != "
                            "%d; starting cold", self.root,
                            man.get("version"), STORE_VERSION)
                return empty
            man.setdefault("fingerprint", None)
            man.setdefault("requests", {})
            return man
        except (ValueError, OSError) as e:
            # a torn manifest means the LAST commit never landed; there is
            # nothing consistent to recover, so cold-start (never crash)
            log.warning("checkpoint store %s: unreadable manifest (%s); "
                        "starting cold", self.root, e)
            return empty

    @property
    def requests(self) -> Dict[str, Dict[str, Any]]:
        return self.manifest["requests"]

    def set_fingerprint(self, fp: str) -> None:
        if self.manifest.get("fingerprint") != fp:
            self.manifest["fingerprint"] = fp
            self._dirty = True

    def record(self, rid: int, **fields: Any) -> Dict[str, Any]:
        """Merge ``fields`` into request ``rid``'s manifest record
        (uncommitted until :meth:`commit`)."""
        rec = self.requests.setdefault(str(rid), {"rid": int(rid),
                                                  "blobs": []})
        rec.update(fields)
        self._dirty = True
        return rec

    def forget(self, rid: int) -> None:
        """Drop request ``rid``'s record; its blob files become prunable
        at the next commit."""
        if self.requests.pop(str(rid), None) is not None:
            self._dirty = True

    def commit(self) -> None:
        """Atomically replace the on-disk manifest with the in-memory
        state, then prune blob files nothing references.  No-op when
        nothing changed since the last commit."""
        if not self._dirty:
            return
        self._atomic_write(os.path.join(self.root, MANIFEST_NAME),
                           json.dumps(self.manifest).encode())
        self._dirty = False
        self._prune()

    # ---------------------------------------------------------------- blobs
    def stage_blob(self, rid: int, blob: Dict[str, Any]) -> str:
        """Write ``blob`` to a fresh file and reference it newest-first in
        ``rid``'s record (trimmed to ``retain``).  The record change only
        becomes recoverable at the next :meth:`commit` — the stage/commit
        split is what makes a crash between them harmless."""
        rel = f"{BLOB_DIR}/r{int(rid)}-{self._seq:08d}.blob"
        self._seq += 1
        self._atomic_write(os.path.join(self.root, rel), dump_blob(blob))
        rec = self.record(rid)
        rec["blobs"] = ([rel] + list(rec.get("blobs") or []))[:self.retain]
        return rel

    def load_blob(self, rel: str) -> Dict[str, Any]:
        """Read + parse one referenced blob file.  Raises
        :class:`CacheCorruption` when the file is missing, unreadable or
        torn — callers degrade to replay-from-prompt (older blobs are
        retained for forensics only; the manifest's resume metadata
        matches the newest blob alone)."""
        try:
            with open(os.path.join(self.root, rel), "rb") as f:
                data = f.read()
        except OSError as e:
            raise CacheCorruption(
                f"durable blob {rel!r} unreadable: {e}") from None
        return parse_blob(data)

    def _prune(self) -> None:
        referenced = {os.path.basename(rel)
                      for rec in self.requests.values()
                      for rel in rec.get("blobs") or []}
        for fn in os.listdir(self.blob_dir):
            if fn.endswith(".blob") and fn not in referenced:
                try:
                    os.remove(os.path.join(self.blob_dir, fn))
                except OSError:
                    pass

    @staticmethod
    def _atomic_write(path: str, data: bytes) -> None:
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    # ---------------------------------------------------------- inspection
    def rids(self) -> List[int]:
        return sorted(rec["rid"] for rec in self.requests.values())
