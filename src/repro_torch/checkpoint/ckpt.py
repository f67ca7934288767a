"""Fault-tolerant checkpoints in the reference's on-disk format.

The port of the reference's ``repro.checkpoint.ckpt``: a checkpoint of
step k is ``step_%08d/arrays.npz`` (one array a leaf, named by its path
in the tree: dict keys and list or tuple indices joined by ``/``) and
``step_%08d/manifest.json`` (step, keys, shapes, dtypes and each leaf's
crc32), so each package restores the other's float32 and int32 trees,
and the port restores the reference's bfloat16 leaves too (numpy holds
them as 2-byte void, read back bit for bit through an int16 view).

* Atomic step directories (written to ``.tmp``, then renamed): a crash
  mid-save never corrupts the latest checkpoint.
* ``restore`` loads into the structure of a target tree, checks every
  leaf's crc32, and puts each leaf on the target leaf's device in its
  dtype (bfloat16 leaves are saved as float32, which holds them exactly).
* :class:`AsyncCheckpointer` copies the tree to the host synchronously
  and writes it on a background thread, overlapping the disk with
  training.
* Retention: the newest ``keep`` checkpoints are kept.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) in tree order; dict keys in sorted order, as JAX
    flattens them."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for name, val in items:
        out.extend(_paths(val, f"{prefix}/{name}" if prefix else name))
    return out


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that shares no memory with it: the
    optimizer updates its tensors in place while an asynchronous write
    is still reading the copy."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()              # a new tensor
        elif t.device.type == "cpu":
            t = t.clone()              # .cpu() of a CPU tensor is itself
        return t.cpu().numpy()
    return np.array(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _host(v) for k, v in _paths(tree)}


def save(path: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Synchronous atomic save.  Returns the final checkpoint dir."""
    return _write(path, step, _flatten(tree), keep)


def _write(path: str, step: int, flat: Dict[str, np.ndarray],
           keep: int) -> str:
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "crc": {k: zlib.crc32(v.tobytes()) for k, v in flat.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(path, keep)
    return final


def _gc(path: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(path)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(path)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(path, d, "manifest.json"))]
    return max(steps) if steps else None


def restore(path: str, target: Any, *, step: Optional[int] = None,
            verify: bool = True) -> Any:
    """Restore into the structure of ``target`` (a tree of tensors): each
    leaf on the target leaf's device, in its dtype.  ``step`` None takes
    the latest."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(d, "arrays.npz"))
    pairs = _paths(target)
    keys = [k for k, _ in pairs]
    if set(keys) != set(manifest["keys"]):
        raise ValueError("checkpoint/tree structure mismatch: "
                         f"{sorted(set(keys) ^ set(manifest['keys']))[:5]}")
    leaves = {}
    for key, like in pairs:
        arr = data[key]
        if verify and zlib.crc32(arr.tobytes()) != manifest["crc"][key]:
            raise IOError(f"checkpoint corruption detected in leaf {key}")
        t = _leaf_tensor(key, arr, manifest["dtypes"][key])
        if isinstance(like, torch.Tensor):
            t = t.to(device=like.device, dtype=like.dtype)
        leaves[key] = t
    return _rebuild(target, leaves)


def _leaf_tensor(key: str, arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a tensor.  numpy has no bfloat16: the reference's
    bf16 leaves come back from ``np.load`` as 2-byte void, which become
    bf16 through an int16 view, bit for bit.  Any other void leaf
    raises."""
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2 or dtype != "bfloat16":
            raise ValueError(f"checkpoint leaf {key}: cannot read a "
                             f"{arr.dtype} array saved as {dtype}")
        arr = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(arr).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _rebuild(tree, leaves: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _rebuild(v, leaves, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(tree))
    return leaves[prefix]


class AsyncCheckpointer:
    """Snapshot to the host synchronously, write to disk asynchronously."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        flat = _flatten(tree)          # device->host copy happens here

        def _write_async():
            try:
                _write(self.path, step, flat, self.keep)
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write_async, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
