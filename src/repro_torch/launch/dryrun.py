"""The port's dry run: plan every (arch x shape x mesh) cell on the
production mesh and size each device's share.

The reference's dry run lowers and compiles every cell for 256 or 512
fake devices and reads XLA's memory analysis and HLO.  The port has no
ahead-of-time compiler to lower to (ROADMAP.md, "Not ported, by
design"), so its dry run is the analogue that needs no devices: each
cell is built (:func:`repro_torch.launch.steps.build_cell`) on ``meta``
tensors on the abstract production mesh, and the record holds, per
device,

* the plan: attention mode, KV repeat, MoE groups, notes;
* the bytes of the params, of the ZeRO-1 optimizer state (train cells)
  and of the cache (prefill and decode cells), from each leaf's local
  shard shape under the cell's placements;
* ``fits``: their sum against the H100 SXM's memory
  (:data:`repro_torch.core.config.H100_SXM`).

Nothing is compiled: there are no HLO costs, no activations and no
temporaries in the record (``"compiled": false`` says so), so ``fits``
is a lower bound on what the device must hold.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both

Writes one JSON a cell, ``ARCH__SHAPE__MESH.json``, under ``--out``
(default ``build/dryrun``).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Any, Dict

import torch

from repro_torch.configs import ASSIGNED
from repro_torch.core.config import H100_SXM, SHAPES
from repro_torch.core.registry import get
from repro_torch.core.workload import applicable
from repro_torch.distributed.sharding import is_sharding
from repro_torch.launch.mesh import make_production_mesh, mesh_name
from repro_torch.launch.steps import build_cell
from repro_torch.train.optimizer import OptConfig

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "../../../build/dryrun")

# the reference's per-arch training knobs
TRAIN_MICROBATCHES = {
    "qwen3-moe-235b-a22b": 16,
    "llama4-maverick-400b-a17b": 16,
    "glm4-9b": 8,
    "llama3-8b": 8,
    "llava-next-mistral-7b": 8,
    "mamba2-2.7b": 8,
    "zamba2-2.7b": 8,
}
BF16_OPT_STATE = {"qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"}


def _pairs(tree, shardings):
    """(meta leaf, sharding) pairs of a tree and its shardings tree."""
    if is_sharding(shardings):
        return [(tree, shardings)]
    if isinstance(tree, dict):
        return [x for k in tree for x in _pairs(tree[k], shardings[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t, s in zip(tree, shardings) for x in _pairs(t, s)]
    raise TypeError(f"no sharding for {type(tree).__name__}")


def local_bytes(tree, shardings) -> int:
    """Bytes a device holds of ``tree`` (meta tensors) placed by
    ``shardings``: each leaf's local shard, its global shape divided by
    the mesh axes that split each dim."""
    total = 0
    for leaf, (mesh, placements) in _pairs(tree, shardings):
        shape = list(leaf.shape)
        sizes = list(mesh.axis_sizes)
        for i, pl in enumerate(placements):
            if hasattr(pl, "dim"):
                shape[pl.dim] //= sizes[i]
        total += math.prod(shape) * leaf.element_size()
    return total


def run_cell(arch: str, shape: str, mesh_kind: str) -> Dict[str, Any]:
    cfg = get(arch)
    wl = SHAPES[shape]
    ok, why = applicable(cfg, wl)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "applicable": ok, "skip_reason": why}
    if not ok:
        return rec
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    rec["mesh_shape"] = mesh_name(mesh)
    rec["chips"] = mesh.size
    mb = TRAIN_MICROBATCHES.get(arch, 1)
    opt = OptConfig(state_dtype="bfloat16" if arch in BF16_OPT_STATE
                    else "float32")
    rec["train_knobs"] = {"microbatches": mb,
                          "opt_state_dtype": opt.state_dtype}
    t0 = time.perf_counter()
    cell = build_cell(cfg, wl, mesh, opt=opt, microbatches=mb)
    rec["build_s"] = time.perf_counter() - t0
    rec["plan"] = {"attn_mode": cell.plan.attn_mode,
                   "kv_repeat": cell.plan.kv_repeat,
                   "moe_groups": cell.plan.moe_groups,
                   "notes": list(cell.plan.notes)}
    params = local_bytes(cell.args[0], cell.in_shardings[0])
    opt_b = cache_b = 0
    if wl.kind == "train":
        osh = cell.in_shardings[1]
        opt_b = (local_bytes(cell.args[1]["m"], osh["m"])
                 + local_bytes(cell.args[1]["v"], osh["v"]))
    elif len(cell.args) == 3:
        cache_b = local_bytes(cell.args[2], cell.in_shardings[2])
    total = params + opt_b + cache_b
    rec["memory"] = {"param_bytes": params, "opt_state_bytes": opt_b,
                     "cache_bytes": cache_b, "total_bytes": total,
                     "hbm_bytes": H100_SXM.hbm_bytes,
                     "fits": bool(total <= H100_SXM.hbm_bytes)}
    rec["compiled"] = False
    rec["not_measured"] = ("no HLO, activations or temporaries: the port "
                           "has no ahead-of-time compiler; bytes are the "
                           "local shards of the cell's arguments")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        archs = [args.arch] if args.arch else list(ASSIGNED)
        shapes = [args.shape] if args.shape else list(SHAPES)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        archs, shapes = [args.arch], [args.shape]
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                rec = run_cell(arch, shape, mk)
                tag = f"{arch}__{shape}__{mk}"
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                if rec["applicable"]:
                    m = rec["memory"]
                    print(f"[ok] {tag}: {m['total_bytes'] / 1e9:.2f} GB a "
                          f"device, fits={m['fits']}", flush=True)
                else:
                    print(f"[n/a] {tag}: {rec['skip_reason']}", flush=True)
    return 0


if __name__ == "__main__":
    torch.set_grad_enabled(False)
    sys.exit(main())
