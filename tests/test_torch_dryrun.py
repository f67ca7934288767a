"""The port's dry run (``repro_torch.launch.dryrun``): each cell planned
on ``meta`` tensors on the abstract production mesh.

``smollm-135m x decode_32k x single`` through the command line writes its
JSON with 256 chips, and its per-device param bytes equal those the
reference's ``plan.spec`` gives; every assigned arch's train and decode
cells agree the same way; the reference's three skip rules
(``tests/test_dryrun_integration.py::test_dryrun_skip_rules``) hold in
the records.
"""
import json
import math
import os
import subprocess
import sys

import jax
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.core.config import SHAPES as J_SHAPES
from repro.core.registry import get as j_get
from repro.distributed.sharding import plan_sharding as j_plan
from repro.distributed.sharding import zero1_rules as j_zero1
from repro.models.lm import model_param_defs as j_defs
from repro_torch.configs import ASSIGNED
from repro_torch.launch import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _j_local_bytes(arch, shape, plan, itemsize, rules=None):
    """Per-device bytes of the params under the reference's plan: each
    leaf's shape divided by the mesh axes its spec names."""
    sizes = dict(zip(plan.mesh.axis_names, plan.mesh.axis_sizes))
    rp = rules or plan
    total = 0
    defs = jax.tree_util.tree_leaves(
        j_defs(j_get(arch)), is_leaf=lambda x: type(x).__name__ == "ParamDef")
    for d in defs:
        spec = rp.spec(d.axes, d.shape)
        local = []
        for n, entry in zip(d.shape, tuple(spec) + (None,) * len(d.shape)):
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            local.append(n // math.prod(sizes[a] for a in names))
        total += math.prod(local) * itemsize
    return total


def _j_plan(arch, shape, multi=False):
    shape_ = (2, 16, 16) if multi else (16, 16)
    names = ("pod", "data", "model") if multi else ("data", "model")
    mb = dryrun.TRAIN_MICROBATCHES.get(arch, 1) \
        if J_SHAPES[shape].kind == "train" else 1
    return j_plan(j_get(arch), J_SHAPES[shape],
                  JAbstractMesh(shape_, names), microbatches=mb)


def test_dryrun_cell_subprocess(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.load(open(tmp_path / "smollm-135m__decode_32k__single.json"))
    assert rec["applicable"] and rec["chips"] == 256
    assert rec["mesh_shape"] == "16x16" and rec["compiled"] is False
    plan = _j_plan("smollm-135m", "decode_32k")
    assert rec["plan"] == {"attn_mode": plan.attn_mode,
                           "kv_repeat": plan.kv_repeat,
                           "moe_groups": plan.moe_groups,
                           "notes": list(plan.notes)}
    m = rec["memory"]
    assert m["param_bytes"] == _j_local_bytes("smollm-135m", "decode_32k",
                                              plan, 2)
    assert m["cache_bytes"] > 0 and m["opt_state_bytes"] == 0
    assert m["fits"] and m["total_bytes"] == (m["param_bytes"]
                                              + m["cache_bytes"])


@pytest.mark.parametrize("arch", ASSIGNED)
def test_train_and_decode_bytes_match_reference_specs(arch):
    """fp32 masters and the ZeRO-1 moments of a train cell, bf16 params of
    a decode cell: bytes from the reference's specs."""
    rec = dryrun.run_cell(arch, "train_4k", "multi")
    plan = _j_plan(arch, "train_4k", multi=True)
    assert rec["chips"] == 512
    assert rec["memory"]["param_bytes"] == _j_local_bytes(
        arch, "train_4k", plan, 4)
    state = 2 if arch in dryrun.BF16_OPT_STATE else 4
    assert rec["memory"]["opt_state_bytes"] == 2 * _j_local_bytes(
        arch, "train_4k", plan, state, rules=j_zero1(plan))
    rec = dryrun.run_cell(arch, "decode_32k", "single")
    if not rec["applicable"]:
        assert rec["skip_reason"] == "encoder-only: no decode step"
        return
    assert rec["memory"]["param_bytes"] == _j_local_bytes(
        arch, "decode_32k", _j_plan(arch, "decode_32k"), 2)


def test_dryrun_skip_rules():
    assert not dryrun.run_cell("hubert-xlarge", "decode_32k",
                               "single")["applicable"]
    assert not dryrun.run_cell("llama3-8b", "long_500k",
                               "single")["applicable"]
    for arch in ("gemma3-1b", "mamba2-2.7b", "zamba2-2.7b"):
        rec = dryrun.run_cell(arch, "long_500k", "single")
        assert rec["applicable"] and rec["memory"]["cache_bytes"] > 0
