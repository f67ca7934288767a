"""The port's sharding plan against the reference's, on abstract meshes.

For every assigned arch x workload shape x {single pod 16x16, two pods
2x16x16}: the plan's attention mode, KV repeat, MoE groups, notes and
rules, and the spec of every parameter leaf (under the plan and under
``zero1_rules``) and every cache leaf equal the reference's
``PartitionSpec``, entry for entry.  No devices: the reference plans on
``jax.sharding.AbstractMesh``, the port on its own ``AbstractMesh``.
The reference's six plan cases (``tests/test_sharding_plan.py``) follow
as port cases, then the placements a spec turns into.
"""
import functools

import jax
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ASSIGNED as J_ASSIGNED
from repro.core.config import SHAPES as J_SHAPES
from repro.core.registry import get as j_get
from repro.distributed.sharding import plan_sharding as j_plan
from repro.distributed.sharding import zero1_rules as j_zero1
from repro.launch.steps import cache_shardings as j_cache_shardings
from repro.models.lm import init_lm_cache as j_init_cache
from repro.models.lm import model_param_defs as j_defs
from repro_torch.configs import ASSIGNED
from repro_torch.core.config import SHAPES
from repro_torch.core.registry import get
from repro_torch.core.workload import applicable
from repro_torch.distributed.sharding import (AbstractMesh, plan_sharding,
                                              spec_placements, zero1_rules)
from repro_torch.launch.mesh import make_production_mesh, mesh_name
from repro_torch.launch.steps import cache_specs, param_specs
from repro_torch.models.lm import init_lm_cache, lm_param_axes
from repro_torch.models.lm import model_param_defs
from repro_torch.models.params import ParamDef

CELLS = [(a, s, m) for a in ASSIGNED for s in sorted(SHAPES)
         for m in ("single", "multi")]


def _j_mesh(multi: bool):
    shape = (2, 16, 16) if multi else (16, 16)
    names = ("pod", "data", "model") if multi else ("data", "model")
    try:
        return JAbstractMesh(shape, names)
    except TypeError:
        return JAbstractMesh(tuple(zip(names, shape)))


def _norm(spec):
    """A spec as a tuple with trailing Nones dropped (``P()`` and
    ``P(None)`` name the same layout)."""
    parts = list(spec)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _is_leaf(x) -> bool:
    """A ParamDef, or a tuple of axis names or spec entries (a container
    tuple holds dicts)."""
    return isinstance(x, ParamDef) or (
        isinstance(x, tuple) and not any(isinstance(e, (dict, list))
                                         for e in x))


def _flat(tree, prefix=""):
    """{path: leaf} of a dict / list / tuple tree (:func:`_is_leaf`)."""
    if _is_leaf(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _j_flat_defs(defs):
    leaves = jax.tree_util.tree_leaves_with_path(
        defs, is_leaf=lambda x: type(x).__name__ == "ParamDef")
    return {"".join(f"/{getattr(k, 'key', getattr(k, 'idx', None))}"
                    for k in path): d for path, d in leaves}


def _j_cache_specs(cfg, wl, plan):
    csds = jax.eval_shape(functools.partial(
        j_init_cache, cfg, wl.global_batch, wl.seq_len,
        kv_repeat=plan.kv_repeat, shared_kv_repeat=plan.kv_repeat))
    out = {}
    for path, sh in jax.tree_util.tree_leaves_with_path(
            j_cache_shardings(csds, plan)):
        key = "".join(f"/{getattr(k, 'key', getattr(k, 'idx', None))}"
                      for k in path)
        out[key] = _norm(sh.spec)
    return out, {"".join(f"/{getattr(k, 'key', getattr(k, 'idx', None))}"
                         for k in p): tuple(leaf.shape)
                 for p, leaf in jax.tree_util.tree_leaves_with_path(csds)}


def test_registries_agree():
    assert ASSIGNED == J_ASSIGNED
    assert sorted(SHAPES) == sorted(J_SHAPES)


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_plan_and_every_leaf_spec_match_reference(arch, shape, mesh):
    multi = mesh == "multi"
    cfg, wl = get(arch), SHAPES[shape]
    jcfg, jwl = j_get(arch), J_SHAPES[shape]
    plan = plan_sharding(cfg, wl, make_production_mesh(multi_pod=multi))
    jplan = j_plan(jcfg, jwl, _j_mesh(multi))
    assert (plan.attn_mode, plan.kv_repeat, plan.moe_groups, plan.notes) == \
        (jplan.attn_mode, jplan.kv_repeat, jplan.moe_groups, jplan.notes)
    assert plan.param_rules == jplan.param_rules
    assert plan.act_rules == jplan.act_rules
    assert (plan.data_size, plan.model_size) == (jplan.data_size,
                                                 jplan.model_size)

    # every parameter leaf, under the plan and under ZeRO-1
    jdefs = _j_flat_defs(j_defs(jcfg))
    axes = _flat(lm_param_axes(cfg))
    assert set(axes) == set(jdefs)
    for rp, jrp in ((plan, jplan), (zero1_rules(plan), j_zero1(jplan))):
        got = _flat(param_specs(cfg, plan, rp))
        for key, d in jdefs.items():
            assert axes[key] == tuple(d.axes), key
            assert _norm(got[key]) == _norm(jrp.spec(d.axes, d.shape)), key
    assert zero1_rules(plan).notes == j_zero1(jplan).notes

    # every cache leaf: the exact KV heads, the reference's _CACHE_AXES
    want, jshapes = _j_cache_specs(jcfg, jwl, jplan)
    cache = init_lm_cache(cfg, wl.global_batch, wl.seq_len, device="meta")
    got = {k: _norm(v) for k, v in _flat(cache_specs(cache, plan)).items()}
    assert got == want
    assert {k: tuple(v.shape) for k, v in _flat(cache).items()} == jshapes

    # the plan's checks in the reference's test_plan_builds_for_every_cell
    if applicable(cfg, wl)[0] and cfg.attn is not None:
        assert (cfg.attn.n_heads % 16 == 0) == (plan.attn_mode == "head")
    assert wl.global_batch % plan.data_size == 0 or plan.data_size == 1


# ------------------------------------------- the reference's plan cases

def _mesh(multi_pod=False):
    return make_production_mesh(multi_pod=multi_pod)


def test_spec_divisibility_fallback():
    plan = plan_sharding(get("llama3-8b"), SHAPES["train_4k"], _mesh())
    # 100 doesn't divide 16 -> replicated
    assert plan.spec(("ff",), (100,)) == (None,)
    assert plan.spec(("ff",), (14336,)) == ("model",)
    # one mesh axis never used twice
    assert plan.spec(("ff", "ff"), (160, 320)) == ("model", None)


def test_seq_mode_for_small_heads():
    plan = plan_sharding(get("gemma3-1b"), SHAPES["prefill_32k"], _mesh())
    assert plan.attn_mode == "seq"
    plan2 = plan_sharding(get("smollm-135m"), SHAPES["train_4k"], _mesh())
    assert plan2.attn_mode == "seq"


def test_kv_repeat_exactness_rules():
    plan = plan_sharding(get("llama3-8b"), SHAPES["train_4k"], _mesh())
    assert plan.attn_mode == "head" and plan.kv_repeat == 2    # kv 8 -> 16
    plan = plan_sharding(get("glm4-9b"), SHAPES["train_4k"], _mesh())
    assert plan.kv_repeat == 8                                  # kv 2 -> 16


def test_zero1_adds_data_axis():
    plan = plan_sharding(get("llama3-8b"), SHAPES["train_4k"], _mesh())
    z = zero1_rules(plan)
    assert z.spec(("embed", "ff"), (4096, 14336)) == ("data", "model")


def test_fsdp_plan_llama4():
    cfg = get("llama4-maverick-400b-a17b")
    assert cfg.fsdp and cfg.fsdp == j_get(cfg.name).fsdp
    plan = plan_sharding(cfg, SHAPES["train_4k"], _mesh())
    assert plan.attn_mode == "seq"          # 40 heads !% 16
    assert plan.param_rules["embed"] == "data"


@pytest.mark.parametrize("multi_pod", [False, True])
def test_plan_builds_for_every_cell(multi_pod):
    """The reference's per-cell checks over every applicable cell: head
    mode only where the heads divide the model axis; the batch split
    divides the global batch."""
    for arch in ASSIGNED:
        for shape in sorted(SHAPES):
            cfg, wl = get(arch), SHAPES[shape]
            if not applicable(cfg, wl)[0]:
                continue
            plan = plan_sharding(cfg, wl, _mesh(multi_pod))
            if cfg.attn is not None:
                if plan.attn_mode == "head":
                    assert cfg.attn.n_heads % 16 == 0
                else:
                    assert cfg.attn.n_heads % 16 != 0
            assert (wl.global_batch % plan.data_size == 0
                    or plan.data_size == 1)


# ------------------------------------------------------ specs to placements

def test_placements_and_local_shapes():
    """A dim on two mesh axes is ``Shard(d)`` on both; size-1 axes
    replicate; the local shape divides by every axis of the dim."""
    mesh = make_production_mesh(multi_pod=True)
    assert mesh_name(mesh) == "2x16x16" and mesh.size == 512
    plan = plan_sharding(get("llama3-8b"), SHAPES["decode_32k"], mesh)
    axes = ("batch", "seq", "kv_heads", None)
    assert plan.spec(axes, (128, 1, 16, 128), activation=True) == (
        ("pod", "data"), None, "model", None)
    assert plan.placements(axes, (128, 1, 16, 128), activation=True) == (
        Shard(0), Shard(0), Shard(2))
    assert plan.local_shape(axes, (128, 1, 16, 128), activation=True) == (
        4, 1, 1, 128)
    one = AbstractMesh(("data", "model"), (1, 2))
    assert spec_placements(one, ("data", "model")) == (Replicate(), Shard(1))
    with pytest.raises(ValueError):
        spec_placements(mesh, (("data", "pod"),))
    defs = model_param_defs(get("smollm-135m"))
    assert _flat(lm_param_axes(get("smollm-135m")))["/embed"] == \
        defs["embed"].axes
