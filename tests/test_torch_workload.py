"""The port's workload specs against the reference's.

For every assigned arch x workload shape x {single, multi}: the model
inputs' shapes and dtypes (``meta`` tensors against ShapeDtypeStructs),
the applicability rules and the inputs' specs under the cell's plan equal
the reference's; then ``realize`` and the reference's three skip rules
(``tests/test_dryrun_integration.py::test_dryrun_skip_rules``).
"""
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.core import workload as jwork
from repro.core.config import SHAPES as J_SHAPES
from repro.core.registry import get as j_get
from repro.distributed.sharding import plan_sharding as j_plan
from repro.launch.steps import input_shardings as j_input_shardings
from repro_torch.configs import ASSIGNED
from repro_torch.core import workload
from repro_torch.core.config import SHAPES
from repro_torch.core.registry import get
from repro_torch.distributed.sharding import plan_sharding
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import input_shardings

CELLS = [(a, s, m) for a in ASSIGNED for s in sorted(SHAPES)
         for m in ("single", "multi")]

DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


def _j_mesh(multi: bool):
    shape = (2, 16, 16) if multi else (16, 16)
    names = ("pod", "data", "model") if multi else ("data", "model")
    return JAbstractMesh(shape, names)


def _norm(spec):
    parts = list(spec)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_inputs_and_applicability_match_reference(arch, shape, mesh):
    cfg, wl = get(arch), SHAPES[shape]
    jcfg, jwl = j_get(arch), J_SHAPES[shape]
    assert workload.applicable(cfg, wl) == jwork.applicable(jcfg, jwl)
    if wl.kind == "decode" and cfg.frontend == "audio":
        with pytest.raises(ValueError):
            workload.input_specs(cfg, wl)
        with pytest.raises(ValueError):
            jwork.input_specs(jcfg, jwl)
        return
    got = workload.input_specs(cfg, wl)
    want = jwork.input_specs(jcfg, jwl)
    assert list(got) == list(want)
    for name, sd in want.items():
        assert got[name].device.type == "meta"
        assert tuple(got[name].shape) == tuple(sd.shape), name
        assert got[name].dtype == DTYPES[sd.dtype.type], name
    multi = mesh == "multi"
    plan = plan_sharding(cfg, wl, make_production_mesh(multi_pod=multi))
    jplan = j_plan(jcfg, jwl, _j_mesh(multi))
    jsh = j_input_shardings(jcfg, want, jplan)
    sh = input_shardings(cfg, got, plan)
    for name in want:
        spec = plan.spec(("batch", "seq", None) if name == "features"
                         else ("batch", "seq"), got[name].shape,
                         activation=True)
        assert _norm(spec) == _norm(jsh[name].spec), name
        assert sh[name].placements == plan.placements(
            ("batch", "seq", None) if name == "features" else
            ("batch", "seq"), got[name].shape, activation=True)


def test_modality_constants_match_reference():
    assert (workload.VLM_PATCHES, workload.VLM_FEAT_DIM,
            workload.AUDIO_FEAT_DIM) == (jwork.VLM_PATCHES,
                                         jwork.VLM_FEAT_DIM,
                                         jwork.AUDIO_FEAT_DIM)


def test_realize_draws_from_a_seeded_generator():
    specs = workload.input_specs(get("llava-next-mistral-7b"),
                                 SHAPES["train_4k"])
    small = {k: torch.empty((2,) + tuple(v.shape[1:]), dtype=v.dtype,
                            device="meta") for k, v in specs.items()}
    a, b = workload.realize(small, 3), workload.realize(small, 3)
    c = workload.realize(small, 4)
    for k in small:
        assert a[k].shape == small[k].shape and a[k].dtype == small[k].dtype
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 100


def test_dryrun_skip_rules():
    """The reference's three skip rules, on the port's configs."""
    assert not workload.applicable(get("hubert-xlarge"),
                                   SHAPES["decode_32k"])[0]
    assert not workload.applicable(get("llama3-8b"), SHAPES["long_500k"])[0]
    assert workload.applicable(get("gemma3-1b"), SHAPES["long_500k"])[0]
    assert workload.applicable(get("mamba2-2.7b"), SHAPES["long_500k"])[0]
    assert workload.applicable(get("zamba2-2.7b"), SHAPES["long_500k"])[0]
