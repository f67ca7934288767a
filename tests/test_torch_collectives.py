"""The port's collective cost models against the reference's.

For every assigned arch x workload shape x {single, multi}: the ring
wire bytes of the data-parallel gradient reduce (fp32 and bf16), the
tensor-parallel all-reduce of one layer's activations and their times
over the cell's plan equal the reference's numbers; then the reference's
three wire-cost cases (``tests/test_collectives_and_tokenizer.py``) and
``tp_matmul_rs`` without a plan.
"""
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.core.config import SHAPES as J_SHAPES
from repro.core.registry import get as j_get
from repro.distributed import collectives as jcol
from repro.distributed.sharding import plan_sharding as j_plan
from repro_torch.configs import ASSIGNED
from repro_torch.core import memmodel
from repro_torch.core.config import SHAPES
from repro_torch.core.registry import get
from repro_torch.distributed.collectives import (WireCost,
                                                 grad_reduce_dtype_saving,
                                                 overlap_headroom,
                                                 tp_matmul_rs)
from repro_torch.distributed.sharding import plan_sharding
from repro_torch.launch.mesh import make_production_mesh

CELLS = [(a, s, m) for a in ASSIGNED for s in sorted(SHAPES)
         for m in ("single", "multi")]


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_cell_wire_costs_match_reference(arch, shape, mesh):
    multi = mesh == "multi"
    cfg, wl = get(arch), SHAPES[shape]
    jcfg = j_get(arch)
    plan = plan_sharding(cfg, wl, make_production_mesh(multi_pod=multi))
    jplan = j_plan(jcfg, J_SHAPES[shape], JAbstractMesh(
        (2, 16, 16) if multi else (16, 16),
        ("pod", "data", "model") if multi else ("data", "model")))
    pbytes = 4.0 * memmodel.param_count(cfg)
    assert pbytes == 4.0 * jcfg.param_count()
    got = grad_reduce_dtype_saving(pbytes, plan.data_size)
    want = jcol.grad_reduce_dtype_saving(pbytes, jplan.data_size)
    assert got == want
    # one layer's residual all-reduce over the model axis, and its time
    act = 2.0 * wl.tokens * cfg.d_model / max(plan.data_size, 1)
    wc, jwc = WireCost(plan.model_size), jcol.WireCost(jplan.model_size)
    for f in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all"):
        assert getattr(wc, f)(act) == getattr(jwc, f)(act)
    assert wc.time(wc.all_reduce(act)) == jwc.time(jwc.all_reduce(act))
    t_c = act / 1e12
    assert overlap_headroom(t_c, wc.time(wc.all_reduce(act))) == \
        jcol.overlap_headroom(t_c, jwc.time(jwc.all_reduce(act)))


def test_wire_costs_ring_factors():
    wc = WireCost(n=16)
    b = 1024.0
    assert abs(wc.all_reduce(b) - 2 * b * 15 / 16) < 1e-9
    assert abs(wc.all_gather(b) - b * 15 / 16) < 1e-9
    assert abs(wc.reduce_scatter(b) - b * 15 / 16) < 1e-9
    # AR == RS + AG (the sequence-parallel identity)
    assert abs(wc.all_reduce(b)
               - (wc.reduce_scatter(b) + wc.all_gather(b))) < 1e-9


def test_overlap_headroom():
    assert overlap_headroom(10.0, 5.0) == 1.0
    assert overlap_headroom(5.0, 10.0) == 0.5
    assert overlap_headroom(1.0, 0.0) == 1.0


def test_grad_compression_halves_wire():
    full, comp = grad_reduce_dtype_saving(1e9, 16)
    assert abs(full / comp - 2.0) < 1e-9
    assert grad_reduce_dtype_saving(1e9, 16, compressed=False) == (full,
                                                                   full)


def test_tp_matmul_rs_without_a_plan_is_the_product():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 8, generator=g)
    w = torch.randn(8, 5, generator=g)
    y = tp_matmul_rs(x, w, ("batch", "residual_seq", "embed"))
    np.testing.assert_allclose(y.numpy(), np.einsum("bsk,km->bsm", x.numpy(),
                                                    w.numpy()),
                               rtol=1e-6, atol=1e-6)
