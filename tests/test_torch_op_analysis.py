"""The characterization layer's static half against the reference, on the
CPU.

* ``telemetry.operator_costs`` (the port's walk of the plain path) against
  the reference's over its compiled HLO (jitted on the ``ref`` backend) on
  reduced mamba2-2.7b, zamba2-2.7b, a ``dense`` model (llama3-8b),
  mamba-130m and falcon-h1-0.5b, for ``lm_decode_step`` and one
  ``lm_prefill_chunk``: the same classes with non-zero FLOPs, and
  ``gemm`` FLOPs within 1%.  One product differs by design: XLA leaves
  three batched products of the reference's plain SSD (``ssd_core``) with
  no scope metadata, so the reference's walk counts them ``gemm``; the
  port's plain SSD runs inside ``ssd_core`` and they are ``ssm``.  The
  comparison takes them out of the reference's ``gemm``, and they occur
  only where the call runs SSD.
* The scope names one decode step and one chunk record equal the
  ``named_scope`` names in the reference's HLO metadata for the same call.
* A full-width walk on ``meta`` of mamba2-2.7b's and falcon-h1-0.5b's
  decode step at B = 4: ``gemm`` FLOPs within 1% of 2 x B x (the step's
  matrix parameters plus the head), from ``model_param_defs``; the
  hand-written kernels are one ``KernelCost`` each, in ``ssm`` or
  ``other`` by their scope.
* ``roofline.compute_roofline``, ``op_class_times``, ``model_flops`` and
  ``energy.energy_report`` equal the reference's on one hand-built
  ``CostSummary`` for the three reference specs; ``active_param_count``
  equals the reference's for every registered config; ``H100_SXM``'s
  data-sheet numbers.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_8b as J_LLAMA
from repro.configs import mamba2_2p7b as J_MAMBA2
from repro.configs import reduced as j_reduced
from repro.configs import zamba2_2p7b as J_ZAMBA
from repro.configs.paper_models import FALCON_H1_05B as J_FALCON
from repro.configs.paper_models import MAMBA1_130M as J_MAMBA1
from repro.core import config as jconfig
from repro.core import energy as jenergy
from repro.core import hlo_analysis as jhlo
from repro.core import registry as jregistry
from repro.core import roofline as jroofline
from repro.models import lm as jlm
from repro.serving.telemetry import operator_costs as j_operator_costs
from repro_torch.configs import falcon_h1_05b as T_FALCON
from repro_torch.configs import llama3_8b as T_LLAMA
from repro_torch.configs import mamba2_2p7b as T_MAMBA2
from repro_torch.configs import mamba_130m as T_MAMBA1
from repro_torch.configs import reduced
from repro_torch.configs import zamba2_2p7b as T_ZAMBA
from repro_torch.core import config as tconfig
from repro_torch.core import energy as tenergy
from repro_torch.core import memmodel as tmem
from repro_torch.core import registry as tregistry
from repro_torch.core import roofline as troofline
from repro_torch.core.classify import KNOWN_SCOPES, classify
from repro_torch.core import op_analysis as top
from repro_torch.core.op_analysis import (analyze,
                                          meta_like, meta_params)
from repro_torch.models import lm
from repro_torch.serving.telemetry import operator_costs

ARCHS = {"mamba2": (J_MAMBA2, T_MAMBA2), "hybrid": (J_ZAMBA, T_ZAMBA),
         "dense": (J_LLAMA, T_LLAMA), "mamba1": (J_MAMBA1, T_MAMBA1),
         "hybrid_par": (J_FALCON, T_FALCON)}
B, MAX_SEQ, CHUNK = 2, 32, 8
# relative limit on gemm FLOPs: the same products on both sides
GEMM_RTOL = 0.01


def _calls(arch, which):
    """The reference's compiled call and the port's (fn, args, kwargs) for
    one decode step or one ragged prefill chunk at offsets 3 and 5.  The
    costs depend on shapes alone: the reference is lowered on abstract
    params and cache (``jax.eval_shape``), the port walks seeded ones."""
    jbase, tbase = ARCHS[arch]
    jcfg = dataclasses.replace(j_reduced(jbase, vocab=250, n_units=1),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(reduced(tbase, vocab=250, n_units=1),
                               compute_dtype="float32")
    jp = jax.eval_shape(lambda k: jlm.init_lm_params(jcfg, k),
                        jax.random.PRNGKey(0))
    j_cache = jax.eval_shape(
        lambda: jlm.init_lm_cache(jcfg, B, MAX_SEQ, dtype=jnp.float32))
    tp = lm.prepare_params(tcfg, lm.init_lm_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu"))
    t_cache = lm.init_lm_cache(tcfg, B, MAX_SEQ, dtype=torch.float32,
                               device="cpu")
    t_cache = dict(t_cache, pos=torch.tensor([3, 5], dtype=torch.int32))
    if which == "decode":
        tok = np.array([[7], [11]], np.int32)
        compiled = jax.jit(
            lambda p, c, t: jlm.lm_decode_step(jcfg, p, t, c)).lower(
            jp, j_cache, jnp.asarray(tok)).compile()
        return compiled, (lm.lm_decode_step,
                          (tcfg, tp, torch.from_numpy(tok), t_cache), {})
    toks = np.arange(B * CHUNK, dtype=np.int32).reshape(B, CHUNK) % 250
    lens = np.array([CHUNK, 5], np.int32)
    compiled = jax.jit(
        lambda p, c, t, n: jlm.lm_prefill_chunk(
            jcfg, p, {"tokens": t}, c, lengths=n)).lower(
        jp, j_cache, jnp.asarray(toks), jnp.asarray(lens)).compile()
    return compiled, (lm.lm_prefill_chunk,
                      (tcfg, tp, torch.from_numpy(toks), t_cache),
                      {"lengths": torch.from_numpy(lens)})


def _hlo_scopes(text):
    names = set()
    for m in re.finditer(r'op_name="([^"]*)"', text):
        names.update(p for p in m.group(1).split("/") if p in KNOWN_SCOPES)
    return names


@pytest.mark.parametrize("which", ["decode", "chunk"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_operator_costs_match_reference(arch, which):
    compiled, (fn, args, kwargs) = _calls(arch, which)
    want = j_operator_costs(compiled)
    got = operator_costs(fn, *args, **kwargs)
    nz = lambda c: {k for k, v in c["by_class"].items() if v["flops"] > 0}
    assert nz(got) == nz(want)
    scopes = analyze(fn, *args, **kwargs).scopes
    # the SSD products XLA strips of their scope (module docstring)
    stripped = sum(k.flops * k.count
                   for k in jhlo.analyze_hlo_text(compiled.as_text()).kernels
                   if k.clazz == "gemm" and not k.scope)
    assert (stripped > 0) == (which == "chunk" and "ssd_core" in scopes)
    g = got["by_class"]["gemm"]["flops"]
    w = want["by_class"]["gemm"]["flops"] - stripped
    assert g == pytest.approx(w, rel=GEMM_RTOL)
    for c in got["by_class"].values():
        assert 0.0 <= c["flop_share"] <= 1.0
    assert sum(c["flop_share"] for c in got["by_class"].values()) == \
        pytest.approx(1.0)
    assert got["flops"] > 0 and got["bytes"] > 0
    # the scope names recorded are the reference's named_scope names
    assert scopes == _hlo_scopes(compiled.as_text())


def _matrix_params(cfg):
    """Per-token matrix weights of one decode step, from
    ``model_param_defs``: every 2-D-or-more leaf of the layers read by a
    product, the shared block once per use, and the head."""
    defs = lm.model_param_defs(cfg)
    mats = {"wq", "wk", "wv", "wo", "wi", "wg", "wz", "wxBC", "wdt",
            "out_proj", "wx", "x_proj", "dt_proj"}

    def count(tree, mult=1):
        total = 0
        for k, v in tree.items():
            if isinstance(v, dict):
                total += count(v, mult)
            elif k in mats:
                total += mult * int(np.prod(v.shape))
        return total
    total = sum(count(layer) for seg in defs["segments"] for layer in seg)
    if "shared" in defs:
        total += cfg.layer_kinds.count("mamba2+shared") * count(
            defs["shared"])
    return total + cfg.d_model * cfg.padded_vocab


@pytest.mark.parametrize("cfg", [T_MAMBA2, T_FALCON], ids=lambda c: c.name)
def test_full_width_meta_walk_of_the_decode_step(cfg):
    b = 4
    params = meta_params(cfg)
    cache = meta_like(lm.init_lm_cache(cfg, b, 4096, device="meta"))
    tok = torch.zeros((b, 1), dtype=torch.int32, device="meta")
    s = analyze(lm.lm_decode_step, cfg, params, tok, cache, kv_bucket=2048)
    gemm = s.by_class()["gemm"]["flops"]
    assert gemm == pytest.approx(2.0 * b * _matrix_params(cfg), rel=0.01)
    kernels = [k for k in s.kernels if k.opcode == "kernel"]
    n_attn = sum(k in ("dense", "hybrid_par") for k in cfg.layer_kinds)
    assert sorted({k.name for k in kernels}) == sorted(
        {"mamba2_decode_fused"} | ({"decode_attention"} if n_attn else set()))
    assert len(kernels) == cfg.n_layers + n_attn
    for k in kernels:
        assert k.clazz == ("ssm" if k.name == "mamba2_decode_fused"
                           else "other")
        assert k.flops > 0 and k.bytes > 0


def test_classify_priority_order():
    assert classify(("mlp",), "mm") == "gemm"
    assert classify("ssd_core", "mm") == "ssm"          # SSM scope first
    assert classify(("norm",), "mm") == "gemm"          # products before norm
    assert classify(("norm",), "add") == "norm"
    assert classify((), "all_reduce") == "collective"
    assert classify((), "index_put_") == "memory"
    assert classify((), "add_") == "arith"
    assert classify(("attn_core",), "flash_attention") == "other"
    assert classify(("decode_fused",), "mamba2_decode_fused") == "ssm"


def _summary(mod):
    return mod.CostSummary(kernels=[
        mod.KernelCost("dot.1", "dot", "gemm", "mlp", flops=4e12, bytes=2e9),
        mod.KernelCost("f.2", "fusion", "norm", "norm", flops=1e9,
                       bytes=3e10, count=3),
        mod.KernelCost("f.3", "fusion", "ssm", "ssd_core", flops=2e11,
                       bytes=5e9),
        mod.KernelCost("ar.4", "all-reduce", "collective", "", bytes=1e8,
                       coll_bytes=4e8, count=2)])


@pytest.mark.parametrize("hw", ["tpu_v5e", "rtx4090", "jetson_orin_nano"])
def test_roofline_and_energy_equal_reference(hw):
    th, jh = tconfig.HARDWARE[hw], jconfig.HARDWARE[hw]
    assert dataclasses.asdict(th) == dataclasses.asdict(jh)
    tc, jc = _summary(top), _summary(jhlo)
    kw = dict(chips=4, arch="a", shape="s", mesh="m", mflops=3e12)
    tr = troofline.compute_roofline(tc, th, **kw)
    jr = jroofline.compute_roofline(jc, jh, **kw)
    for attr in ("t_compute", "t_memory", "t_collective", "t_bound",
                 "t_serial", "useful_ratio", "mfu_bound", "dominant",
                 "class_breakdown"):
        assert getattr(tr, attr) == getattr(jr, attr), attr
    assert troofline.op_class_times(tc, th) == jroofline.op_class_times(
        jc, jh)
    assert troofline.op_scope_times(tc, th) == jroofline.op_scope_times(
        jc, jh)
    assert tenergy.energy_report(tc, th) == jenergy.energy_report(jc, jh)


def test_model_flops_and_active_params_equal_reference():
    for name in tregistry.list_archs():
        tcfg, jcfg = tregistry.get(name), jregistry.get(name)
        assert tmem.active_param_count(tcfg) == jcfg.active_param_count()
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            assert troofline.model_flops(
                tcfg, tconfig.SHAPES[shape]) == jroofline.model_flops(
                jcfg, jconfig.SHAPES[shape])
    h = tconfig.H100_SXM
    assert (h.peak_flops, h.hbm_bw, h.hbm_bytes) == (989e12, 3.35e12, 80e9)
    assert h.power_w == 700.0 and 0 < h.idle_w < h.power_w
