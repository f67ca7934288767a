"""The Mamba kernels' destination writes and the SSD launch plan, on the
CPU; and the head dims and Mamba shapes every registered config needs.

A Mamba layer's kernels write its new states straight into the layer's
slot of the new cache: the conv kernel its conv state (prefill), the
decode steps the conv window and the SSM state, and SSD (Mamba-2) the
final SSM state.  ``_run_segments`` hands the slots over and
``_store_state`` copies only what is not already there; the selective
scan writes its final state (Mamba-1 prefill) into its slot too.  Here
reduced(mamba2-2.7b), reduced(zamba2-2.7b) and reduced(mamba-130m) run a
prefill chunk and a decode step on the plain path (whose ops copy into
the slots as the kernels write them) against the reference, with the
reference's params carried across (``from_jax``), in fp32 and bf16
compute on caches of that type (the conv window's type is the one the
kernels write): the old cache's state leaves stay as they were, the new
ones equal those of the path that copies every state (bit for bit) and,
in fp32, the reference's (1e-4 of max(1, max |leaf|); in bf16 the two
frameworks round at different points, by up to ~3e-2 here), and
``_store_state`` copies no leaf a kernel wrote.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_2p7b as J_MAMBA2
from repro.configs import reduced as j_reduced
from repro.configs import zamba2_2p7b as J_ZAMBA
from repro.configs.paper_models import MAMBA1_130M as J_MAMBA1
from repro.models import lm as jlm
from repro_torch.configs import mamba2_2p7b as T_MAMBA2
from repro_torch.configs import mamba_130m as T_MAMBA1
from repro_torch.configs import reduced
from repro_torch.configs import zamba2_2p7b as T_ZAMBA
from repro_torch.convert import from_jax, to_numpy
from repro_torch.core.registry import get, list_archs
from repro_torch.kernels import build
from repro_torch.kernels.attn_decode import ops as dec_attn_ops
from repro_torch.kernels.conv1d import ops as conv_ops
from repro_torch.kernels.decode_fused import ops as dec_ops
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.scan1 import ops as scan_ops
from repro_torch.kernels.scan1 import ref as scan_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models import lm
from repro_torch.models import mamba1 as m1

MODELS = {"mamba2": (J_MAMBA2, T_MAMBA2), "zamba2": (J_ZAMBA, T_ZAMBA)}
MAMBA1 = {"mamba1": (J_MAMBA1, T_MAMBA1)}
SMEM_PER_BLOCK = 232448     # bytes a block may hold on an H100 (227 KB)
SMEM_PER_SM = 233472        # an SM's shared memory (228 KB), 1 KB a block
STATE_KEYS = ("conv", "ssm")


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(model, compute_dtype):
    jbase, tbase = {**MODELS, **MAMBA1}[model]
    return (dataclasses.replace(j_reduced(jbase, vocab=250),
                                compute_dtype=compute_dtype),
            dataclasses.replace(reduced(tbase, vocab=250),
                                compute_dtype=compute_dtype))


def _params(jcfg):
    jp = jlm.init_lm_params(jcfg, jax.random.PRNGKey(0))
    return jp, from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _state_leaves(segments):
    """(segment, layer, key) -> every Mamba state leaf of a cache."""
    return {(si, li, k): layer[k] for si, seg in enumerate(segments)
            for li, layer in enumerate(seg) for k in STATE_KEYS
            if k in layer}


def _close_states(got, want, tol):
    """Each state leaf within ``tol`` of max(1, max |reference leaf|)."""
    for key, t in _state_leaves(got).items():
        si, li, k = key
        w = np.asarray(want[si][li][k], np.float32)
        err = float(np.abs(to_numpy(t) - w).max())
        assert err <= tol * max(1.0, float(np.abs(w).max())), (key, err)


def _same_as_copying(run, new_segments, monkeypatch):
    """``run()`` again with no slots handed to the layers (every new state
    is copied into the new cache, as before the kernels wrote in place)
    gives the same bits."""
    with monkeypatch.context() as m:
        m.setattr(lm, "_state_slots", lambda seg, r: {})
        _, copied = run()
    got, want = _state_leaves(new_segments), _state_leaves(copied["segments"])
    assert got.keys() == want.keys()
    for key in got:
        assert torch.equal(got[key], want[key]), key


@pytest.fixture
def copies(monkeypatch):
    """The number of leaves each layer's ``_store_state`` call copied (its
    nested calls for the shared block's KV dict apart); ``copies.keys``
    lists the copied leaves' keys per layer."""
    seen = Copies()
    real = lm._store_state

    def spy(dst, src, r):
        keys = [k for k, v in src.items() if k in STATE_KEYS
                and v.data_ptr() != dst[k][r].data_ptr()]
        n = real(dst, src, r)
        if "ssm" in src:
            seen.append(n)
            seen.keys.append(keys)
        return n
    monkeypatch.setattr(lm, "_store_state", spy)
    return seen


class Copies(list):
    def __init__(self):
        super().__init__()
        self.keys = []

    def clear(self):
        super().clear()
        self.keys.clear()


def _prefilled(jcfg, tcfg, jp, tp, cd, b=2, s=21, max_seq=40):
    """The caches after a prompt, in the compute dtype (so the conv
    window's type is the one the decode kernel writes): the port's, and
    in fp32 the reference's (None in bf16)."""
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (b, s))
    toks = toks.astype(np.int32)
    jc = None
    if cd == "float32":
        _, jc = jlm.lm_prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                               jlm.init_lm_cache(jcfg, b, max_seq,
                                                 dtype=DTYPES[cd][0]))
    _, tc = lm.lm_prefill(tcfg, tp, torch.from_numpy(toks),
                          lm.init_lm_cache(tcfg, b, max_seq,
                                           dtype=DTYPES[cd][1],
                                           device="cpu"))
    return jc, tc


@pytest.mark.parametrize("cd", list(DTYPES))
@pytest.mark.parametrize("model", list(MODELS))
def test_prefill_chunk_writes_ssm_state_in_place(model, cd, copies,
                                                  monkeypatch):
    """A ragged prefill chunk on a carried cache: the SSM state and the
    conv window land in their slots (no copy at all), the old cache is
    unchanged, the new states equal the copying path's bit for bit and
    the reference's."""
    jcfg, tcfg = _cfgs(model, cd)
    jp, tp = _params(jcfg)
    jc, tc = _prefilled(jcfg, tcfg, jp, tp, cd)
    before = {k: v.clone() for k, v in _state_leaves(tc["segments"]).items()}
    toks = np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 16))
    toks = toks.astype(np.int32)
    lens = np.array([16, 9], np.int32)

    def run():
        return lm.lm_prefill_chunk(tcfg, tp, torch.from_numpy(toks), tc,
                                   lengths=torch.from_numpy(lens))
    copies.clear()
    _, t_new = run()
    assert copies == [0] * tcfg.n_layers
    _same_as_copying(run, t_new["segments"], monkeypatch)
    for key, t in _state_leaves(tc["segments"]).items():
        assert torch.equal(t, before[key]), key
    if jc is not None:
        _, j_new = jlm.lm_prefill_chunk(
            jcfg, jp, {"tokens": jnp.asarray(toks)}, jc,
            lengths=jnp.asarray(lens))
        _close_states(t_new["segments"], j_new["segments"], 1e-4)


@pytest.mark.parametrize("cd", list(DTYPES))
@pytest.mark.parametrize("model", list(MODELS))
def test_decode_step_writes_states_in_place(model, cd, copies,
                                            monkeypatch):
    """A decode step: the conv window and the SSM state both land in their
    slots (no copy at all), the old cache is unchanged, the new states
    equal the copying path's bit for bit and the reference's."""
    jcfg, tcfg = _cfgs(model, cd)
    jp, tp = _params(jcfg)
    jc, tc = _prefilled(jcfg, tcfg, jp, tp, cd)
    before = {k: v.clone() for k, v in _state_leaves(tc["segments"]).items()}
    tok = np.array([[3], [7]], np.int32)

    def run():
        return lm.lm_decode_step(tcfg, tp, torch.from_numpy(tok), tc)
    copies.clear()
    _, t_new = run()
    assert copies == [0] * tcfg.n_layers
    _same_as_copying(run, t_new["segments"], monkeypatch)
    for key, t in _state_leaves(tc["segments"]).items():
        assert torch.equal(t, before[key]), key
    if jc is not None:
        _, j_new = jlm.lm_decode_step(jcfg, jp, jnp.asarray(tok), jc)
        _close_states(t_new["segments"], j_new["segments"], 1e-4)
    # the returned leaves are the new cache's own storage, not the old's
    new, old = _state_leaves(t_new["segments"]), _state_leaves(tc["segments"])
    for key in new:
        assert new[key].data_ptr() != old[key].data_ptr()


@pytest.mark.parametrize("cd", list(DTYPES))
@pytest.mark.parametrize("model", list(MAMBA1))
def test_mamba1_prefill_chunk_writes_conv_in_place(model, cd, copies,
                                                   monkeypatch):
    """reduced(mamba-130m), a ragged prefill chunk on a carried cache: the
    conv window and the scan's final state both land in their slots (no
    Mamba-1 leaf is copied), the old cache is unchanged, the new states
    equal the copying path's bit for bit and the reference's."""
    jcfg, tcfg = _cfgs(model, cd)
    jp, tp = _params(jcfg)
    jc, tc = _prefilled(jcfg, tcfg, jp, tp, cd)
    before = {k: v.clone() for k, v in _state_leaves(tc["segments"]).items()}
    toks = np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 16))
    toks = toks.astype(np.int32)
    lens = np.array([16, 2], np.int32)

    def run():
        return lm.lm_prefill_chunk(tcfg, tp, torch.from_numpy(toks), tc,
                                   lengths=torch.from_numpy(lens))
    copies.clear()
    _, t_new = run()
    assert copies == [0] * tcfg.n_layers
    assert copies.keys == [[]] * tcfg.n_layers
    _same_as_copying(run, t_new["segments"], monkeypatch)
    for key, t in _state_leaves(tc["segments"]).items():
        assert torch.equal(t, before[key]), key
    if jc is not None:
        _, j_new = jlm.lm_prefill_chunk(
            jcfg, jp, {"tokens": jnp.asarray(toks)}, jc,
            lengths=jnp.asarray(lens))
        _close_states(t_new["segments"], j_new["segments"], 1e-4)
    new, old = _state_leaves(t_new["segments"]), _state_leaves(tc["segments"])
    for key in new:
        assert new[key].data_ptr() != old[key].data_ptr()


@pytest.mark.parametrize("cd", list(DTYPES))
@pytest.mark.parametrize("model", list(MAMBA1))
def test_mamba1_decode_step_writes_states_in_place(model, cd, copies,
                                                   monkeypatch):
    """reduced(mamba-130m), a decode step: the conv window and the SSM
    state both land in their slots (no copy at all), the old cache is
    unchanged, the new states equal the copying path's bit for bit and
    the reference's."""
    jcfg, tcfg = _cfgs(model, cd)
    jp, tp = _params(jcfg)
    jc, tc = _prefilled(jcfg, tcfg, jp, tp, cd)
    before = {k: v.clone() for k, v in _state_leaves(tc["segments"]).items()}
    tok = np.array([[3], [7]], np.int32)

    def run():
        return lm.lm_decode_step(tcfg, tp, torch.from_numpy(tok), tc)
    copies.clear()
    _, t_new = run()
    assert copies == [0] * tcfg.n_layers
    _same_as_copying(run, t_new["segments"], monkeypatch)
    for key, t in _state_leaves(tc["segments"]).items():
        assert torch.equal(t, before[key]), key
    if jc is not None:
        _, j_new = jlm.lm_decode_step(jcfg, jp, jnp.asarray(tok), jc)
        _close_states(t_new["segments"], j_new["segments"], 1e-4)
    new, old = _state_leaves(t_new["segments"]), _state_leaves(tc["segments"])
    for key in new:
        assert new[key].data_ptr() != old[key].data_ptr()


def test_store_state_copies_only_what_is_elsewhere():
    dst = {"conv": torch.zeros(3, 2, 5), "ssm": torch.zeros(3, 2, 4),
           "attn": {"k": torch.zeros(3, 2, 8)}}
    src = {"conv": torch.ones(2, 5), "ssm": dst["ssm"][1],
           "attn": {"k": torch.ones(2, 8)}}
    src["ssm"].fill_(2.0)
    assert lm._store_state(dst, src, 1) == 1
    assert torch.equal(dst["conv"][1], torch.ones(2, 5))
    assert torch.equal(dst["ssm"][1], torch.full((2, 4), 2.0))
    assert not dst["attn"]["k"].any()      # KV leaves are never copied
    slots = lm._state_slots(dst, 2)
    assert set(slots) == {"conv", "ssm"}
    assert slots["ssm"].data_ptr() == dst["ssm"][2].data_ptr()


@pytest.mark.parametrize("wrong", ["shape", "dtype", "strides", "overlap"])
def test_destination_must_fit(wrong):
    """A destination the kernel could not write as it stands raises on the
    kernel path: a wrong shape, type or layout, or one that overlaps an
    input."""
    b, h, p, n = 2, 4, 16, 16
    good = torch.zeros(b, h, p, n)
    stacked = torch.zeros(3, b, h, p, n)
    bad = {"shape": torch.zeros(b, h, p, n + 1),
           "dtype": torch.zeros(b, h, p, n, dtype=torch.float64),
           "strides": torch.zeros(b, h, n, p).transpose(2, 3),
           "overlap": stacked[1]}[wrong]
    dst = stacked[2]
    assert build.destination(dst, good, "out_ssm", (stacked[1], good)) is dst
    with pytest.raises(ValueError, match="out_ssm"):
        build.destination(bad, good, "out_ssm", (stacked[1],))


@pytest.mark.parametrize("with_out", [False, True])
def test_plain_ssd_fills_destination(with_out):
    """The plain SSD hands its final state over in ``out_state`` exactly as
    it returns it without one."""
    rng = np.random.default_rng(7)
    b, s, h, p, n = 2, 32, 4, 16, 16

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    args = (t(b, s, h, p), ssd_ref.softplus(t(b, s, h)),
            -torch.exp(t(h)), t(b, s, 1, n), t(b, s, 1, n), t(h))
    h0 = t(b, h, p, n)
    want = ssd_ref.ssd_chunked_ref(*args, chunk=16, initial_state=h0)
    out = torch.empty(b, h, p, n) if with_out else None
    got = ssd_ops.ssd_chunked(*args, chunk=16, initial_state=h0,
                              out_state=out)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if with_out:
        assert got[1] is out


@pytest.mark.parametrize("with_out", [False, True])
def test_plain_scan_fills_destination(with_out):
    """The plain selective scan hands its final state over in
    ``out_state`` exactly as it returns it without one, also when the
    destination is the initial state itself."""
    rng = np.random.default_rng(8)
    b, s, c, n = 2, 40, 24, 16

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    args = (t(b, s, c), scan_ref.softplus(t(b, s, c)), -torch.exp(t(c, n)),
            t(b, s, n), t(b, s, n), t(c))
    h0 = t(b, c, n)
    want = scan_ref.selective_scan_ref(*args, h0)
    out = torch.empty(b, c, n) if with_out else None
    got = scan_ops.selective_scan(*args, initial_state=h0, out_state=out)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if with_out:
        assert got[1] is out
    got = scan_ops.selective_scan(*args, initial_state=h0, out_state=h0)
    assert got[1] is h0 and torch.equal(h0, want[1])


# ----------------------------------------------------------- launch plan

@pytest.mark.parametrize("b,s,c,n,dtype,plan,blocks", [
    (4, 256, 1536, 16, torch.bfloat16, 1, 768),     # mamba-130m's chunk
    (1, 16384, 1536, 16, torch.bfloat16, 0, 384),   # long context, B=1
    (2, 256, 1536, 16, torch.float32, 0, 768),
    (3, 200, 1000, 8, torch.bfloat16, 0, 750),
    (4, 200, 1000, 8, torch.bfloat16, 1, 500),
    (1, 7, 1003, 16, torch.float32, 0, 252)])       # C padded to 1008
def test_scan1_plan(b, s, c, n, dtype, plan, blocks):
    """Blocks of 8 channels of one batch row, a warp a channel, where
    that gives three blocks an SM, else of 4; the block's shared memory
    fits 4 blocks of 4 channels an SM in bf16 (2 blocks of 8, and 2 of 4
    in fp32), and the rows read are C rounded up to 8."""
    p = scan_ops.scan1_plan(b, s, c, n, dtype)
    assert (p.index, p.blocks) == (plan, blocks)
    assert p.ldc == -(-c // 8) * 8 and p.ldc % 8 == 0
    assert p.threads == 32 * p.channels
    assert p.blocks == b * (p.ldc // p.channels)
    per_sm = 4 if dtype == torch.bfloat16 and p.channels == 4 else 2
    assert per_sm * (p.smem_bytes + 1024) <= SMEM_PER_SM
    assert p.smem_bytes <= SMEM_PER_BLOCK


def test_scan1_plan_smem_matches_layout():
    """The plan's shared-memory bytes, worked out by hand from
    ``csrc/scan1.cu``'s Layout at mamba-130m's bf16 chunk (8 steps a
    lane, 8 channels a block): two stages of x (32 runs of 8 rows of 16
    bytes, each run followed by 16 bytes) and dt (rows of 32 bytes), B's
    and C's raw rows (256 of 32 bytes each) and cooked (32 runs of 64
    words and one), and the y values (32 runs of 8 rows of 8 floats and
    one word)."""
    stage = 32 * (8 * 16 + 16) + 32 * (8 * 32 + 16)
    want = 2 * stage + 2 * 256 * 32 + 2 * 4 * 32 * 65 + 4 * 32 * 65
    assert scan_ops.scan1_plan(4, 256, 1536, 16,
                               torch.bfloat16).smem_bytes == want


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_scan1_plan_unbuilt(dtype):
    """A d_state or type the scan kernel is not built for raises."""
    with pytest.raises(ValueError, match="d_state"):
        scan_ops.scan1_plan(1, 8, 64, 32, torch.bfloat16)
    with pytest.raises(TypeError):
        scan_ops.scan1_plan(1, 8, 64, 16, dtype)


@pytest.mark.parametrize("b,h", [(4, 80), (1, 80), (1, 24), (2, 33),
                                 (2, 34)])
@pytest.mark.parametrize("n", [128, 64])
def test_ssd_plan_tensor_cores(b, h, n):
    """bf16 at the served (P, N) takes tensor cores, one block per (batch
    row, head); a block's shared memory fits."""
    plan = ssd_ops.ssd_plan(b, h, 128, 64, n, torch.bfloat16)
    assert plan.route == "mma"
    assert plan.blocks == b * h
    assert plan.smem_bytes == _tc_smem(64, n)
    assert plan.smem_bytes <= SMEM_PER_BLOCK


def _tc_smem(p, n):
    """Two stages of bf16 x, B, C with 8-element row padding, the state's
    two bf16 terms, six fp32 rows of per-token scalars."""
    return (2 * (2 * 128 * ((p + 8) + 2 * (n + 8)) + 2 * p * (n + 8))
            + 6 * 128 * 4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_plan_unbuilt_shape(dtype):
    """A (chunk, P, N) with no instance is refused before any launch, on
    either route."""
    with pytest.raises(ValueError, match="ssd kernel built"):
        ssd_ops.ssd_plan(4, 80, 128, 32, 128, dtype)
    with pytest.raises(ValueError, match="ssd kernel built"):
        ssd_ops.ssd_plan(4, 80, 64, 64, 64, dtype)


def test_ssd_plan_cuda_cores():
    for shape, dtype in (((128, 64, 128), torch.float32),
                         ((16, 16, 16), torch.bfloat16),
                         ((16, 16, 16), torch.float32)):
        plan = ssd_ops.ssd_plan(4, 80, *shape, dtype)
        assert (plan.route, plan.blocks) == ("cuda_cores", 320)
        assert plan.smem_bytes <= SMEM_PER_BLOCK
    # the CUDA-core kernel's fp32 stages at mamba2-2.7b's shape: ~215 KB
    assert ssd_ops.ssd_plan(4, 80, 128, 64, 128,
                            torch.float32).smem_bytes == 4 * (
        64 * 129 + 2 * 128 * 129 + 128 * 64 + 32 * 144 + 3 * 128)
    with pytest.raises(ValueError, match="ssd kernel built"):
        ssd_ops.ssd_plan(4, 80, 128, 32, 128, torch.bfloat16)


# ------------------------------------------------------------- head dims

@pytest.mark.parametrize("arch", list_archs())
def test_registered_head_dims_are_built(arch):
    """Every head_dim of every config the port registers has a flash and a
    decode-attention instance, so no registered model fails at its first
    attention call on the card."""
    cfg = get(arch)
    dims = {a.head_dim for a in (cfg.attn, cfg.shared_attn) if a is not None}
    for d in dims:
        assert d in flash_ops.HEAD_DIMS, (arch, d)
        assert d in dec_attn_ops.HEAD_DIMS, (arch, d)


@pytest.mark.parametrize("arch", list_archs())
def test_registered_groups_are_built(arch):
    """Every attention of every config the port registers has a query
    group (query heads per KV head) the decode-attention kernel takes,
    up to glm4-9b's 16, and a flash launch plan in bf16."""
    cfg = get(arch)
    for a in (cfg.attn, cfg.shared_attn):
        if a is None:
            continue
        assert a.n_heads % a.n_kv_heads == 0, arch
        assert a.n_heads // a.n_kv_heads <= dec_attn_ops.MAX_GROUP, arch
        plan = flash_ops.flash_plan(4, a.n_heads, a.n_kv_heads, 256, 2048,
                                    a.head_dim, torch.bfloat16)
        assert (a.n_heads // a.n_kv_heads) % plan.heads_packed == 0, arch


@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if get(a).ssm is not None
                                  and get(a).ssm.variant != "mamba1"])
def test_registered_mamba2_shapes_are_built(arch):
    """Every Mamba-2 config the port registers fits the SSD scan's and the
    decode step's instances."""
    s = get(arch).ssm
    assert (s.chunk, s.headdim, s.d_state) in ssd_ops.SHAPES, arch
    assert s.d_state in dec_ops.M2_D_STATES, arch
    assert s.headdim <= dec_ops.M2_MAX_HEADDIM, arch


# the layer kinds the port trains on the card (flash, SSD and conv1d
# backward kernels)
TRAINED_KINDS = {"dense", "mamba2", "mamba2+shared"}


@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if set(get(a).layer_kinds)
                                  <= TRAINED_KINDS])
def test_registered_backward_shapes_take_tensor_cores(arch):
    """Every config the port trains on the card runs its flash and SSD
    backwards on tensor cores in bf16 (at B=4, S=2048 and at S=300, not a
    multiple of a tile), each launch within a block's 227 KB of shared
    memory, the scratch as the plan sizes it."""
    cfg = get(arch)
    for s in (2048, 300):
        for a in (cfg.attn, cfg.shared_attn):
            if a is None:
                continue
            plan = flash_ops.flash_bwd_plan(4, a.n_heads, a.n_kv_heads, s,
                                            a.head_dim, torch.bfloat16)
            assert plan.route == "wgmma", (arch, a.head_dim)
            assert max(plan.smem_bytes) <= SMEM_PER_BLOCK, arch
            assert plan.scratch == (4, a.n_heads, -(-s // 128) * 128, 2)
            assert plan.blocks[1:] == (-(-s // 128) * a.n_kv_heads * 4,
                                       -(-s // 128) * a.n_heads * 4)
    sc = cfg.ssm
    if sc is None:
        return
    h, g = sc.n_ssm_heads(cfg.d_model), sc.n_groups
    plan = ssd_ops.ssd_bwd_plan(4, 2048, h, sc.chunk, sc.headdim, g,
                                sc.d_state, torch.bfloat16)
    assert plan.route == "mma", arch
    assert max(plan.smem_bytes) <= SMEM_PER_BLOCK, arch
    hs = plan.heads_per_block
    assert (h // g) % hs == 0 and 1 <= hs <= ssd_ops.MAX_SLICE, arch
    nc = 2048 // sc.chunk
    assert plan.blocks[0] == plan.blocks[2] == 4 * nc * (h // hs)
    assert plan.scratch[5] == (4, h, nc, sc.headdim, sc.d_state)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_plans_cuda_cores(dtype):
    """fp32 at the trained shapes and both types at the reduced test
    shapes keep the CUDA-core backwards and their scratch."""
    plan = flash_ops.flash_bwd_plan(2, 6, 2, 100, 16, dtype)
    assert plan.route == "cuda_cores" and plan.scratch == (2, 6, 100)
    plan = ssd_ops.ssd_bwd_plan(2, 64, 4, 16, 16, 2, 16, dtype)
    assert plan.route == "cuda_cores" and plan.blocks == (8, 128)
    assert plan.scratch[0] == (2, 64, 4, 16)
    if dtype == torch.float32:
        plan = flash_ops.flash_bwd_plan(4, 32, 32, 2048, 80, dtype)
        assert plan.route == "cuda_cores"
        plan = ssd_ops.ssd_bwd_plan(4, 2048, 80, 128, 64, 1, 64, dtype)
        assert plan.route == "cuda_cores"
        assert max(plan.smem_bytes) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if get(a).ssm is not None])
def test_registered_conv_backward_plans(arch, dtype):
    """Every registered Mamba-2 and Mamba-1 config's conv1d backward at
    B=4, S=2048: the widest vector of at most 8 bytes that divides its
    channels (xBC for Mamba-2, d_inner for Mamba-1), 16 rows a thread, 8
    warps a block, one partial a block, and the partials a small share
    (at most 5%) of the x, dy and dx the kernel streams."""
    cfg = get(arch)
    s = cfg.ssm
    c = s.d_inner(cfg.d_model)
    if s.variant != "mamba1":
        c += 2 * s.n_groups * s.d_state
    k = s.conv_kernel
    assert 2 <= k <= conv_ops.MAX_K, arch
    plan = conv_ops.conv1d_bwd_plan(4, 2048, c, k, dtype)
    es = torch.empty((), dtype=dtype).element_size()
    want = 8 // es
    while c % want:
        want //= 2
    assert plan.vec == want, (arch, c)
    assert (plan.rows, plan.row_groups) == (16, 8)
    tiles = 2048 // (16 * 8)
    assert plan.grid == (-(-c // (32 * plan.vec)), tiles, 4)
    assert plan.partials == (4 * tiles, c, k + 1)
    stream = 3 * 4 * 2048 * c * es
    assert 4 * math.prod(plan.partials) <= 0.05 * stream, arch


@pytest.mark.parametrize("c,dtype,align,vec", [
    (5248, torch.bfloat16, 16, 4), (52, torch.bfloat16, 16, 4),
    (50, torch.bfloat16, 16, 2), (49, torch.bfloat16, 16, 1),
    (5248, torch.bfloat16, 4, 2), (5248, torch.float32, 16, 2),
    (49, torch.float32, 16, 1), (5248, torch.float32, 4, 1)])
def test_conv_backward_plan_narrows(c, dtype, align, vec):
    """The vector narrows where the channels or an address (``align``
    bytes) do not allow the full width; S=100 is one row tile."""
    plan = conv_ops.conv1d_bwd_plan(2, 100, c, 4, dtype, align=align)
    assert plan.vec == vec
    assert plan.grid == (-(-c // (32 * vec)), 1, 2)
    assert plan.partials == (2, c, 5)


@pytest.mark.parametrize("h,g,hs", [(80, 1, 8), (4, 1, 4), (32, 2, 8),
                                    (24, 1, 8), (12, 2, 6), (14, 1, 7),
                                    (10, 10, 1)])
def test_ssd_backward_slices(h, g, hs):
    """The heads of a tensor-core backward block: the most, up to 8, that
    divide a group's heads."""
    assert ssd_ops.slice_heads(h, g) == hs


@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if get(a).ssm is not None
                                  and get(a).ssm.variant == "mamba1"])
def test_registered_mamba1_shapes_are_built(arch):
    """Every Mamba-1 config the port registers fits the decode step's
    instances and limits: d_state, the projection width, and d_inner
    within a cluster of 8 blocks."""
    cfg = get(arch)
    s = cfg.ssm
    di, r = s.d_inner(cfg.d_model), m1.dt_rank(cfg.d_model, s)
    assert s.d_state in dec_ops.M1_D_STATES, arch
    assert r + 2 * s.d_state <= dec_ops.M1_MAX_PROJ, arch
    dec_ops.m1_check_width(di)


@pytest.mark.parametrize("di,fits", [(1536, True), (1000, True),
                                     (128, True), (2048, True),
                                     (2049, False)])
def test_mamba1_cluster_tiles(di, fits):
    """A cluster of 8 blocks of at most 256 channels, one thread each,
    takes up to 2048 channels; past that the wrapper raises, it does not
    fall back."""
    if fits:
        dec_ops.m1_check_width(di)
    else:
        with pytest.raises(ValueError, match="cluster of more than 8"):
            dec_ops.m1_check_width(di)
