"""The port sharded over two gloo ranks on the CPU, in fp32 at reduced size.

One spawn of two ranks (``torch_dist_worker.run``, one thread each) under
a timeout of 150 s (about 30 s alone, 45 s with the JAX references), whose
checks run on a (data, model) = (1, 2) mesh and on a (2, 1) mesh over the
same ranks; every sharded call runs through DTensors with the kernels'
plain versions on the shards.  The JAX references run here, unsharded,
on the same weights (``convert.from_jax``):

* a dense model with one KV head (so ``kv_repeat`` = 2 on the model
  axis): ``lm_forward`` logits within 1e-4 of the reference's;
* gemma3-1b reduced with three query heads (seq mode on the model axis):
  logits against the reference;
* qwen3-moe reduced on (2, 1), whose plan has ``moe_groups`` = 2:
  logits against the reference's ``lm_forward(..., moe_groups=2)``;
* zamba2 (hybrid, one unit of its layer pattern) on (1, 2): two prefill
  chunks (the second ragged) and an 8-token ``decode_tokens``, greedy
  tokens equal to the port's with no plan;
* one ZeRO-1 train step at llama4-maverick reduced to one unit (a
  dense and a MoE layer), ``fsdp`` on (2, 1): loss and gradient norm
  within rtol 1e-5 of the step with no plan; the first moment ``m``
  (0.1 x the gradient) of every leaf within rtol 1e-5 of the leaf's
  largest |m|; the updated params within rtol 1e-5 and an absolute 5% of
  the learning rate (AdamW's first step moves each param by about
  lr * g / (|g| + eps), so a gradient that cancels to near zero, whose
  summation order differs across ranks, may move its param by a
  different fraction of lr); ``m`` and ``v`` of the local shapes
  ``zero1_rules`` gives;
* ``ServingEngine(plan=)`` on (1, 2) (each rank one replica) serves the
  streams of ``plan=None``; ``Trainer(plan=)`` on (2, 1), one step of
  reduced mamba2-2.7b, against the plan-less trainer's loss (rtol 1e-5)
  and params (as the ZeRO-1 step);
* elastic restore: a checkpoint saved from DTensors on (1, 2) restores
  onto (2, 1) bit for bit, as ``tests/test_elastic_reshard.py`` holds the
  reference;
* the sharded decode step on (1, 2), reduced to one unit at max_seq 32:
  a 12-token prefill chunk (row 1 ragged at 7) and an 8-token
  ``decode_tokens`` burst under a decode plan give the plan-less greedy
  streams, and one more step's logits within 1e-4.  What each rank's
  decode kernel receives during the burst shows that no cache moved: a
  dense model with one KV head (``kv_seq`` on the model axis) and
  gemma3-1b (its 8-slot rings and 32-row global cache) attend through
  the partials mode over half their rows (row 1 never reaches the second
  rank's rows: a rank with no live key); mamba2-2.7b's step runs on half
  its heads, mamba-130m's two launches on half its channels;
* one stream on four ranks, a (2, 2) mesh (a second spawn, ≈ 9 s):
  reduced gemma3-1b in seq mode, its cache rows over ``("data",
  "model")``, a quarter a rank; 9 teacher-forced ``lm_decode_step``s
  from an unsharded prefill, logits within 1e-4 of the plan-less steps.
  The prefill and ``decode_tokens`` themselves fail under that plan, in
  code the decode step does not reach (ROADMAP §3).
"""
import dataclasses
import socket
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_worker
from repro.configs import gemma3_1b as J_GEMMA
from repro.configs import llama3_8b as J_LLAMA
from repro.configs import qwen3_moe_235b as J_QWEN
from repro.configs import reduced as j_reduced
from repro.models import lm as jlm

TOL = 1e-4


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(specs, out_dir, timeout, body=torch_dist_worker.run, ranks=2):
    """``ranks`` ranks of ``body`` (``torch_dist_worker.run`` with
    ``specs``); raises on a rank's error or past ``timeout`` seconds (the
    ranks are killed)."""
    args = (ranks, _port()) + ((specs,) if specs is not None else ()) + (
        str(out_dir),)
    ctx = mp.start_processes(body, args=args, nprocs=ranks, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=0.5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the ranks ran past {timeout} s")
    return torch.load(out_dir / "out.pt", weights_only=False)


def _reference(jcfg, arch, attn=None, moe_groups=1):
    """The reference's unsharded logits and its params as numpy, for the
    port's reduced ``arch`` with ``attn`` replaced alike on both sides."""
    jcfg = dataclasses.replace(j_reduced(jcfg), compute_dtype="float32")
    if attn:
        jcfg = dataclasses.replace(jcfg, attn=dataclasses.replace(
            jcfg.attn, **attn))
    jp = jlm.init_lm_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    logits = jax.jit(lambda p, t: jlm.lm_forward(
        jcfg, p, {"tokens": t}, moe_groups=moe_groups, train=False))(
        jp, tokens)
    spec = {"arch": arch, "params": jax.tree_util.tree_map(np.asarray, jp),
            "tokens": tokens}
    if attn:
        spec["attn"] = attn
    return spec, np.asarray(logits, np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    dense, dense_ref = _reference(J_LLAMA, "llama3_8b", {"n_kv_heads": 1})
    seq, seq_ref = _reference(J_GEMMA, "gemma3_1b", {"n_heads": 3})
    moe, moe_ref = _reference(J_QWEN, "qwen3_moe_235b", moe_groups=2)
    out = _spawn({"1x2": {"dense": dense, "seq": seq}, "2x1": {"moe": moe}},
                 tmp_path_factory.mktemp("ranks"), timeout=150)
    out["ref"] = {"dense": dense_ref, "seq": seq_ref, "moe": moe_ref}
    return out


@pytest.fixture(scope="module")
def runs4(tmp_path_factory):
    return _spawn(None, tmp_path_factory.mktemp("ranks4"), timeout=120,
                  body=torch_dist_worker.run4, ranks=4)


def test_dense_kv_repeat_logits_match_reference(runs):
    got = runs["1x2"]["dense"]
    assert (got["attn_mode"], got["kv_repeat"]) == ("head", 2)
    np.testing.assert_allclose(got["logits"], runs["ref"]["dense"],
                               rtol=TOL, atol=TOL)


def test_seq_mode_logits_match_reference(runs):
    got = runs["1x2"]["seq"]
    assert got["attn_mode"] == "seq"
    np.testing.assert_allclose(got["logits"], runs["ref"]["seq"],
                               rtol=TOL, atol=TOL)


def test_moe_groups_logits_match_reference(runs):
    got = runs["2x1"]["moe"]
    assert got["moe_groups"] == 2
    np.testing.assert_allclose(got["logits"], runs["ref"]["moe"],
                               rtol=TOL, atol=TOL)


def test_hybrid_chunked_prefill_and_burst_match_unsharded(runs):
    got = runs["1x2"]["hybrid"]
    np.testing.assert_allclose(got["logits"], got["logits_want"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got["tokens"], got["want"])


def test_zero1_train_step_matches_unsharded(runs):
    got = runs["2x1"]["train"]
    assert got["fsdp"] == "data" and any("FSDP" in n for n in got["notes"])
    np.testing.assert_allclose(got["loss"], got["loss_want"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], got["grad_norm_want"],
                               rtol=1e-5)
    for a, b in zip(got["m"], got["m_want"]):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(b).max()))
    for a, b in zip(got["params"], got["params_want"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0.05 * got["lr"])
    assert got["m_local"] == got["zero1_local"] == got["v_local"]
    # ZeRO-1 splits the embed dim over data: some moments are halved
    assert any(m != z for m, z in zip(got["m_local"], [
        tuple(p.shape) for p in got["params_want"]]))


def test_elastic_restore_onto_another_mesh(runs):
    got = runs["1x2"]["elastic"]
    assert got["mesh"] == (2, 1)
    assert got["placements"] == ("Shard(dim=0)", "Replicate()")
    assert got["local"] == (8, 64)
    np.testing.assert_array_equal(got["w"], got["w_want"])
    assert got["step"] == 7


def test_engine_under_a_plan_serves_the_plan_less_streams(runs):
    got = runs["1x2"]["engine"]
    assert got["streams"] == got["want"]
    assert all(status == "ok" for status, _ in got["streams"])


@pytest.mark.parametrize("name", ["dense", "ring", "mamba2", "mamba1"])
def test_sharded_decode_burst_keeps_the_cache_in_place(runs, name):
    got = runs["1x2"][f"decode_{name}"]
    np.testing.assert_array_equal(got["tokens"], got["want"])
    np.testing.assert_allclose(got["logits"], got["logits_want"],
                               rtol=TOL, atol=TOL)
    # reduced configs at max_seq 32: mamba2-2.7b 8 heads of 16 and a
    # conv_dim of 160, mamba-130m 128 channels of d_state 16
    kv, rows = got["kv_heads"], 32 // 2
    if name in ("dense", "ring"):
        assert got["kv_seq"] == "model"
        extents = (rows,) if name == "dense" else (rows, got["window"] // 2)
        want = {("decode_attention_partials_ref",
                 ((2, 4, 16), (2, kv, r, 16), (2, kv, r, 16)))
                for r in extents}
    elif name == "mamba2":
        want = {("mamba2_decode_heads_ref",
                 ((2, 3, 160), (2, 4, 16, 16), (2, 160), (160, 4), (160,),
                  (2, 4), (4,), (4,), (4,)))}
    else:
        want = {("mamba1_decode_conv_proj_ref",
                 ((2, 3, 64), (2, 64), (64, 4), (64,), (64, 36))),
                ("mamba1_decode_state_ref",
                 ((2, 64, 16), (2, 64), (2, 36), (4, 64), (64,), (64, 16),
                  (64,)))}
    for rank in got["calls"]:
        assert {(n, tuple(map(tuple, shapes))) for n, shapes in rank} == want


def test_trainer_under_a_plan_matches_the_plan_less_trainer(runs):
    got = runs["2x1"]["trainer"]
    np.testing.assert_allclose(got["losses"], got["losses_want"], rtol=1e-5)
    for a, b in zip(got["params"], got["params_want"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0.05 * got["lr"])


def test_single_stream_decode_over_two_mesh_dims(runs4):
    """Four ranks, (2, 2): one stream's cache rows split over data and
    model, the partials merged over both mesh dims."""
    got = runs4
    assert got["attn_mode"] == "seq" and got["kv_seq"] == ("data", "model")
    for a, b in zip(got["logits"], got["logits_want"]):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    # the 8-slot rings and the 32-row global cache, a quarter a rank
    want = {("decode_attention_partials_ref",
             ((1, 3, 16), (1, 1, r, 16), (1, 1, r, 16))) for r in (2, 8)}
    for rank in got["calls"]:
        assert {(n, tuple(map(tuple, shapes))) for n, shapes in rank} == want
