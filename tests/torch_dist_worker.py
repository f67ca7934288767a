"""Rank bodies of ``test_torch_distributed.py`` (imports torch and the
port only, so a spawned rank never loads JAX).

Each rank joins a gloo process group, builds its meshes, runs its
checks' sharded calls and the unsharded ones they are held against, and
rank 0 saves what the test compares with ``torch.save``.
"""
import contextlib
import dataclasses
import os
import time
import warnings
from unittest import mock

import torch
import torch.distributed as dist


def _cfg(name, n_units=2, vocab=256, **attn):
    import repro_torch.configs as C
    from repro_torch.configs import reduced
    cfg = dataclasses.replace(reduced(getattr(C, name), n_units=n_units,
                                      vocab=vocab),
                              compute_dtype="float32")
    if attn:
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn,
                                                                **attn))
    return cfg


def _placed(cfg, plan, params, tokens):
    from repro_torch.distributed.sharding import distribute_tree, place
    from repro_torch.launch.steps import input_shardings, param_shardings
    return (distribute_tree(params, param_shardings(cfg, plan)),
            place(tokens, input_shardings(cfg, {"tokens": tokens},
                                          plan)["tokens"]))


def _plan(cfg, mesh, batch, seq, kind="prefill"):
    from repro_torch.core.config import WorkloadConfig
    from repro_torch.distributed.sharding import plan_sharding
    return plan_sharding(cfg, WorkloadConfig("t", kind, seq_len=seq,
                                             global_batch=batch), mesh)


def _forward(spec, mesh):
    """A sharded ``lm_forward``'s global logits, and its plan's knobs."""
    from repro_torch.convert import from_jax
    from repro_torch.distributed.sharding import model_kwargs
    from repro_torch.models.lm import lm_forward
    cfg = _cfg(spec["arch"], **spec.get("attn", {}))
    params = from_jax(spec["params"], "cpu")
    tokens = torch.from_numpy(spec["tokens"])
    plan = _plan(cfg, mesh, *tokens.shape)
    dp, dt = _placed(cfg, plan, params, tokens)
    with plan.activations():
        out = lm_forward(cfg, dp, dt, train=False, **model_kwargs(plan))
    return {"logits": out.full_tensor().numpy(), "attn_mode": plan.attn_mode,
            "kv_repeat": plan.kv_repeat, "moe_groups": plan.moe_groups}


def _hybrid(mesh):
    """zamba2-style chunked prefill (two chunks) and an 8-token burst,
    sharded and with no plan, from the same params."""
    from repro_torch.distributed.sharding import (distribute_tree,
                                                  model_kwargs)
    from repro_torch.launch.steps import cache_shardings
    from repro_torch.models.lm import (decode_tokens, init_lm_cache,
                                       init_lm_params, lm_prefill_chunk)
    cfg = _cfg("zamba2_2p7b", n_units=1)
    params = init_lm_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    lengths = torch.tensor([8, 5], dtype=torch.int32)

    def run(p, tok, cache, kw):
        _, cache = lm_prefill_chunk(cfg, p, tok[:, :8], cache, **kw)
        lg, cache = lm_prefill_chunk(cfg, p, tok[:, 8:], cache,
                                     lengths=lengths, **kw)
        first = torch.argmax(lg[:, -1, :cfg.vocab_size], -1).to(
            torch.int32)[:, None]
        out, _ = decode_tokens(cfg, p, cache, first, 8, **kw)
        return lg, out

    lg0, want = run(params, tokens, init_lm_cache(
        cfg, 2, 32, dtype=torch.float32, device="cpu"), {})
    plan = _plan(cfg, mesh, 2, 16)
    dp, dt = _placed(cfg, plan, params, tokens)
    cache = init_lm_cache(cfg, 2, 32, dtype=torch.float32, device="cpu")
    dc = distribute_tree(cache, cache_shardings(cache, plan))
    with plan.activations():
        lg, got = run(dp, dt, dc, model_kwargs(plan))
    return {"tokens": got.full_tensor().numpy(), "want": want.numpy(),
            "logits": lg.full_tensor().numpy(), "logits_want": lg0.numpy()}


# the plain versions the decode kernels run on the CPU: (module, name)
DECODE_FNS = (("attn_decode", "decode_attention_ref"),
              ("attn_decode", "decode_attention_partials_ref"),
              ("decode_fused", "mamba2_decode_fused_ref"),
              ("decode_fused", "mamba2_decode_heads_ref"),
              ("decode_fused", "mamba1_decode_fused_ref"),
              ("decode_fused", "mamba1_decode_conv_proj_ref"),
              ("decode_fused", "mamba1_decode_state_ref"))


@contextlib.contextmanager
def _recording(calls):
    """Each decode kernel's plain version records its name and the shapes
    of its tensor arguments (what the kernel receives on this rank)."""
    import importlib
    with contextlib.ExitStack() as stack:
        for mod, name in DECODE_FNS:
            m = importlib.import_module(f"repro_torch.kernels.{mod}.ref")
            real = getattr(m, name)

            def rec(*a, _real=real, _name=name, **kw):
                calls.add((_name, tuple(tuple(t.shape) for t in a
                                        if isinstance(t, torch.Tensor))))
                return _real(*a, **kw)
            stack.enter_context(mock.patch.object(m, name, rec))
        yield


def _sharded_decode(mesh, arch, attn=None):
    """A 12-token prefill chunk (row 1 ragged at 7) and an 8-token
    ``decode_tokens`` burst of reduced ``arch`` (one unit, max_seq 32)
    under a decode plan, against the same calls with no plan; then one
    more ``lm_decode_step``'s logits.  Records, on every rank, what the
    decode kernels' plain versions receive during the sharded burst."""
    from repro_torch.distributed.sharding import (distribute_tree,
                                                  model_kwargs)
    from repro_torch.launch.steps import cache_shardings
    from repro_torch.models.lm import (decode_tokens, init_lm_cache,
                                       init_lm_params, lm_decode_step,
                                       lm_prefill_chunk)
    cfg = _cfg(arch, n_units=1, **(attn or {}))
    params = init_lm_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    lengths = torch.tensor([12, 7], dtype=torch.int32)
    calls = set()

    def run(p, tok, cache, kw, record=False):
        lg, cache = lm_prefill_chunk(cfg, p, tok, cache, lengths=lengths,
                                     **kw)
        first = torch.argmax(lg[:, -1, :cfg.vocab_size], -1).to(
            torch.int32)[:, None]
        with _recording(calls) if record else contextlib.nullcontext():
            out, cache = decode_tokens(cfg, p, cache, first, 8, **kw)
        lg, _ = lm_decode_step(cfg, p, out[:, -1:], cache, **kw)
        return out, lg

    want, lg0 = run(params, tokens, init_lm_cache(
        cfg, 2, 32, dtype=torch.float32, device="cpu"), {})
    plan = _plan(cfg, mesh, 2, 32, kind="decode")
    dp, dt = _placed(cfg, plan, params, tokens)
    cache = init_lm_cache(cfg, 2, 32, dtype=torch.float32, device="cpu")
    dc = distribute_tree(cache, cache_shardings(cache, plan))
    with plan.activations():
        got, lg = run(dp, dt, dc, model_kwargs(plan), record=True)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, sorted(calls))
    a = cfg.attn
    return {"tokens": got.full_tensor().numpy(), "want": want.numpy(),
            "logits": lg.full_tensor().numpy(), "logits_want": lg0.numpy(),
            "calls": every, "kv_seq": plan.act_rules["kv_seq"],
            "kv_heads": None if a is None else a.n_kv_heads * plan.kv_repeat,
            "window": None if a is None else a.sliding_window}


def _single_stream_decode(mesh):
    """One stream of reduced gemma3-1b (3 query heads: seq mode, so its
    caches' rows split over ``("data", "model")``): a 12-token prefill with
    no plan, its cache placed by a decode plan, then 9 teacher-forced
    ``lm_decode_step``s under the plan against the same steps with none;
    records what the decode kernels receive on every rank."""
    from repro_torch.distributed.sharding import (distribute_tree,
                                                  model_kwargs)
    from repro_torch.launch.steps import cache_shardings
    from repro_torch.models.lm import (init_lm_cache, init_lm_params,
                                       lm_decode_step, lm_prefill_chunk)
    from repro_torch.models.params import tree_map
    cfg = _cfg("gemma3_1b", n_units=1, n_heads=3)
    params = init_lm_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, 12), generator=g)
    steps = torch.randint(0, cfg.vocab_size, (1, 9), generator=g)
    _, cache = lm_prefill_chunk(cfg, params, tokens, init_lm_cache(
        cfg, 1, 32, dtype=torch.float32, device="cpu"))
    plan = _plan(cfg, mesh, 1, 32, kind="decode")
    dp, _ = _placed(cfg, plan, params, tokens)
    dc = distribute_tree(tree_map(torch.clone, cache),
                         cache_shardings(cache, plan))
    want, got, calls = [], [], set()
    for i in range(steps.shape[1]):
        lg, cache = lm_decode_step(cfg, params, steps[:, i:i + 1], cache)
        want.append(lg.numpy())
    with plan.activations(), _recording(calls):
        for i in range(steps.shape[1]):
            lg, dc = lm_decode_step(cfg, dp, steps[:, i:i + 1], dc,
                                    **model_kwargs(plan))
            got.append(lg.full_tensor().numpy())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, sorted(calls))
    return {"logits": got, "logits_want": want, "calls": every,
            "kv_seq": plan.act_rules["kv_seq"], "attn_mode": plan.attn_mode}


def _train(mesh):
    """One ZeRO-1 train step at llama4 reduced (fsdp) against the step
    with no plan.  The MoE's capacity is made drop-free, so the plan's
    dispatch groups (two here) and the plan-less one group route every
    token alike and both steps compute the same function.  A vocab of 250
    (padded to 256) puts the head's pad mask behind the rematerialised
    layers."""
    from repro_torch.distributed.sharding import (distribute_tree, place,
                                                  zero1_rules)
    from repro_torch.launch.steps import input_shardings, param_shardings
    from repro_torch.models.lm import init_lm_params
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    cfg = _cfg("llama4_maverick", n_units=1, vocab=250)
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    plan = _plan(cfg, mesh, 2, 16, kind="train")
    opt = OptConfig(warmup_steps=1, grad_dtype="float32")
    params = init_lm_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=g)}
    p0 = tree_map(torch.clone, params)
    p1, o1, m1 = make_train_step(cfg, opt)(p0, init_opt_state(p0, opt),
                                           batch)
    psh = param_shardings(cfg, plan)
    zsh = param_shardings(cfg, plan, zero1_rules(plan))
    dp = distribute_tree(tree_map(torch.clone, params), psh)
    do = init_opt_state(dp, opt, shardings=zsh)
    shs = input_shardings(cfg, batch, plan)
    db = {k: place(v, shs[k]) for k, v in batch.items()}
    q1, r1, n1 = make_train_step(cfg, opt, plan)(dp, do, db)
    zero1 = zero1_rules(plan)
    from repro_torch.models.lm import model_param_defs
    defs = tree_leaves(model_param_defs(cfg))
    return {"loss": float(n1["loss"]), "loss_want": float(m1["loss"]),
            "grad_norm": float(n1["grad_norm"]),
            "grad_norm_want": float(m1["grad_norm"]),
            "params": [t.full_tensor().numpy() for t in tree_leaves(q1)],
            "params_want": [t.numpy() for t in tree_leaves(p1)],
            "m": [t.full_tensor().numpy() for t in tree_leaves(r1["m"])],
            "m_want": [t.numpy() for t in tree_leaves(o1["m"])],
            "lr": float(n1["lr"]),
            "m_local": [tuple(t.to_local().shape)
                        for t in tree_leaves(r1["m"])],
            "v_local": [tuple(t.to_local().shape)
                        for t in tree_leaves(r1["v"])],
            "zero1_local": [zero1.local_shape(d.axes, d.shape)
                            for d in defs],
            "fsdp": plan.param_rules["embed"], "notes": plan.notes}


def _engine(mesh):
    """``ServingEngine(plan=)``: every rank serves its own replica (the
    reference's engine is one replica too), streams as with no plan."""
    import numpy as np
    from repro_torch.models.lm import init_lm_params
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = _cfg("zamba2_2p7b", n_units=1)
    params = init_lm_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    out = []
    for plan in (None, _plan(cfg, mesh, 2, 64, kind="decode")):
        rng = np.random.default_rng(0)
        eng = ServingEngine(cfg, params, slots=2, max_seq=64, chunk_size=16,
                            decode_block=4, plan=plan, device="cpu")
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n),
                        max_new=6) for i, n in enumerate((20, 37))]
        for r in reqs:
            eng.submit(r)
        eng.run()
        out.append([(r.status, [int(t) for t in r.out]) for r in reqs])
    return {"streams": out[1], "want": out[0]}


def _trainer(mesh):
    """One ``Trainer(plan=)`` step of mamba2 (reduced), params placed by
    the plan and moments by ``zero1_rules``, against the plan-less
    trainer's."""
    from repro_torch.configs import mamba2_2p7b
    from repro_torch.configs import reduced
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(reduced(mamba2_2p7b, n_units=1),
                              compute_dtype="float32")
    tc = TrainerConfig(steps=1, ckpt_every=0, log_every=100)
    opt = OptConfig(warmup_steps=1, grad_dtype="float32")
    a = Trainer(cfg, opt, tc, seq_len=32, global_batch=2, device="cpu")
    la = a.run(log=lambda line: None).losses
    b = Trainer(cfg, opt, tc, plan=_plan(cfg, mesh, 2, 32, kind="train"),
                seq_len=32, global_batch=2, device="cpu")
    lb = b.run(log=lambda line: None).losses
    return {"losses": lb, "losses_want": la,
            "params": [t.full_tensor().numpy() for t in tree_leaves(b.params)],
            "params_want": [t.numpy() for t in tree_leaves(a.params)],
            "lr": opt.lr}


def _elastic(ckpt_dir, mesh_a, mesh_b):
    """A tree saved from DTensors on ``mesh_a`` (last dim over model)
    restored onto ``mesh_b`` with another layout."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.checkpoint.ckpt import restore, save
    from repro_torch.distributed.sharding import Sharding, place
    w = torch.arange(16 * 64, dtype=torch.float32).reshape(16, 64)
    wa = place(w, Sharding(mesh_a, (Replicate(), Shard(1))))
    tree = {"w": wa, "step": torch.tensor(7, dtype=torch.int32)}
    save(ckpt_dir, 7, tree)
    shard_b = {"w": Sharding(mesh_b, (Shard(0), Replicate())), "step": None}
    out = restore(ckpt_dir, tree, shardings=shard_b)
    return {"placements": tuple(repr(p) for p in out["w"].placements),
            "mesh": tuple(out["w"].device_mesh.shape),
            "local": tuple(out["w"].to_local().shape),
            "w": out["w"].full_tensor().numpy(), "w_want": w.numpy(),
            "step": int(out["step"])}


def run(rank, world, port, specs, out_dir):
    """One rank of a two-rank gloo group: the checks on a (1, 2) mesh and
    on a (2, 1) mesh over the same ranks.  ``specs`` maps each mesh's name
    to its forward checks' inputs."""
    warnings.filterwarnings("ignore")
    # one thread a rank: the test runs beside other test workers
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        from repro_torch.launch.mesh import make_device_mesh
        meshes = {"1x2": make_device_mesh((1, 2), ("data", "model"), "cpu"),
                  "2x1": make_device_mesh((2, 1), ("data", "model"), "cpu")}
        res, secs = {"1x2": {}, "2x1": {}}, {}

        def timed(mesh, name, fn, *args):
            t0 = time.perf_counter()
            res[mesh][name] = fn(*args)
            secs[f"{mesh}/{name}"] = time.perf_counter() - t0
        for mesh, checks in specs.items():
            for name, spec in checks.items():
                timed(mesh, name, _forward, spec, meshes[mesh])
        timed("1x2", "hybrid", _hybrid, meshes["1x2"])
        for name, arch, attn in (
                ("decode_dense", "llama3_8b", {"n_kv_heads": 1}),
                ("decode_ring", "gemma3_1b", None),
                ("decode_mamba2", "mamba2_2p7b", None),
                ("decode_mamba1", "mamba_130m", None)):
            timed("1x2", name, _sharded_decode, meshes["1x2"], arch, attn)
        timed("2x1", "train", _train, meshes["2x1"])
        timed("1x2", "engine", _engine, meshes["1x2"])
        timed("2x1", "trainer", _trainer, meshes["2x1"])
        timed("1x2", "elastic", _elastic, os.path.join(out_dir, "ckpt"),
              meshes["1x2"], meshes["2x1"])
        res["seconds"] = secs
        if rank == 0:
            torch.save(res, os.path.join(out_dir, "out.pt"))
    finally:
        dist.destroy_process_group()


def run4(rank, world, port, out_dir):
    """One rank of a four-rank gloo group: the single-stream decode on a
    (2, 2) mesh."""
    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        from repro_torch.launch.mesh import make_device_mesh
        mesh = make_device_mesh((2, 2), ("data", "model"), "cpu")
        res = _single_stream_decode(mesh)
        if rank == 0:
            torch.save(res, os.path.join(out_dir, "out.pt"))
    finally:
        dist.destroy_process_group()
