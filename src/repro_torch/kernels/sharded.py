"""The kernels under a sharding plan: each wrapper's DTensor path.

A hand-written kernel sees local tensors only.  When a wrapper
(``flash_attention``, ``decode_attention``, ``causal_conv1d``,
``selective_scan``, ``ssd_chunked``, ``mamba2_decode_fused``,
``mamba1_decode_fused``) is given a DTensor, it calls the function of
the same name here with itself as ``fn``.  That function takes the
active plan (:func:`repro_torch.distributed.sharding.active_plan`; a
DTensor outside a plan raises), redistributes each input to the
placements in which the kernel's work is independent, runs ``fn`` on
the local shards (the kernel on the card, its plain version on the CPU,
the same path either way) and wraps each result back as a DTensor.
Redistribution, ``to_local`` and ``from_local`` are differentiable, so
a backward ``autograd.Function`` works on the local tensors as it does
unsharded.  An input whole on a mesh dim that splits the kernel's work
(a conv weight beside a batch split, K/V beside a split of the query
rows) gets each rank's part of its gradient: its ``to_local`` hands the
gradient back as ``Partial`` there, so the parts are summed.  A shard shape the kernel refuses raises from the kernel, as
it would unsharded.

Independent placements, by kernel:

* SSD: batch and ``ssm_heads`` (B/C's groups follow the heads where
  there are several; heads whose groups do not split stay whole).
* conv1d and the selective scan: batch and ``conv_dim`` channels.
* Flash attention in head mode and decode attention: batch and
  ``kv_heads`` (after ``kv_repeat``); the query heads follow.  A query
  head split that its KV heads do not share is undone (both whole).
* Flash attention in seq mode (``seq`` sharded, as the plan's
  ``attn_mode == "seq"`` gives it): K/V are gathered and each rank runs
  its own query rows through the kernel's per-row ``q_offset`` mode, its
  first row's position added to the offset.  The ring layout keeps every
  query row on every rank.

The decode steps keep the cache where the plan placed it; no token step
moves a K/V cache or an SSM state:

* Decode attention over a ``kv_seq``-sharded cache (the plan shards the
  rows where the KV heads do not divide the model axis, and over
  ``("data", "model")`` for a single stream): q is gathered over the
  ``kv_seq`` mesh dims, each rank runs the kernel's partials mode over
  its own rows (its live keys ``clamp(valid_len - first_row, 0,
  rows)``), the partials (acc, m, l) go to the ranks that own each
  output head (one all-to-all, or an all-gather where the output keeps
  its heads whole), and they merge in fp32 as the kernel merges its
  splits (``attn_decode.ref.merge_partials``).  A ring cache's slots are
  rows like any other: the merge does not depend on their order.
* The Mamba-2 step on ``ssm_heads``: the state stays on its heads; the
  window and the token, a few rows of ``conv_dim``, are gathered, the
  kernel's head-slice mode updates the rank's heads, and each rank keeps
  its even ``conv_dim`` shard of the shifted window.  Heads that do not
  split, or several groups that do not split with them (as SSD's rule),
  take the batch-only step.
* The Mamba-1 step on ``conv_dim``: two launches around one all-reduce
  of the rank's fp32 share of the x_proj product (the conv step, then
  dt_proj and the state update on the rank's channels).  Channels that
  do not split take the batch-only step.
* Otherwise the decode steps split the batch only.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import (active_plan, local_shard,
                                              shard_offsets,
                                              wrap_local as _wrap)
from repro_torch.kernels.attn_decode.ref import merge_partials


def _plan():
    plan = active_plan()
    if plan is None:
        raise ValueError("a DTensor reached a kernel outside a plan's "
                         "activations(): no placements to run it in")
    return plan


def _mesh(*ts):
    for t in ts:
        if isinstance(t, DTensor):
            return t.device_mesh
    raise ValueError("no DTensor among the kernel's inputs")


def _pl(plan, axes, shape):
    return list(plan.placements(axes, shape, activation=True))


def _split(*placements) -> set:
    """The mesh dims on which any of these placements splits a tensor: the
    dims that split the kernel's work."""
    return {i for pls in placements for i, pl in enumerate(pls)
            if isinstance(pl, Shard)}


def _local(t, mesh, placements, split=frozenset()):
    """``t``'s shard under ``placements``: a DTensor is redistributed, a
    plain tensor (the same on every rank) cut; None stays None.  On the
    mesh dims in ``split`` (the work's splits) where ``t`` is whole, its
    gradient comes back as each rank's partial sum."""
    if t is None:
        return None
    placements = tuple(placements)
    if isinstance(t, DTensor):
        if tuple(t.placements) != placements:
            t = t.redistribute(mesh, placements)
        grad = tuple(Partial() if i in split and isinstance(pl, Replicate)
                     else pl for i, pl in enumerate(placements))
        return t.to_local(grad_placements=grad)
    if not isinstance(t, torch.Tensor) or t.dim() == 0:
        return t
    return local_shard(t, mesh, placements)


def _batch_only(placements, keep_dims: Sequence[int] = (0,)):
    """``placements`` with every shard of a dim outside ``keep_dims``
    replaced by ``Replicate``."""
    return [pl if isinstance(pl, Shard) and pl.dim in keep_dims
            else Replicate() for pl in placements]


def _row_vector(x, mesh, batch_pl):
    """A [B] per-row argument's shard (a scalar or None as it is)."""
    if x is None or not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    return _local(x, mesh, [pl if isinstance(pl, Shard) and pl.dim == 0
                            else Replicate() for pl in batch_pl])


def _align_heads(qp, kp, qdim: int, kdim: int):
    """Undo a query-head split its KV heads do not share (and the
    reverse), so each rank's query heads map onto its own KV heads."""
    for i, (a, b) in enumerate(zip(qp, kp)):
        qh = isinstance(a, Shard) and a.dim == qdim
        kh = isinstance(b, Shard) and b.dim == kdim
        if qh != kh:
            if qh:
                qp[i] = Replicate()
            if kh:
                kp[i] = Replicate()


def flash_attention(fn, q, k, v, *, causal, window, q_offset, kv_wrap,
                    ring_len):
    plan = _plan()
    mesh = _mesh(q, k, v)
    ring = kv_wrap is not None or ring_len is not None
    qp = _pl(plan, ("batch", "heads", None if ring else "seq", None), q.shape)
    kp = _pl(plan, ("batch", "kv_heads", None, None), k.shape)
    _align_heads(qp, kp, 1, 1)
    # batch splits must agree (the same rule on the same B)
    bq = _batch_only(qp)
    seq_split = any(isinstance(pl, Shard) and pl.dim == 2 for pl in qp)
    work = _split(qp)
    ql = _local(q, mesh, qp)
    kl, vl = _local(k, mesh, kp, work), _local(v, mesh, kp, work)
    off = _row_vector(q_offset, mesh, bq)
    if seq_split:
        # this rank's first query row, added to each row's offset (a
        # device vector: the kernel reads per-row offsets)
        _, first = shard_offsets(mesh, qp, q.shape)
        rows = torch.full((ql.shape[0],), first[2], dtype=torch.int32,
                          device=ql.device)
        off = rows if off is None else rows + off
    o = fn(ql, kl, vl, causal=causal, window=window, q_offset=off,
           kv_wrap=_row_vector(kv_wrap, mesh, bq), ring_len=ring_len)
    return _wrap(o, mesh, qp, q.shape)


def decode_attention(fn, q, k, v, *, valid_len, split_k, partials):
    plan = _plan()
    mesh = _mesh(q, k, v)
    b, kvh, s, d = k.shape
    # the cache's placements, resolved in its own [B, S, KV, d] order
    # (kv_seq takes the model axis before kv_heads), then on k's dims
    to_k = {0: 0, 1: 2, 2: 1}
    kp = [Shard(to_k[pl.dim]) if isinstance(pl, Shard) else pl
          for pl in _pl(plan, ("batch", "kv_seq", "kv_heads", None),
                        (b, s, kvh, d))]
    seq = [i for i, pl in enumerate(kp) if isinstance(pl, Shard)
           and pl.dim == 2]
    if not seq:
        qp = _pl(plan, ("batch", "heads", None), q.shape)
        kp = _pl(plan, ("batch", "kv_heads", None, None), k.shape)
        _align_heads(qp, kp, 1, 1)
        o = fn(_local(q, mesh, qp), _local(k, mesh, kp),
               _local(v, mesh, kp),
               valid_len=_row_vector(valid_len, mesh, _batch_only(qp)),
               split_k=split_k)
        return _wrap(o, mesh, qp, q.shape)
    # q as the cache is split: batch and heads alike, whole on kv_seq
    qp = [pl if isinstance(pl, Shard) and pl.dim < 2 else Replicate()
          for pl in kp]
    op = _pl(plan, ("batch", "heads", None), q.shape)   # the output's
    ql = _local(q, mesh, qp)
    (_, _, rows, _), off = shard_offsets(mesh, kp, k.shape)
    vlen = torch.as_tensor(_row_vector(valid_len, mesh, _batch_only(kp)),
                           device=ql.device)
    # this rank's live keys, on the device (no host sync)
    vlen = torch.clamp(vlen - off[2], 0, rows).to(torch.int32)
    acc, m, l = partials(ql, _local(k, mesh, kp), _local(v, mesh, kp),
                         valid_len=vlen, split_k=split_k)
    # [1, B, H, d + 2] a rank, stacked over the kv_seq ranks: to the ranks
    # of each output head
    part = torch.cat([acc, m[..., None], l[..., None]], -1)[None]
    n = 1
    for i in seq:
        n *= mesh.size(i)
    pp = [Shard(0) if i in seq else
          Shard(pl.dim + 1) if isinstance(pl, Shard) else pl
          for i, pl in enumerate(qp)]
    want = [Shard(pl.dim + 1) if isinstance(pl, Shard) else Replicate()
            for pl in op]
    got = _wrap(part, mesh, pp, (n, q.shape[0], q.shape[1], d + 2)
                ).redistribute(mesh, want).to_local()
    o = merge_partials(got[..., :d], got[..., d], got[..., d + 1])
    return _wrap(o.to(q.dtype), mesh, op, q.shape)


def causal_conv1d(fn, x, w, b, *, initial_state, activation, lengths,
                  out_state):
    if out_state is not None:
        raise ValueError("a sharded conv1d returns its state; it takes no "
                         "out_state")
    plan = _plan()
    mesh = _mesh(x, w, b, initial_state)
    xp = _pl(plan, ("batch", None, "conv_dim"), x.shape)
    chan = [Shard(0) if isinstance(pl, Shard) and pl.dim == 2
            else Replicate() for pl in xp]
    kk = w.shape[-1]
    sp = xp       # [B, K-1, C]: the same dims as x
    work = _split(xp)
    y, st = fn(_local(x, mesh, xp), _local(w, mesh, chan, work),
               _local(b, mesh, chan, work),
               initial_state=_local(initial_state, mesh, sp),
               activation=activation,
               lengths=_row_vector(lengths, mesh, _batch_only(xp)))
    return (_wrap(y, mesh, xp, x.shape),
            _wrap(st, mesh, sp, (x.shape[0], kk - 1, x.shape[2])))


def selective_scan(fn, x, dt, A, Bm, Cm, D, *, initial_state, out_state):
    if out_state is not None:
        raise ValueError("a sharded selective scan returns its state; it "
                         "takes no out_state")
    plan = _plan()
    mesh = _mesh(x, dt, A, Bm, Cm, D, initial_state)
    xp = _pl(plan, ("batch", None, "conv_dim"), x.shape)
    chan = [Shard(0) if isinstance(pl, Shard) and pl.dim == 2
            else Replicate() for pl in xp]
    bp = _batch_only(xp)
    hp = [Shard(1) if isinstance(pl, Shard) and pl.dim == 2 else pl
          for pl in xp]                                    # [B, C, N]
    work = _split(xp)
    y, h = fn(_local(x, mesh, xp), _local(dt, mesh, xp),
              _local(A, mesh, chan, work), _local(Bm, mesh, bp, work),
              _local(Cm, mesh, bp, work), _local(D, mesh, chan, work),
              initial_state=_local(initial_state, mesh, hp))
    b, _, c = x.shape
    return (_wrap(y, mesh, xp, x.shape),
            _wrap(h, mesh, hp, (b, c, A.shape[-1])))


def ssd_chunked(fn, x, dt, A, Bm, Cm, D, *, chunk, initial_state,
                out_state):
    if out_state is not None:
        raise ValueError("a sharded SSD returns its state; it takes no "
                         "out_state")
    plan = _plan()
    mesh = _mesh(x, dt, A, Bm, Cm, D, initial_state)
    xp = _pl(plan, ("batch", None, "ssm_heads", None), x.shape)
    g = Bm.shape[2]
    for i, pl in enumerate(xp):
        if isinstance(pl, Shard) and pl.dim == 2 and g > 1 and (
                g % mesh.size(i)):
            xp[i] = Replicate()     # the heads' groups do not split
    heads = [i for i, pl in enumerate(xp)
             if isinstance(pl, Shard) and pl.dim == 2]
    dtp = [Shard(2) if i in heads else pl for i, pl in enumerate(xp)]
    hvec = [Shard(0) if i in heads else Replicate() for i in range(len(xp))]
    bcp = [Shard(2) if (i in heads and g > 1) else
           (pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate())
           for i, pl in enumerate(xp)]
    sp = [Shard(1) if i in heads else pl for i, pl in enumerate(xp)]
    work = _split(xp)
    y, st = fn(_local(x, mesh, xp), _local(dt, mesh, dtp),
               _local(A, mesh, hvec, work), _local(Bm, mesh, bcp, work),
               _local(Cm, mesh, bcp, work), _local(D, mesh, hvec, work),
               chunk=chunk, initial_state=_local(initial_state, mesh, sp))
    b, _, h, p = x.shape
    return (_wrap(y, mesh, xp, x.shape),
            _wrap(st, mesh, sp, (b, h, p, Bm.shape[-1])))


def _decode_step(fn, batch_args, rep_args, kwargs, out_shapes):
    """A decode step on batch shards: ``batch_args`` split on dim 0,
    ``rep_args`` whole; ``out_shapes`` the outputs' global shapes."""
    plan = _plan()
    mesh = _mesh(*batch_args)
    first = next(t for t in batch_args if isinstance(t, DTensor))
    bp = _batch_only(_pl(plan, ("batch",), (first.shape[0],)))
    rep = [Replicate()] * mesh.ndim
    locs = [_local(t, mesh, bp) for t in batch_args]
    reps = [_local(t, mesh, rep) for t in rep_args]
    outs = fn(*locs, *reps, **kwargs)
    return tuple(_wrap(o, mesh, bp, s) for o, s in zip(outs, out_shapes))


def _on(placements, dim: int, to: int, batch: bool = True):
    """``placements`` with ``Shard(dim)`` moved to ``Shard(to)``, the
    batch's ``Shard(0)`` kept where ``batch``, and every other placement
    ``Replicate``: another tensor split as this one is, on its own dims
    (a parameter, ``batch=False``, has no batch dim)."""
    return [Shard(to) if isinstance(pl, Shard) and pl.dim == dim else
            pl if batch and isinstance(pl, Shard) and pl.dim == 0
            else Replicate() for pl in placements]


def mamba2_decode_fused(fn, conv_state, ssm_state, xbc_t, conv_w, conv_b,
                        dt_raw, dt_bias, A_log, D, *, n_groups, d_state,
                        headdim, out_conv, out_ssm, heads_fn):
    if out_conv is not None or out_ssm is not None:
        raise ValueError("a sharded Mamba-2 step returns its states; it "
                         "takes no destinations")
    b = xbc_t.shape[0]
    h = dt_raw.shape[1]
    plan = _plan()
    mesh = _mesh(conv_state, ssm_state, xbc_t)
    sp = _pl(plan, ("batch", "ssm_heads", None, None), ssm_state.shape)
    for i, pl in enumerate(sp):
        if isinstance(pl, Shard) and pl.dim == 1 and n_groups > 1 and (
                n_groups % mesh.size(i)):
            sp[i] = Replicate()     # the heads' groups do not split
    sp = _on(sp, 1, 1)
    if not any(isinstance(pl, Shard) and pl.dim == 1 for pl in sp):
        def run(cs, ss, xb, dr, cw, cb, bias, al, dd, **kw):
            return fn(cs, ss, xb, cw, cb, dr, bias, al, dd, **kw)
        return _decode_step(
            run, (conv_state, ssm_state, xbc_t, dt_raw),
            (conv_w, conv_b, dt_bias, A_log, D),
            dict(n_groups=n_groups, d_state=d_state, headdim=headdim),
            ((b, h, headdim), tuple(conv_state.shape),
             tuple(ssm_state.shape)))
    bp = _batch_only(sp)
    rep = [Replicate()] * mesh.ndim
    cp = _on(_pl(plan, ("batch", None, "conv_dim"), conv_state.shape), 2, 2)
    # the window and the token whole on the rank's rows: a few rows of
    # conv_dim; the state as placed
    cs, xb = _local(conv_state, mesh, bp), _local(xbc_t, mesh, bp)
    _, off = shard_offsets(mesh, sp, ssm_state.shape)
    y, ss = heads_fn(cs, _local(ssm_state, mesh, sp), xb,
                     _local(conv_w, mesh, rep), _local(conv_b, mesh, rep),
                     _local(dt_raw, mesh, sp),
                     *(_local(t, mesh, _on(sp, 1, 0, batch=False))
                       for t in (dt_bias, A_log, D)),
                     n_groups=n_groups, d_state=d_state, headdim=headdim,
                     head_offset=off[1])
    # the shifted window, whole on the rank's rows; each rank keeps its own
    # conv_dim shard (no communication)
    window = torch.cat([cs[:, 1:], xb[:, None].to(cs.dtype)], 1)
    nconv = _wrap(window, mesh, bp, conv_state.shape).redistribute(mesh, cp)
    return (_wrap(y, mesh, sp, (b, h, headdim)), nconv,
            _wrap(ss, mesh, sp, ssm_state.shape))


def mamba1_decode_fused(fn, conv_state, ssm_state, xi_t, conv_w, conv_b,
                        x_proj, dt_proj, dt_bias, A_log, D, *, d_state,
                        dt_rank, out_conv, out_ssm, split_fns):
    if out_conv is not None or out_ssm is not None:
        raise ValueError("a sharded Mamba-1 step returns its states; it "
                         "takes no destinations")
    b, c = xi_t.shape
    plan = _plan()
    mesh = _mesh(conv_state, ssm_state, xi_t)
    cp = _on(_pl(plan, ("batch", None, "conv_dim"), conv_state.shape), 2, 2)
    sp = _on(_pl(plan, ("batch", "ssm_heads", None), ssm_state.shape), 1, 1)
    chan = [i for i, pl in enumerate(cp) if isinstance(pl, Shard)
            and pl.dim == 2]
    if not chan or chan != [i for i, pl in enumerate(sp)
                            if isinstance(pl, Shard) and pl.dim == 1]:
        return _decode_step(
            fn, (conv_state, ssm_state, xi_t),
            (conv_w, conv_b, x_proj, dt_proj, dt_bias, A_log, D),
            dict(d_state=d_state, dt_rank=dt_rank),
            ((b, c), tuple(conv_state.shape), tuple(ssm_state.shape)))
    conv_proj, state = split_fns
    xp = _on(cp, 2, 1)                          # xi_t, y: [B, C]
    wp = _on(cp, 2, 0, batch=False)             # [C, ...] parameters
    dp = _on(cp, 2, 1, batch=False)             # dt_proj [R, C]
    xi, nconv, part = conv_proj(
        _local(conv_state, mesh, cp), _local(xi_t, mesh, xp),
        _local(conv_w, mesh, wp), _local(conv_b, mesh, wp),
        _local(x_proj, mesh, wp))
    # every rank's share summed in fp32: one all-reduce over the channels'
    # mesh dims
    pp = [Partial() if i in chan else pl
          for i, pl in enumerate(_batch_only(cp))]
    proj = _wrap(part, mesh, pp, (b, part.shape[-1])).redistribute(
        mesh, _batch_only(cp)).to_local()
    y, ss = state(_local(ssm_state, mesh, sp), xi, proj,
                  _local(dt_proj, mesh, dp), _local(dt_bias, mesh, wp),
                  _local(A_log, mesh, wp), _local(D, mesh, wp),
                  d_state=d_state, dt_rank=dt_rank)
    return (_wrap(y, mesh, xp, (b, c)), _wrap(nconv, mesh, cp,
                                                 conv_state.shape),
            _wrap(ss, mesh, sp, ssm_state.shape))
