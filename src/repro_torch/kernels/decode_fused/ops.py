"""Fused decode steps (Mamba-2 and Mamba-1): the device picks the path.

One call is one Mamba layer's whole per-token recurrence: the conv shift
step, SiLU, (Mamba-1: the x_proj and dt_proj projections,) softplus(dt),
the state update ``h' = h*exp(dt*A) + dt*B*x`` and the readout
``y = C.h' + D*x``.  A CPU tensor runs the plain version; a CUDA tensor
launches ``csrc/decode_fused.cu`` (Mamba-2) or ``csrc/mamba1_decode.cu``
(Mamba-1), or raises; a ``meta`` tensor (the static walk,
:mod:`repro_torch.core.op_analysis`) records one kernel and returns empty
outputs.  Both run in the ``decode_fused`` scope.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.op_analysis import kernel_cost
from repro_torch.core.scope import scope
from repro_torch.kernels import build
from repro_torch.kernels.decode_fused import ref as _ref
from repro_torch.kernels.grad import needs_grad, no_backward


# d_state values the Mamba-2 kernel is instantiated for, and its most
# state rows (headdim) a block
M2_D_STATES = (16, 64, 128)
M2_MAX_HEADDIM = 64


def mamba2_decode_fused(conv_state, ssm_state, xbc_t, conv_w, conv_b,
                        dt_raw, dt_bias, A_log, D, *, n_groups: int,
                        d_state: int, headdim: int,
                        out_conv: Optional[torch.Tensor] = None,
                        out_ssm: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (y [B,H,P] in xbc's dtype, conv window' [B,K-1,C],
    ssm' [B,H,P,N] fp32).  ``out_conv`` and ``out_ssm`` (contiguous
    tensors of those shapes and types, e.g. slots of a new cache, apart
    from the inputs) receive the new window and state, and are returned
    as them.  DTensor inputs run on the state's placement: its heads where
    the plan splits ``ssm_heads`` (:func:`mamba2_decode_heads`), else its
    batch shards (:mod:`repro_torch.kernels.sharded`)."""
    if isinstance(xbc_t, DTensor):
        from repro_torch.kernels import sharded
        return sharded.mamba2_decode_fused(
            mamba2_decode_fused, conv_state, ssm_state, xbc_t, conv_w,
            conv_b, dt_raw, dt_bias, A_log, D, n_groups=n_groups,
            d_state=d_state, headdim=headdim, out_conv=out_conv,
            out_ssm=out_ssm, heads_fn=mamba2_decode_heads)
    with scope("decode_fused"):
        if xbc_t.device.type == "cpu":
            return _ref.mamba2_decode_fused_ref(
                conv_state, ssm_state, xbc_t, conv_w, conv_b, dt_raw,
                dt_bias, A_log, D, n_groups=n_groups, d_state=d_state,
                headdim=headdim, out_conv=out_conv, out_ssm=out_ssm)
        if xbc_t.device.type == "meta":
            b = xbc_t.shape[0]
            h = dt_raw.shape[1]
            y = torch.empty((b, h, headdim), dtype=xbc_t.dtype,
                            device=xbc_t.device)
            nconv = _meta_out(out_conv, conv_state)
            nssm = _meta_out(out_ssm, ssm_state, torch.float32)
            # per state: dA*h, + dt*B*x (2), C.h (2), and the exponential
            kernel_cost("mamba2_decode_fused", 6.0 * b * h * headdim * d_state,
                        (conv_state, ssm_state, xbc_t, conv_w, conv_b,
                         dt_raw, dt_bias, A_log, D), (y, nconv, nssm))
            return y, nconv, nssm
        if needs_grad(conv_state, ssm_state, xbc_t, conv_w, conv_b,
                      dt_raw, dt_bias, A_log, D):
            raise no_backward("mamba2_decode_fused", "the Mamba-2 decode "
                              "step")
        return mamba2_decode_fused_cuda(
            conv_state, ssm_state, xbc_t, conv_w, conv_b, dt_raw, dt_bias,
            A_log, D, n_groups=n_groups, d_state=d_state, headdim=headdim,
            out_conv=out_conv, out_ssm=out_ssm)


def _meta_out(out, like, dtype=None):
    """A meta branch's destination: ``out`` where given, else an empty
    tensor like ``like``."""
    return out if out is not None else torch.empty_like(
        like, dtype=dtype or like.dtype)


def mamba2_decode_fused_cuda(conv_state, ssm_state, xbc_t, conv_w, conv_b,
                             dt_raw, dt_bias, A_log, D, *, n_groups: int,
                             d_state: int, headdim: int, out_conv=None,
                             out_ssm=None):
    return _m2_launch(mamba2_decode_fused, conv_state, ssm_state, xbc_t,
                      conv_w, conv_b, dt_raw, dt_bias, A_log, D,
                      n_groups=n_groups, d_state=d_state, headdim=headdim,
                      head_offset=None, out_conv=out_conv, out_ssm=out_ssm)


def _m2_launch(wrapper, conv_state, ssm_state, xbc_t, conv_w, conv_b,
               dt_raw, dt_bias, A_log, D, *, n_groups: int, d_state: int,
               headdim: int, head_offset: Optional[int], out_conv, out_ssm):
    """One launch of ``csrc/decode_fused.cu``, counted on ``wrapper``: the
    whole step (``head_offset`` None: y, window', ssm'), or the head-slice
    mode on ``ssm_state``'s heads from ``head_offset`` (y, ssm')."""
    if xbc_t.device.type != "cuda":
        raise ValueError(f"decode kernel needs a CUDA tensor, got "
                         f"{xbc_t.device}")
    b, km1, c = conv_state.shape
    k = km1 + 1
    g, n, p = n_groups, d_state, headdim
    di = c - 2 * g * n
    h = di // p
    h0 = head_offset or 0
    hl = ssm_state.shape[1] if head_offset is not None else h
    if n not in M2_D_STATES or p > M2_MAX_HEADDIM:
        raise ValueError(f"mamba2 decode kernel built for d_state in "
                         f"{M2_D_STATES} and headdim <= {M2_MAX_HEADDIM}, "
                         f"got {n}, {p}")
    if (xbc_t.shape != (b, c) or di <= 0 or di % p or h % g
            or hl < 1 or not 0 <= h0 <= h - hl
            or ssm_state.shape != (b, hl, p, n) or conv_w.shape != (c, k)
            or conv_b.shape != (c,) or dt_raw.shape != (b, hl)
            or not (dt_bias.shape == A_log.shape == D.shape == (hl,))
            or not 2 <= k <= 8):
        raise ValueError("bad mamba2 decode shapes")
    if conv_state.dtype != xbc_t.dtype:
        raise TypeError("kernel takes conv_state in xbc's dtype")
    if ssm_state.dtype != torch.float32:
        raise TypeError("kernel takes an fp32 ssm state")
    code = build.dtype_code(xbc_t.dtype)
    # the plain version reads these in fp32; upcasts are exact
    ins = [conv_state.contiguous(), ssm_state.contiguous(),
           xbc_t.contiguous(), conv_w.float().contiguous(),
           conv_b.float().contiguous(), dt_raw.float().contiguous(),
           dt_bias.float().contiguous(), A_log.float().contiguous(),
           D.float().contiguous()]
    if ins[1].data_ptr() % 16:      # the state is read in 16-byte vectors
        ins[1] = ins[1].clone()
    if any(t.device != xbc_t.device for t in ins):
        raise ValueError("all decode inputs must be on one device")
    y = torch.empty((b, hl, p), dtype=xbc_t.dtype, device=xbc_t.device)
    # the old window and state, and the token, are read while other
    # blocks write the destinations; the head-slice mode writes no window
    nconv = (None if head_offset is not None else
             build.destination(out_conv, ins[0], "out_conv", ins[:3]))
    nssm = build.destination(out_ssm, ins[1], "out_ssm",
                             ins[:3] + [t for t in (nconv,) if t is not None])
    lib = build.library()
    rc = lib.repro_mamba2_decode_fwd(
        *[t.data_ptr() for t in ins], y.data_ptr(),
        0 if nconv is None else nconv.data_ptr(), nssm.data_ptr(), b, h, p,
        g, n, k, h0, hl, code, build.stream_ptr(xbc_t.device))
    build.check(rc, "repro_mamba2_decode_fwd")
    wrapper.launches += 1
    return (y, nssm) if nconv is None else (y, nconv, nssm)


mamba2_decode_fused.launches = 0


def mamba2_decode_heads(conv_state, ssm_state, xbc_t, conv_w, conv_b,
                        dt_raw, dt_bias, A_log, D, *, n_groups: int,
                        d_state: int, headdim: int, head_offset: int,
                        out_ssm: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 step on heads ``head_offset .. head_offset + Hl - 1``
    of H (a rank of a plan that splits ``ssm_heads``).  conv_state [B,K-1,C]
    and xbc_t [B,C] are whole, as are conv_w and conv_b; ssm_state
    [B,Hl,P,N], dt_raw [B,Hl] and dt_bias, A_log, D [Hl] the rank's.
    Returns (y [B,Hl,P] in xbc's dtype, ssm' [B,Hl,P,N] fp32), each head's
    values those of :func:`mamba2_decode_fused`; the new window is not
    made here (the caller shifts its own shard of it).  A CPU tensor runs
    ``mamba2_decode_heads_ref``, a CUDA tensor the kernel's head-slice
    mode (its own launch counter), or raises."""
    with scope("decode_fused"):
        if xbc_t.device.type == "cpu":
            return _ref.mamba2_decode_heads_ref(
                conv_state, ssm_state, xbc_t, conv_w, conv_b, dt_raw,
                dt_bias, A_log, D, n_groups=n_groups, d_state=d_state,
                headdim=headdim, head_offset=head_offset, out_ssm=out_ssm)
        if xbc_t.device.type == "meta":
            b, hl = dt_raw.shape
            y = torch.empty((b, hl, headdim), dtype=xbc_t.dtype,
                            device=xbc_t.device)
            nssm = _meta_out(out_ssm, ssm_state, torch.float32)
            kernel_cost("mamba2_decode_heads",
                        6.0 * b * hl * headdim * d_state,
                        (conv_state, ssm_state, xbc_t, conv_w, conv_b,
                         dt_raw, dt_bias, A_log, D), (y, nssm))
            return y, nssm
        if needs_grad(conv_state, ssm_state, xbc_t, conv_w, conv_b,
                      dt_raw, dt_bias, A_log, D):
            raise no_backward("mamba2_decode_heads", "the Mamba-2 decode "
                              "step")
        return mamba2_decode_heads_cuda(
            conv_state, ssm_state, xbc_t, conv_w, conv_b, dt_raw, dt_bias,
            A_log, D, n_groups=n_groups, d_state=d_state, headdim=headdim,
            head_offset=head_offset, out_ssm=out_ssm)


def mamba2_decode_heads_cuda(conv_state, ssm_state, xbc_t, conv_w, conv_b,
                             dt_raw, dt_bias, A_log, D, *, n_groups: int,
                             d_state: int, headdim: int, head_offset: int,
                             out_ssm=None):
    return _m2_launch(mamba2_decode_heads, conv_state, ssm_state, xbc_t,
                      conv_w, conv_b, dt_raw, dt_bias, A_log, D,
                      n_groups=n_groups, d_state=d_state, headdim=headdim,
                      head_offset=head_offset, out_conv=None,
                      out_ssm=out_ssm)


mamba2_decode_heads.launches = 0


# d_state values the Mamba-1 kernel is instantiated for, and its limits:
# the blocks of one batch row form a cluster of M1_CLUSTER, each taking at
# most 256 channels, one thread each (every shape within these limits fits
# a block's shared memory)
M1_D_STATES = (8, 16)
M1_MAX_PROJ = 128           # dt_rank + 2 * d_state
M1_CLUSTER = 8
M1_MAX_D_INNER = M1_CLUSTER * 256


def m1_check_width(di: int) -> None:
    """Raises where ``di`` channels need a cluster of more than
    ``M1_CLUSTER`` blocks."""
    if di > M1_MAX_D_INNER:
        raise ValueError(
            f"mamba1 decode kernel: d_inner {di} needs a cluster of more "
            f"than {M1_CLUSTER} blocks")


def mamba1_decode_fused(conv_state, ssm_state, xi_t, conv_w, conv_b, x_proj,
                        dt_proj, dt_bias, A_log, D, *, d_state: int,
                        dt_rank: int,
                        out_conv: Optional[torch.Tensor] = None,
                        out_ssm: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """conv_state: [B,K-1,di]; ssm_state: [B,di,N]; xi_t: [B,di] (pre-conv).
    Returns (y [B,di] fp32, conv window' [B,K-1,di], ssm' [B,di,N] fp32).
    ``out_conv`` and ``out_ssm`` (contiguous tensors of those shapes and
    types, e.g. slots of a new cache, apart from the inputs) receive the
    new window and state, and are returned as them.  DTensor inputs run on
    the state's placement: its channels where the plan splits
    ``conv_dim`` (:func:`mamba1_decode_conv_proj`, an all-reduce,
    :func:`mamba1_decode_state`), else its batch shards
    (:mod:`repro_torch.kernels.sharded`)."""
    if isinstance(xi_t, DTensor):
        from repro_torch.kernels import sharded
        return sharded.mamba1_decode_fused(
            mamba1_decode_fused, conv_state, ssm_state, xi_t, conv_w, conv_b,
            x_proj, dt_proj, dt_bias, A_log, D, d_state=d_state,
            dt_rank=dt_rank, out_conv=out_conv, out_ssm=out_ssm,
            split_fns=(mamba1_decode_conv_proj, mamba1_decode_state))
    with scope("decode_fused"):
        if xi_t.device.type == "cpu":
            return _ref.mamba1_decode_fused_ref(
                conv_state, ssm_state, xi_t, conv_w, conv_b, x_proj,
                dt_proj, dt_bias, A_log, D, d_state=d_state,
                dt_rank=dt_rank, out_conv=out_conv, out_ssm=out_ssm)
        if xi_t.device.type == "meta":
            b, k, c = conv_state.shape[0], conv_w.shape[1], xi_t.shape[1]
            f = dt_rank + 2 * d_state
            y = torch.empty((b, c), dtype=torch.float32, device=xi_t.device)
            nconv = _meta_out(out_conv, conv_state)
            nssm = _meta_out(out_ssm, ssm_state, torch.float32)
            # conv, x_proj, dt_proj; per state: exp(A_log), dt*A, exp,
            # h*dA + (dt*x)*B (3), C.h (2)
            flops = b * (2.0 * k * c + 2.0 * c * f + 2.0 * dt_rank * c
                         + 8.0 * c * d_state)
            kernel_cost("mamba1_decode_fused", flops,
                        (conv_state, ssm_state, xi_t, conv_w, conv_b, x_proj,
                         dt_proj, dt_bias, A_log, D), (y, nconv, nssm))
            return y, nconv, nssm
        if needs_grad(conv_state, ssm_state, xi_t, conv_w, conv_b, x_proj,
                      dt_proj, dt_bias, A_log, D):
            raise no_backward("mamba1_decode_fused", "the Mamba-1 decode "
                              "step")
        return mamba1_decode_fused_cuda(
            conv_state, ssm_state, xi_t, conv_w, conv_b, x_proj, dt_proj,
            dt_bias, A_log, D, d_state=d_state, dt_rank=dt_rank,
            out_conv=out_conv, out_ssm=out_ssm)


def mamba1_decode_fused_cuda(conv_state, ssm_state, xi_t, conv_w, conv_b,
                             x_proj, dt_proj, dt_bias, A_log, D, *,
                             d_state: int, dt_rank: int, out_conv=None,
                             out_ssm=None):
    if xi_t.device.type != "cuda":
        raise ValueError(f"decode kernel needs a CUDA tensor, got "
                         f"{xi_t.device}")
    b, km1, di = conv_state.shape
    k, n, r = km1 + 1, d_state, dt_rank
    f = r + 2 * n
    if n not in M1_D_STATES:
        raise ValueError(f"mamba1 decode kernel built for d_state in "
                         f"{M1_D_STATES}, got {n}")
    if (xi_t.shape != (b, di) or ssm_state.shape != (b, di, n)
            or conv_w.shape != (di, k) or conv_b.shape != (di,)
            or x_proj.shape != (di, f) or dt_proj.shape != (r, di)
            or not (dt_bias.shape == D.shape == (di,))
            or A_log.shape != (di, n) or not 2 <= k <= 4 or r < 1
            or f > M1_MAX_PROJ):
        raise ValueError("bad mamba1 decode shapes")
    if conv_state.dtype != xi_t.dtype:
        raise TypeError("kernel takes conv_state in xi's dtype")
    if ssm_state.dtype != torch.float32:
        raise TypeError("kernel takes an fp32 ssm state")
    cd = xi_t.dtype
    code = build.dtype_code(cd)
    m1_check_width(di)
    # the plain version reads the projections in xi's dtype and the conv
    # and SSM parameters in fp32
    ins = [conv_state.contiguous(), ssm_state.contiguous(),
           xi_t.contiguous(), conv_w.float().contiguous(),
           conv_b.float().contiguous(), x_proj.to(cd).contiguous(),
           dt_proj.to(cd).contiguous(), dt_bias.float().contiguous(),
           A_log.float().contiguous(), D.float().contiguous()]
    if any(t.device != xi_t.device for t in ins):
        raise ValueError("all decode inputs must be on one device")
    y = torch.empty((b, di), dtype=torch.float32, device=xi_t.device)
    # the old window and state, and the token, are read while other
    # blocks write the destinations
    nconv = build.destination(out_conv, ins[0], "out_conv", ins[:3])
    nssm = build.destination(out_ssm, ins[1], "out_ssm", ins[:3] + [nconv])
    lib = build.library()
    rc = lib.repro_mamba1_decode_fwd(
        *[t.data_ptr() for t in ins], y.data_ptr(), nconv.data_ptr(),
        nssm.data_ptr(), b, di, n, r, k, code,
        build.stream_ptr(xi_t.device))
    build.check(rc, "repro_mamba1_decode_fwd")
    mamba1_decode_fused.launches += 1
    return y, nconv, nssm


mamba1_decode_fused.launches = 0


# a channel-split rank's most channels (the conv output staged in shared
# memory)
M1_SPLIT_MAX_C = 8192


def mamba1_decode_conv_proj(conv_state, xi_t, conv_w, conv_b, x_proj
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Launch (a) of the Mamba-1 step on a rank's channels (a plan that
    splits ``conv_dim``): conv_state [B,K-1,c], xi_t [B,c], conv_w [c,K],
    conv_b [c] and x_proj [c, dt_rank + 2N], the rank's rows.  Returns
    (the conv output [B,c] in xi's dtype, conv window' [B,K-1,c], this
    rank's fp32 share of xi @ x_proj [B, dt_rank + 2N]); the caller sums
    the shares over the ranks and passes the sum to
    :func:`mamba1_decode_state`.  A CPU tensor runs the plain version, a
    CUDA tensor ``csrc/mamba1_decode.cu``'s ``m1_conv_proj_kernel``, or
    raises."""
    with scope("decode_fused"):
        if xi_t.device.type == "cpu":
            return _ref.mamba1_decode_conv_proj_ref(conv_state, xi_t, conv_w,
                                                    conv_b, x_proj)
        if xi_t.device.type == "meta":
            b, c = xi_t.shape
            k, f = conv_w.shape[1], x_proj.shape[1]
            xi = torch.empty_like(xi_t)
            nconv = torch.empty_like(conv_state)
            part = torch.empty((b, f), dtype=torch.float32,
                               device=xi_t.device)
            kernel_cost("mamba1_decode_conv_proj",
                        b * (2.0 * k * c + 2.0 * c * f),
                        (conv_state, xi_t, conv_w, conv_b, x_proj),
                        (xi, nconv, part))
            return xi, nconv, part
        if needs_grad(conv_state, xi_t, conv_w, conv_b, x_proj):
            raise no_backward("mamba1_decode_conv_proj", "the Mamba-1 "
                              "decode step")
        return _conv_proj_cuda(conv_state, xi_t, conv_w, conv_b, x_proj)


def _conv_proj_cuda(conv_state, xi_t, conv_w, conv_b, x_proj):
    if xi_t.device.type != "cuda":
        raise ValueError(f"decode kernel needs a CUDA tensor, got "
                         f"{xi_t.device}")
    b, km1, c = conv_state.shape
    k, f = km1 + 1, x_proj.shape[-1]
    if (xi_t.shape != (b, c) or conv_w.shape != (c, k)
            or conv_b.shape != (c,) or x_proj.shape != (c, f)
            or not 2 <= k <= 4 or f > M1_MAX_PROJ or c > M1_SPLIT_MAX_C):
        raise ValueError("bad mamba1 decode conv_proj shapes")
    if conv_state.dtype != xi_t.dtype:
        raise TypeError("kernel takes conv_state in xi's dtype")
    cd = xi_t.dtype
    code = build.dtype_code(cd)
    ins = [conv_state.contiguous(), xi_t.contiguous(),
           conv_w.float().contiguous(), conv_b.float().contiguous(),
           x_proj.to(cd).contiguous()]
    if any(t.device != xi_t.device for t in ins):
        raise ValueError("all decode inputs must be on one device")
    xi = torch.empty_like(ins[1])
    nconv = torch.empty_like(ins[0])
    part = torch.empty((b, f), dtype=torch.float32, device=xi_t.device)
    lib = build.library()
    rc = lib.repro_mamba1_decode_conv_proj_fwd(
        *[t.data_ptr() for t in ins], xi.data_ptr(), nconv.data_ptr(),
        part.data_ptr(), b, c, f, k, code, build.stream_ptr(xi_t.device))
    build.check(rc, "repro_mamba1_decode_conv_proj_fwd")
    mamba1_decode_conv_proj.launches += 1
    return xi, nconv, part


mamba1_decode_conv_proj.launches = 0


def mamba1_decode_state(ssm_state, xi, proj, dt_proj, dt_bias, A_log, D, *,
                        d_state: int, dt_rank: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch (b) of the Mamba-1 step on a rank's channels: ssm_state
    [B,c,N] fp32, xi [B,c] (launch (a)'s conv output), proj [B, dt_rank +
    2N] fp32 (every rank's share summed), dt_proj [dt_rank, c], dt_bias,
    D [c] and A_log [c,N], the rank's.  proj is rounded to xi's dtype, as
    :func:`mamba1_decode_fused` rounds its x_proj product.  Returns (y
    [B,c] fp32, ssm' [B,c,N] fp32).  A CPU tensor runs the plain version,
    a CUDA tensor ``csrc/mamba1_decode.cu``'s ``m1_state_kernel``, or
    raises."""
    with scope("decode_fused"):
        if xi.device.type == "cpu":
            return _ref.mamba1_decode_state_ref(
                ssm_state, xi, proj, dt_proj, dt_bias, A_log, D,
                d_state=d_state, dt_rank=dt_rank)
        if xi.device.type == "meta":
            b, c = xi.shape
            y = torch.empty((b, c), dtype=torch.float32, device=xi.device)
            nssm = torch.empty_like(ssm_state, dtype=torch.float32)
            kernel_cost("mamba1_decode_state",
                        b * (2.0 * dt_rank * c + 8.0 * c * d_state),
                        (ssm_state, xi, proj, dt_proj, dt_bias, A_log, D),
                        (y, nssm))
            return y, nssm
        if needs_grad(ssm_state, xi, proj, dt_proj, dt_bias, A_log, D):
            raise no_backward("mamba1_decode_state", "the Mamba-1 decode "
                              "step")
        return _state_cuda(ssm_state, xi, proj, dt_proj, dt_bias, A_log, D,
                           d_state=d_state, dt_rank=dt_rank)


def _state_cuda(ssm_state, xi, proj, dt_proj, dt_bias, A_log, D, *,
                d_state: int, dt_rank: int):
    if xi.device.type != "cuda":
        raise ValueError(f"decode kernel needs a CUDA tensor, got "
                         f"{xi.device}")
    b, c = xi.shape
    n, r = d_state, dt_rank
    f = r + 2 * n
    if n not in M1_D_STATES:
        raise ValueError(f"mamba1 decode kernel built for d_state in "
                         f"{M1_D_STATES}, got {n}")
    if (ssm_state.shape != (b, c, n) or proj.shape != (b, f)
            or dt_proj.shape != (r, c) or A_log.shape != (c, n)
            or not (dt_bias.shape == D.shape == (c,)) or r < 1
            or f > M1_MAX_PROJ):
        raise ValueError("bad mamba1 decode state shapes")
    if ssm_state.dtype != torch.float32 or proj.dtype != torch.float32:
        raise TypeError("kernel takes an fp32 ssm state and x_proj sum")
    cd = xi.dtype
    code = build.dtype_code(cd)
    ins = [ssm_state.contiguous(), xi.contiguous(), proj.contiguous(),
           dt_proj.to(cd).contiguous(), dt_bias.float().contiguous(),
           A_log.float().contiguous(), D.float().contiguous()]
    if any(t.device != xi.device for t in ins):
        raise ValueError("all decode inputs must be on one device")
    y = torch.empty((b, c), dtype=torch.float32, device=xi.device)
    nssm = torch.empty_like(ins[0])
    lib = build.library()
    rc = lib.repro_mamba1_decode_state_fwd(
        *[t.data_ptr() for t in ins], y.data_ptr(), nssm.data_ptr(), b, c,
        n, r, code, build.stream_ptr(xi.device))
    build.check(rc, "repro_mamba1_decode_state_fwd")
    mamba1_decode_state.launches += 1
    return y, nssm


mamba1_decode_state.launches = 0
