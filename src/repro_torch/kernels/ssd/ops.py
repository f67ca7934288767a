"""Chunked SSD scan: the device picks the path.

A CPU tensor runs the plain ``ssd_chunked_ref``; a CUDA tensor launches
the hand-written kernel (``csrc/ssd.cu``) or raises; a ``meta`` tensor
(the static walk, :mod:`repro_torch.core.op_analysis`) records one kernel
and returns empty outputs.  Both entry points run in the ``ssd_core``
scope, as the reference's do.  The ``softplus`` and
``-exp(A_log)`` preprocessing stays plain torch here, outside the kernel,
as the reference keeps it outside its ``pallas_call`` (autograd carries it
in training).

A call that needs a gradient (:mod:`repro_torch.kernels.grad`) with no
initial state and no ``out_state`` (training's) runs :class:`SsdFn`: the
forward kernel, which also saves each chunk's start state, and the
backward kernel (``csrc/ssd_bwd.cu``, one call of the launches
:func:`ssd_bwd_plan` says: chunk-parallel passes on tensor cores in bf16
at the served shapes, a walk over the chunks on CUDA cores otherwise) on
the card; the plain versions on the CPU.  The final state it returns
carries no gradient.  Any other such call raises on the card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.op_analysis import kernel_cost
from repro_torch.core.scope import scope
from repro_torch.kernels import build
from repro_torch.kernels.grad import needs_grad, no_backward
from repro_torch.kernels.ssd import ref as _ref

# (chunk, headdim, d_state) the kernel is instantiated for: mamba2-2.7b's,
# zamba2-2.7b's and the reduced test config's
SHAPES = {(128, 64, 128), (128, 64, 64), (16, 16, 16)}
# the bf16 instances that run on tensor cores; the rest run on CUDA cores
TC_SHAPES = {(128, 64, 128), (128, 64, 64)}


class SsdPlan(NamedTuple):
    """How one call is cut into blocks: ``route`` "mma" (bf16 on tensor
    cores) or "cuda_cores"; ``blocks``, one per (batch row, head);
    ``smem_bytes`` of dynamic shared memory a block."""
    route: str
    blocks: int
    smem_bytes: int


def ssd_plan(b: int, h: int, chunk: int, p: int, n: int, dtype) -> SsdPlan:
    """The launch plan, from shapes only: one block per (batch row, head).
    bf16 at a ``TC_SHAPES`` shape runs on tensor cores (a block holds two
    stages of x, B and C in bf16, the state's two bf16 terms, rows padded
    by 8 elements, and six fp32 rows of per-token scalars: ``csrc/ssd.cu``,
    TcSmem, one block an SM); elsewhere on CUDA cores, with padded fp32
    stages."""
    if (chunk, p, n) not in SHAPES:
        raise ValueError(f"ssd kernel built for (chunk, P, N) in "
                         f"{sorted(SHAPES)}, got {(chunk, p, n)}")
    if dtype == torch.bfloat16 and (chunk, p, n) in TC_SHAPES:
        bf16 = 2 * chunk * ((p + 8) + 2 * (n + 8)) + 2 * p * (n + 8)
        return SsdPlan("mma", b * h, 2 * bf16 + 6 * chunk * 4)
    rb = min(chunk, 32)
    floats = (p * (n + 1) + 2 * chunk * (n + 1) + chunk * p
              + rb * (chunk + 16) + 3 * chunk)
    return SsdPlan("cuda_cores", b * h, 4 * floats)


MAX_SLICE = 8     # heads a block of the backward's local and chunk passes


class SsdBwdPlan(NamedTuple):
    """How one backward call is cut: ``route`` "mma" (bf16 at a
    ``TC_SHAPES`` shape) or "cuda_cores"; ``blocks`` and ``smem_bytes``
    (dynamic shared memory a block) of each launch in order (tensor
    cores: local, state, chunk, finish; CUDA cores: the walk, finish);
    ``heads_per_block`` (a slice of one group's heads on tensor cores);
    ``scratch``, the fp32 scratch shapes in the C entry point's order
    (dxf, dBf, dCf, dAp, dDp, dh, dhT; an empty shape is not passed)."""
    route: str
    blocks: Tuple[int, ...]
    smem_bytes: Tuple[int, ...]
    heads_per_block: int
    scratch: Tuple[Tuple[int, ...], ...]


def slice_heads(h: int, g: int) -> int:
    """The heads of one backward block on tensor cores: the most, up to
    ``MAX_SLICE``, that divide a group's, so they share B and C."""
    hg = h // g
    return next(k for k in range(min(hg, MAX_SLICE), 0, -1) if hg % k == 0)


def ssd_bwd_plan(b: int, s: int, h: int, chunk: int, p: int, g: int,
                 n: int, dtype) -> SsdBwdPlan:
    """The backward's launch plan, from shapes only (``csrc/ssd_bwd.cu``).
    On tensor cores: the local and chunk passes take a block per (batch
    row, chunk, slice of ``slice_heads`` heads); the local pass holds C
    and dy in bf16 (rows padded by 8 elements) and two fp32 rows a token,
    the chunk pass B, C, x, dy, dh' and h in bf16, nine fp32 rows a
    token and 16 slots; the state pass a thread per four elements of each
    (batch row, head)'s P x N, 256 a block; the finish a thread per
    element of dB.  Scratch: the gradients of the chunks' leaving states
    [B,H,nc,P,N], e^cum_last [B,H,nc], dB and dC partials
    [B,S,H/slice,N], dA and dD partials [B,nc,H].  On CUDA cores a block
    per (batch row, head) (``BwdLayout``), then a block per (batch row,
    token)."""
    ssd_plan(b, h, chunk, p, n, dtype)
    if s % chunk or h % g:
        raise ValueError(f"seq {s} must be a multiple of chunk {chunk} and "
                         f"heads {h} of groups {g}")
    nc, q = s // chunk, chunk
    if dtype == torch.bfloat16 and (chunk, p, n) in TC_SHAPES:
        hs = slice_heads(h, g)
        units = b * nc * (h // hs)
        local = 2 * (q * (n + 8) + q * (p + 8)) + 2 * q * 4
        chunk_b = (2 * (2 * q * (n + 8) + 2 * q * (p + 8) + 2 * p * (n + 8))
                   + 9 * q * 4 + 16 * 4)
        return SsdBwdPlan(
            "mma", (units, -(-b * h * p * n // 4 // 256), units,
                    -(-b * s * g * n // 256)), (local, 0, chunk_b, 0), hs,
            ((0,), (b, s, h // hs, n), (b, s, h // hs, n), (b, nc, h),
             (b, nc, h), (b, h, nc, p, n), (b, h, nc)))
    pad = 1 if dtype == torch.float32 else 2
    esz = build.dtype_size(dtype)
    ops = (2 * q * (p + pad) + 2 * q * (n + pad)) * esz
    smem = -(-ops // 16) * 16 + (3 * 16 * (q + 1) + 7 * q + 32) * 4
    return SsdBwdPlan("cuda_cores", (b * h, b * s), (smem, 0), 1,
                      ((b, s, h, p), (b, s, h, n), (b, s, h, n), (b, h),
                       (b, h), (b, h, p, n), (b, h, p, n)))


def ssd_chunked(x, dt, A, Bm, Cm, D, *, chunk: int = 128,
                initial_state: Optional[torch.Tensor] = None,
                out_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y [B,S,H,P], final_state [B,H,P,N]).
    ``out_state`` (a contiguous, 16-byte aligned fp32 [B,H,P,N], e.g. a
    cache slot, apart from the other inputs) receives the final state, and
    is returned as it.  DTensor inputs run on their shards
    (:mod:`repro_torch.kernels.sharded`)."""
    if isinstance(x, DTensor):
        from repro_torch.kernels import sharded
        return sharded.ssd_chunked(ssd_chunked, x, dt, A, Bm, Cm, D,
                                   chunk=chunk, initial_state=initial_state,
                                   out_state=out_state)
    with scope("ssd_core"):
        if (needs_grad(x, dt, A, Bm, Cm, D, initial_state)
                and x.device.type != "meta"):
            if initial_state is None and out_state is None:
                return SsdFn.apply(x, dt, A, Bm, Cm, D, chunk)
            if x.device.type == "cuda":
                raise no_backward("ssd_chunked", "an initial state or a "
                                  "state destination")
        if x.device.type == "cpu":
            return _ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=chunk,
                                        initial_state=initial_state,
                                        out_state=out_state)
        if x.device.type == "meta":
            return _ssd_meta(x, dt, A, Bm, Cm, D, chunk, initial_state,
                             out_state)
        return ssd_chunked_cuda(x, dt, A, Bm, Cm, D, chunk=chunk,
                                initial_state=initial_state,
                                out_state=out_state)


def _ssd_meta(x, dt, A, Bm, Cm, D, chunk, initial_state, out_state):
    """One kernel in the static walk: per chunk and head the score and
    output products and the state's read and update, 2 FLOPs a
    multiply-add."""
    b, s, h, p = x.shape
    n = Bm.shape[3]
    y = torch.empty_like(x)
    final = out_state if out_state is not None else torch.empty(
        (b, h, p, n), dtype=torch.float32, device=x.device)
    q = chunk
    flops = 2.0 * b * h * (s // q) * (q * q * n + q * q * p + 2 * q * p * n)
    kernel_cost("ssd_chunked", flops, (x, dt, A, Bm, Cm, D, initial_state),
                (y, final))
    return y, final


def ssd_chunked_cuda(x, dt, A, Bm, Cm, D, *, chunk: int = 128,
                     initial_state=None, out_state=None,
                     chunk_states: bool = False):
    """The kernel, launched as :func:`ssd_plan` says.  ``chunk_states``
    adds a third output, the state entering each chunk (fp32 [B, H,
    S / chunk, P, N]), for the backward."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd kernel needs a CUDA tensor, got {x.device}")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    ssd_plan(b, h, chunk, p, n, x.dtype)
    if s % chunk or h % g:
        raise ValueError(f"seq {s} must be a multiple of chunk {chunk} and "
                         f"heads {h} of groups {g}")
    if (dt.shape != (b, s, h) or A.shape != (h,) or D.shape != (h,)
            or Bm.shape != (b, s, g, n) or Cm.shape != Bm.shape):
        raise ValueError("bad ssd input shapes")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError("x, B and C must share one dtype")
    code = build.dtype_code(x.dtype)
    if initial_state is None:
        initial_state = torch.zeros((b, h, p, n), dtype=torch.float32,
                                    device=x.device)
    if initial_state.shape != (b, h, p, n):
        raise ValueError(f"initial_state {tuple(initial_state.shape)}")
    ins = [x.contiguous(), dt.float().contiguous(), A.float().contiguous(),
           Bm.contiguous(), Cm.contiguous(), D.float().contiguous(),
           initial_state.float().contiguous()]
    if any(t.device != x.device for t in ins):
        raise ValueError("all ssd inputs must be on one device")
    # the tensor-core kernel reads x, B and C in 16-byte vectors
    for i in (0, 3, 4):
        if ins[i].data_ptr() % 16:
            ins[i] = ins[i].clone()
    y = torch.empty_like(ins[0])
    # each block reads its own rows of initial_state before it writes them,
    # and every block reads the other inputs
    final = build.destination(out_state, ins[6], "out_state", ins[:6])
    states = (torch.empty((b, h, s // chunk, p, n), dtype=torch.float32,
                          device=x.device) if chunk_states else None)
    lib = build.library()
    rc = lib.repro_ssd_fwd(*[t.data_ptr() for t in ins], y.data_ptr(),
                           final.data_ptr(),
                           None if states is None else states.data_ptr(),
                           b, s, h, p, g, n, chunk, code,
                           build.stream_ptr(x.device))
    build.check(rc, "repro_ssd_fwd")
    ssd_chunked.launches += 1
    return (y, final, states) if chunk_states else (y, final)


ssd_chunked.launches = 0


class SsdFn(torch.autograd.Function):
    """The chunked scan from a zero state with its backward: returns (y,
    final state), the final state without a gradient."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, chunk):
        if x.device.type == "cpu":
            y, final, states = _ref.ssd_chunked_states_ref(
                x, dt, A, Bm, Cm, D, chunk=chunk)
        else:
            y, final, states = ssd_chunked_cuda(x, dt, A, Bm, Cm, D,
                                                chunk=chunk,
                                                chunk_states=True)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, states)
        ctx.mark_non_differentiable(final)
        return y, final

    @staticmethod
    def backward(ctx, dy, _dfinal):
        x, dt, A, Bm, Cm, D, states = ctx.saved_tensors
        if x.device.type == "cpu":
            grads = _ref.ssd_chunked_bwd_ref(x, dt, A, Bm, Cm, D, dy, states,
                                             chunk=ctx.chunk)
        else:
            grads = ssd_chunked_bwd_cuda(x, dt, A, Bm, Cm, D, dy, states,
                                         chunk=ctx.chunk)
        dx, ddt, dA, dB, dC, dD = grads
        return (dx, ddt.to(dt.dtype), dA.to(A.dtype), dB.to(Bm.dtype),
                dC.to(Cm.dtype), dD.to(D.dtype), None)


def ssd_chunked_bwd_cuda(x, dt, A, Bm, Cm, D, dy, states, *,
                         chunk: int = 128):
    """The backward kernel (``csrc/ssd_bwd.cu``, launched as
    :func:`ssd_bwd_plan` says), from a zero initial state with no gradient
    into the final state: (dx, ddt, dA, dB, dC, dD), dx, dB and dC in x's
    dtype, the rest fp32.  ``states`` are the forward's chunk start
    states."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd backward kernel needs a CUDA tensor, got "
                         f"{x.device}")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    plan = ssd_bwd_plan(b, s, h, chunk, p, g, n, x.dtype)
    if (dt.shape != (b, s, h) or Bm.shape != (b, s, g, n)
            or Cm.shape != Bm.shape or dy.shape != x.shape
            or states.shape != (b, h, s // chunk, p, n)):
        raise ValueError("bad ssd backward shapes")
    code = build.dtype_code(x.dtype)
    f32 = dict(dtype=torch.float32, device=x.device)
    ins = [x.contiguous(), dt.float().contiguous(), A.float().contiguous(),
           Bm.to(x.dtype).contiguous(), Cm.to(x.dtype).contiguous(),
           D.float().contiguous(), dy.to(x.dtype).contiguous(),
           states.float().contiguous()]
    # the tensor-core passes read x, B, C, dy and the states in 16 bytes
    for i in (0, 3, 4, 6, 7):
        if ins[i].data_ptr() % 16:
            ins[i] = ins[i].clone()
    dx = torch.empty_like(ins[0])
    dB, dC = torch.empty_like(ins[3]), torch.empty_like(ins[4])
    ddt = torch.empty((b, s, h), **f32)
    dA, dD = torch.empty((h,), **f32), torch.empty((h,), **f32)
    scratch = [torch.empty(shape, **f32) for shape in plan.scratch]
    rc = build.library().repro_ssd_bwd(
        *[t.data_ptr() for t in ins],
        *[t.data_ptr() for t in (dx, ddt, dA, dB, dC, dD)],
        *[t.data_ptr() if t.numel() else None for t in scratch],
        b, s, h, p, g, n, chunk, code, build.stream_ptr(x.device))
    build.check(rc, "repro_ssd_bwd")
    ssd_chunked_bwd_cuda.launches += 1
    return dx, ddt, dA, dB, dC, dD


ssd_chunked_bwd_cuda.launches = 0


def ssd_chunked_raw(x, dt_raw, dt_bias, A_log, Bm, Cm, D, *,
                    chunk: int = 128,
                    initial_state: Optional[torch.Tensor] = None,
                    out_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw-dt entry point: softplus(dt_raw + dt_bias) and -exp(A_log) in
    plain torch, then the scan."""
    with scope("ssd_core"):
        dt, A = _ref.preprocess_dt_A(dt_raw, dt_bias, A_log)
    return ssd_chunked(x, dt, A, Bm, Cm, D, chunk=chunk,
                       initial_state=initial_state, out_state=out_state)
