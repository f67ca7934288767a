"""Mamba-1 selective scan: the device picks the path.

A CPU tensor runs the plain ``selective_scan_ref``; a CUDA tensor launches
the hand-written kernel (``csrc/scan1.cu``) as :func:`scan1_plan` says,
or raises; a ``meta`` tensor (the static walk,
:mod:`repro_torch.core.op_analysis`) records one kernel and returns empty
outputs.  It runs in the ``ssm_core`` scope.  The softplus of dt and ``-exp(A_log)`` stay plain torch in
the model, outside the kernel, as the reference keeps them outside its
``pallas_call``.

A call that needs a gradient (:mod:`repro_torch.kernels.grad`) from a
zero initial state and without ``out_state`` (a training forward) runs
:class:`ScanFn`: the forward kernel and the backward kernel
(``csrc/scan1_bwd.cu``, :func:`scan1_bwd_plan`) on the card, the plain
versions on the CPU.  One with an initial state or a destination raises
on the card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.op_analysis import kernel_cost
from repro_torch.core.scope import scope
from repro_torch.kernels import build
from repro_torch.kernels.grad import needs_grad, no_backward
from repro_torch.kernels.scan1 import ref as _ref

# d_state values the kernel is instantiated for
D_STATES = (8, 16)
# the kernel's plans, by number (``csrc/scan1.cu``, launch_plan): steps a
# lane K, channels a block CT (a warp a channel), states a group G
PLANS = ((8, 4, 2), (8, 8, 2))


class Scan1Plan(NamedTuple):
    """How one call is cut into blocks: ``index`` the kernel's plan
    number; ``steps`` a lane (a tile is 32 of them), ``channels`` a block
    (one warp each); ``ldc`` the row length the kernel reads (C rounded up
    to 8); ``blocks``, ``threads`` a block and ``smem_bytes`` of dynamic
    shared memory a block."""
    index: int
    steps: int
    channels: int
    ldc: int
    blocks: int
    threads: int
    smem_bytes: int


def _smem(esz: int, n: int, k: int, ct: int) -> int:
    """Bytes of ``csrc/scan1.cu``'s Layout: two stages of x and dt tiles
    (32 k rows, each run of k rows followed by 16 bytes), B's and C's
    rows as they arrive and cooked (runs of k rows and one word), and the
    y values (runs of k rows of ct floats and one word)."""
    wx, wd, wb = ct * esz, ct * 4, n * esz
    stage = 32 * (k * wx + 16) + 32 * (k * wd + 16)
    return (2 * stage + 2 * 32 * k * wb + 2 * 128 * (k * wb // 4 + 1)
            + 128 * (k * ct + 1))


def scan1_plan(b: int, s: int, c: int, n: int, dtype) -> Scan1Plan:
    """The launch plan, from shapes only: blocks of 8 channels of one
    batch row, a warp a channel, where that gives at least three blocks
    an SM (mamba-130m's served chunk, B=4: 768 blocks); else blocks of 4
    channels, so that B=1 at 1536 channels gives 384 blocks, not 192 on
    132 SMs.  (Two warps a channel, each scanning half of the states, was
    no faster at either: ``kernel_variants.py scan1_plans``.)"""
    if n not in D_STATES:
        raise ValueError(f"selective scan kernel built for d_state in "
                         f"{D_STATES}, got {n}")
    esz = build.dtype_size(dtype)
    ldc = -(-c // 8) * 8
    sms = build.sm_count()
    index = 1 if b * ldc >= 3 * sms * 8 else 0
    k, ct, _ = PLANS[index]
    return Scan1Plan(index, k, ct, ldc, b * -(-ldc // ct), 32 * ct,
                     _smem(esz, n, k, ct))


def selective_scan(x, dt, A, Bm, Cm, D, *,
                   initial_state: Optional[torch.Tensor] = None,
                   out_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,C]; dt: [B,S,C] (post-softplus); A: [C,N]; Bm, Cm: [B,S,N];
    D: [C]; initial_state: [B,C,N].  Returns (y [B,S,C] in x's dtype,
    final state [B,C,N] fp32).  ``out_state`` (a contiguous, 16-byte
    aligned fp32 [B,C,N], e.g. a cache slot, apart from the other inputs;
    it may be the initial state) receives the final state and is returned
    as it."""
    with scope("ssm_core"):
        if x.device.type == "cpu":
            if (needs_grad(x, dt, A, Bm, Cm, D) and initial_state is None
                    and out_state is None):
                return ScanFn.apply(x, dt, A, Bm, Cm, D)
            return _ref.selective_scan_ref(x, dt, A, Bm, Cm, D,
                                           initial_state,
                                           out_state=out_state)
        if x.device.type == "meta":
            b, s, c = x.shape
            n = A.shape[-1]
            y = torch.empty_like(x)
            final = out_state if out_state is not None else torch.empty(
                (b, c, n), dtype=torch.float32, device=x.device)
            # per state and step: the exponential, dt*A, h*dA + (dt*x)*B,
            # C.h (7); per step dt*x, D*x, their sum (3)
            kernel_cost("selective_scan", 7.0 * b * s * c * n + 3.0 * b * s * c,
                        (x, dt, A, Bm, Cm, D, initial_state), (y, final))
            return y, final
        if needs_grad(x, dt, A, Bm, Cm, D, initial_state):
            if initial_state is None and out_state is None:
                return ScanFn.apply(x, dt, A, Bm, Cm, D)
            raise no_backward("selective_scan", "an initial state or a "
                              "destination")
        return selective_scan_cuda(x, dt, A, Bm, Cm, D,
                                   initial_state=initial_state,
                                   out_state=out_state)


def selective_scan_cuda(x, dt, A, Bm, Cm, D, *, initial_state=None,
                        out_state=None):
    if x.device.type != "cuda":
        raise ValueError(f"selective scan kernel needs a CUDA tensor, got "
                         f"{x.device}")
    b, s, c = x.shape
    n = A.shape[-1]
    plan = scan1_plan(b, s, c, n, x.dtype)
    if (dt.shape != (b, s, c) or A.shape != (c, n) or D.shape != (c,)
            or Bm.shape != (b, s, n) or Cm.shape != (b, s, n)
            or b == 0 or s == 0 or c == 0):
        raise ValueError(f"bad selective scan shapes x{tuple(x.shape)} "
                         f"dt{tuple(dt.shape)} A{tuple(A.shape)} "
                         f"B{tuple(Bm.shape)} C{tuple(Cm.shape)} "
                         f"D{tuple(D.shape)}")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError("x, B and C must share one dtype")
    code = build.dtype_code(x.dtype)
    if initial_state is None:
        initial_state = torch.zeros((b, c, n), dtype=torch.float32,
                                    device=x.device)
    if initial_state.shape != (b, c, n):
        raise ValueError(f"initial_state {tuple(initial_state.shape)} != "
                         f"{(b, c, n)}")
    # the plain version reads dt, A, D and the state in fp32
    ins = [x.contiguous(), dt.float().contiguous(), A.float().contiguous(),
           Bm.contiguous(), Cm.contiguous(), D.float().contiguous(),
           initial_state.float().contiguous()]
    if any(t.device != x.device for t in ins):
        raise ValueError("all selective scan inputs must be on one device")
    # the kernel stages x, dt, B and C in 8- and 16-byte pieces, x and dt
    # in rows ldc long
    pad = plan.ldc - c
    for i in (0, 1, 3, 4):
        if i < 2 and pad:
            ins[i] = torch.nn.functional.pad(ins[i], (0, pad))
        elif ins[i].data_ptr() % 16:
            ins[i] = ins[i].clone()
    y = torch.empty((b, s, plan.ldc), dtype=x.dtype, device=x.device)
    # each warp reads its own states of initial_state before it writes
    # them, and every block reads the other inputs
    final = build.destination(out_state, ins[6], "out_state", ins[:6])
    lib = build.library()
    rc = lib.repro_scan1_fwd(*[t.data_ptr() for t in ins], y.data_ptr(),
                             final.data_ptr(), b, s, c, plan.ldc, n,
                             plan.index, code, build.stream_ptr(x.device))
    build.check(rc, "repro_scan1_fwd")
    selective_scan.launches += 1
    return (y[..., :c].contiguous() if pad else y), final


selective_scan.launches = 0


class ScanFn(torch.autograd.Function):
    """The selective scan from a zero initial state with its backward:
    the kernels on the card, the plain versions on the CPU.  Returns (y,
    final state); both take a gradient."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D):
        if x.device.type == "cpu":
            y, final = _ref.selective_scan_ref(x, dt, A, Bm, Cm, D)
        else:
            y, final = selective_scan_cuda(x, dt, A, Bm, Cm, D)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D)
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, Bm, Cm, D = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        if x.device.type == "cpu":
            return _ref.selective_scan_bwd_ref(x, dt, A, Bm, Cm, D, dy,
                                               dfinal)
        return selective_scan_bwd_cuda(x, dt, A, Bm, Cm, D, dy, dfinal)


# the backward's plan (``csrc/scan1_bwd.cu``): steps a lane (a tile is 32
# of them), states a group, channels a block (a warp each) by element
# size: 16 in bf16, 8 in fp32
BWD_STEPS, BWD_GROUP = 8, 2
BWD_CHANNELS = {2: 16, 4: 8}
BWD_TILE = 32 * BWD_STEPS


class Scan1BwdPlan(NamedTuple):
    """How one backward call is cut: ``tile`` steps (32 lanes' runs of 8;
    the first launch keeps h where each run starts), ``channels`` a
    block of one batch row, ``ldc`` the row length the kernels read (C
    rounded up to a block's channels, zeros past C), ``blocks`` of each
    scan launch,
    ``tiles``, ``partials`` (channel blocks a batch row: the fp32
    partials of dB and dC a (batch row, step)), ``smem_bytes`` of dynamic
    shared memory a block of the states pass and of the backward pass,
    and ``scratch``, the elements of the one fp32 scratch: h where each
    lane's 8 steps start [B, tiles, ldc, N, 32], dA and dD partials a
    batch row [B, ldc, N] and [B, ldc], and the dB and dC partials [B,
    partials, 2, N, S]."""
    tile: int
    channels: int
    ldc: int
    blocks: int
    tiles: int
    partials: int
    smem_bytes: Tuple[int, int]
    scratch: int


def _bwd_smem(esz: int, n: int, ct: int) -> Tuple[int, int]:
    """Bytes of ``csrc/scan1_bwd.cu``'s StatesLayout and BwdLayout: two
    stages of the x (and dy) and dt runs (K rows each, then 16 bytes), B
    (and C) raw and cooked (runs of K rows and a word); the backward
    pass also each warp's dB / dC contributions of a group (runs of K + 1
    words)."""
    k, g = BWD_STEPS, BWD_GROUP
    run_x, run_d = k * ct * esz + 16, k * ct * 4 + 16
    raw, cooked = BWD_TILE * n * esz, 128 * (k * n * esz // 4 + 1)
    states = 2 * 32 * (run_x + run_d) + raw + cooked
    bwd = (2 * 32 * (2 * run_x + run_d) + 2 * (raw + cooked)
           + ct * 2 * g * 32 * (k + 1) * 4)
    return states, bwd


def scan1_bwd_plan(b: int, s: int, c: int, n: int,
                   dtype=torch.bfloat16) -> Scan1BwdPlan:
    if n not in D_STATES:
        raise ValueError(f"selective scan backward built for d_state in "
                         f"{D_STATES}, got {n}")
    esz = build.dtype_size(dtype)
    ct = BWD_CHANNELS[esz]
    ldc = -(-c // ct) * ct
    tiles = -(-s // BWD_TILE)
    nblk = ldc // ct
    return Scan1BwdPlan(BWD_TILE, ct, ldc, b * nblk, tiles, nblk,
                        _bwd_smem(esz, n, ct),
                        b * (tiles * ldc * n * 32 + ldc * n + ldc
                             + 2 * nblk * n * s))


def selective_scan_bwd_cuda(x, dt, A, Bm, Cm, D, dy, dfinal=None):
    """The backward kernels (``csrc/scan1_bwd.cu``) of the selective scan
    from a zero initial state: (dx, ddt, dA, dB, dC, dD), each in its
    input's dtype, from the forward's inputs, ``dy`` [B,S,C] and the
    final state's gradient ``dfinal`` ([B,C,N] or None).  Three launches
    (the forward's states where each lane's run starts, the backward
    scan, the fixed-order sums of the partials), one call; rows of x, dt
    and dy are padded with zeros to ``ldc`` where C is off a block's
    channels."""
    if x.device.type != "cuda":
        raise ValueError(f"selective scan backward kernel needs a CUDA "
                         f"tensor, got {x.device}")
    b, s, c = x.shape
    n = A.shape[-1]
    if (dt.shape != (b, s, c) or A.shape != (c, n) or D.shape != (c,)
            or Bm.shape != (b, s, n) or Cm.shape != (b, s, n)
            or dy.shape != (b, s, c)
            or (dfinal is not None and dfinal.shape != (b, c, n))):
        raise ValueError(f"bad selective scan backward shapes "
                         f"x{tuple(x.shape)} A{tuple(A.shape)}")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError("x, B and C must share one dtype")
    code = build.dtype_code(x.dtype)
    plan = scan1_bwd_plan(b, s, c, n, x.dtype)
    # the kernels stage x, dt, dy (rows ldc long), B and C in 16-byte
    # pieces
    pad = plan.ldc - c
    xc, dtf, dyc = (torch.nn.functional.pad(t.contiguous(), (0, pad))
                    if pad else t.contiguous()
                    for t in (x, dt.float(), dy.to(x.dtype)))
    xc, dtf, dyc, bc, cc = (t.clone() if t.data_ptr() % 16 else t
                            for t in (xc, dtf, dyc, Bm.contiguous(),
                                      Cm.contiguous()))
    Af, Df = (t.float().contiguous() for t in (A, D))
    dff = None if dfinal is None else dfinal.float().contiguous()
    scratch = torch.empty(plan.scratch, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(xc)
    ddt = torch.empty_like(dtf)
    dA, dD = torch.empty_like(Af), torch.empty_like(Df)
    dB, dC = torch.empty_like(bc), torch.empty_like(cc)
    rc = build.library().repro_scan1_bwd(
        xc.data_ptr(), dtf.data_ptr(), Af.data_ptr(), bc.data_ptr(),
        cc.data_ptr(), Df.data_ptr(), dyc.data_ptr(),
        0 if dff is None else dff.data_ptr(), scratch.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
        dC.data_ptr(), dD.data_ptr(), b, s, c, plan.ldc, n, code,
        build.stream_ptr(x.device))
    build.check(rc, "repro_scan1_bwd")
    selective_scan_bwd_cuda.launches += 1
    if pad:
        dx, ddt = dx[..., :c].contiguous(), ddt[..., :c].contiguous()
    return (dx, ddt.to(dt.dtype), dA.to(A.dtype), dB.to(Bm.dtype),
            dC.to(Cm.dtype), dD.to(D.dtype))


selective_scan_bwd_cuda.launches = 0
