"""Causal depthwise conv1d: the device picks the path.

A CPU tensor runs the plain version (:mod:`.ref`); a CUDA tensor launches
the hand-written kernel (``csrc/conv1d.cu``) or raises; a ``meta`` tensor
(the static walk, :mod:`repro_torch.core.op_analysis`) records one kernel
and returns empty outputs.  It runs in the ``conv1d`` scope.  Both also
give the new conv state: the ``K-1`` inputs that end each row's valid
prefix (``lengths``), which the kernel writes into ``out_state`` when
given.

A call that needs a gradient (:mod:`repro_torch.kernels.grad`) with SiLU
and no initial state, lengths or ``out_state`` (training's) runs
:class:`Conv1dFn`: the forward and backward kernels
(``csrc/conv1d_bwd.cu``) on the card, the plain versions on the CPU; any
other such call raises on the card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.op_analysis import kernel_cost
from repro_torch.core.scope import scope
from repro_torch.kernels import build
from repro_torch.kernels.conv1d import ref as _ref
from repro_torch.kernels.grad import needs_grad, no_backward

MAX_K = 4   # the kernel's register window is instantiated for K = 2 .. 4
# the backward kernel's blocks (csrc/conv1d_bwd.cu): one warp across 32
# vectors of channels, BWD_ROW_GROUPS warps down the rows, BWD_ROWS rows a
# thread; vectors of at most BWD_VEC_BYTES
BWD_ROWS = 16
BWD_ROW_GROUPS = 8
BWD_CHANNEL_THREADS = 32
BWD_VEC_BYTES = 8


class ConvBwdPlan(NamedTuple):
    """How one backward call is cut: ``vec`` channels a thread, ``rows``
    rows a thread, ``row_groups`` warps of a block down the rows; the
    ``grid`` (channel blocks, row tiles, batch rows); ``partials``, the
    shape of the fp32 scratch of per-block (dw, db) sums: one partial a
    block, (B x row tiles, C, K + 1)."""
    vec: int
    rows: int
    row_groups: int
    grid: Tuple[int, int, int]
    partials: Tuple[int, int, int]


def conv1d_bwd_plan(b: int, s: int, c: int, k: int, dtype,
                    align: int = 16) -> ConvBwdPlan:
    """The backward's launch plan, from shapes only: the widest vector of
    at most ``BWD_VEC_BYTES`` that divides C and ``align`` (the
    alignment in bytes common to x, dy and dx), as the forward picks
    its own; a block covers 32 vectors of channels and
    ``BWD_ROW_GROUPS * BWD_ROWS`` rows of one batch row."""
    es = torch.empty((), dtype=dtype).element_size()
    vec = max(1, BWD_VEC_BYTES // es)
    while vec > 1 and (c % vec or align % (vec * es)):
        vec //= 2
    tiles = -(-s // (BWD_ROW_GROUPS * BWD_ROWS))
    return ConvBwdPlan(vec, BWD_ROWS, BWD_ROW_GROUPS,
                       (-(-c // (BWD_CHANNEL_THREADS * vec)), tiles, b),
                       (b * tiles, c, k + 1))


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                  initial_state: Optional[torch.Tensor] = None,
                  activation: str = "silu",
                  lengths: Optional[torch.Tensor] = None,
                  out_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,C]; w: [C,K]; b: [C]; initial_state: [B,K-1,C]; lengths:
    [B] int, each row's valid prefix (None: every row is full).  Returns
    (y [B,S,C] in x's dtype, new state [B,K-1,C] in x's dtype: rows
    ``lengths[b] .. lengths[b] + K - 2`` of ``[initial_state; x]``).
    ``out_state`` (a contiguous tensor of that shape and type, e.g. a slot
    of a new cache, apart from x and initial_state) receives the new
    state and is returned as it."""
    with scope("conv1d"):
        if needs_grad(x, w, b, initial_state) and x.device.type != "meta":
            if (initial_state is None and lengths is None
                    and out_state is None and activation == "silu"):
                k = w.shape[-1]
                y = Conv1dFn.apply(x, w, b)
                # the new conv state, which training does not read
                state = torch.cat([x.new_zeros((x.shape[0], k - 1,
                                                x.shape[2])), x.detach()],
                                  dim=1)[:, x.shape[1]:]
                return y, state
            if x.device.type == "cuda":
                raise no_backward("causal_conv1d", "an initial state, valid "
                                  "lengths or a state destination")
        if x.device.type == "cpu":
            return _ref.causal_conv1d_ref(x, w, b, initial_state, activation,
                                          lengths=lengths,
                                          out_state=out_state)
        if x.device.type == "meta":
            bsz, s, c = x.shape
            k = w.shape[-1]
            y = torch.empty_like(x)
            state = out_state if out_state is not None else torch.empty(
                (bsz, k - 1, c), dtype=x.dtype, device=x.device)
            kernel_cost("causal_conv1d", 2.0 * k * bsz * s * c,
                        (x, w, b, initial_state, lengths), (y, state))
            return y, state
        return causal_conv1d_cuda(x, w, b, initial_state=initial_state,
                                  activation=activation, lengths=lengths,
                                  out_state=out_state)


def causal_conv1d_cuda(x, w, b, *, initial_state=None, activation="silu",
                       lengths=None, out_state=None):
    if x.device.type != "cuda":
        raise ValueError(f"causal_conv1d kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if activation != "silu":
        raise ValueError(f"kernel implements silu only, got {activation!r}")
    bsz, s, c = x.shape
    k = w.shape[-1]
    if w.shape != (c, k) or b.shape != (c,) or not 2 <= k <= MAX_K:
        raise ValueError(f"bad conv shapes x{tuple(x.shape)} w{tuple(w.shape)}"
                         f" b{tuple(b.shape)} (K must be 2..{MAX_K})")
    if initial_state is None:
        initial_state = x.new_zeros((bsz, k - 1, c))
    if initial_state.shape != (bsz, k - 1, c):
        raise ValueError(f"initial_state {tuple(initial_state.shape)} != "
                         f"{(bsz, k - 1, c)}")
    if lengths is not None:
        if lengths.shape != (bsz,):
            raise ValueError(f"lengths {tuple(lengths.shape)} != ({bsz},)")
        lengths = lengths.to(torch.int32).contiguous()
    for t in (w, b, initial_state) + ((lengths,) if lengths is not None
                                      else ()):
        if t.device != x.device:
            raise ValueError("all conv1d inputs must be on one device")
    code = build.dtype_code(x.dtype)
    x = x.contiguous()
    # the plain version reads w, b in fp32 and the state in x's dtype
    w32, b32 = w.float().contiguous(), b.float().contiguous()
    init = initial_state.to(x.dtype).contiguous()
    y = torch.empty_like(x)
    # the kernel narrows its vectors to the addresses it is given
    state = build.destination(out_state, init, "out_state", (x, init),
                              align=x.element_size())
    lib = build.library()
    rc = lib.repro_conv1d_fwd(
        x.data_ptr(), w32.data_ptr(), b32.data_ptr(), init.data_ptr(),
        None if lengths is None else lengths.data_ptr(), y.data_ptr(),
        state.data_ptr(), bsz, s, c, k, code, build.stream_ptr(x.device))
    build.check(rc, "repro_conv1d_fwd")
    causal_conv1d.launches += 1
    return y, state


causal_conv1d.launches = 0


class Conv1dFn(torch.autograd.Function):
    """conv1d with SiLU from zeros, ``y = silu(conv(x, w) + b)``, with its
    backward: the kernels on the card, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        if x.device.type == "cpu":
            return _ref.causal_conv1d_ref(x, w, b)[0]
        return causal_conv1d_cuda(x, w, b)[0]

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dw, db = _ref.causal_conv1d_bwd_ref(x, w, b, dy)
        else:
            dx, dw, db = causal_conv1d_bwd_cuda(x, w, b, dy)
        return dx, dw.to(w.dtype), db.to(b.dtype)


def causal_conv1d_bwd_cuda(x, w, b, dy):
    """The backward kernel (``csrc/conv1d_bwd.cu``, cut as
    :func:`conv1d_bwd_plan` says; two launches: the walk, then the fixed-
    order sum of its partials): (dx in x's dtype, dw [C,K] fp32, db [C]
    fp32) for SiLU and no initial state."""
    if x.device.type != "cuda":
        raise ValueError(f"conv1d backward kernel needs a CUDA tensor, got "
                         f"{x.device}")
    bsz, s, c = x.shape
    k = w.shape[-1]
    if (w.shape != (c, k) or b.shape != (c,) or dy.shape != x.shape
            or not 2 <= k <= MAX_K):
        raise ValueError(f"bad conv backward shapes x{tuple(x.shape)} "
                         f"w{tuple(w.shape)} dy{tuple(dy.shape)}")
    code = build.dtype_code(x.dtype)
    x = x.contiguous()
    dy = dy.to(x.dtype).contiguous()
    w32, b32 = w.float().contiguous(), b.float().contiguous()
    dx = torch.empty_like(x)
    dw = torch.empty((c, k), dtype=torch.float32, device=x.device)
    db = torch.empty((c,), dtype=torch.float32, device=x.device)
    addrs = x.data_ptr() | dy.data_ptr() | dx.data_ptr()
    plan = conv1d_bwd_plan(bsz, s, c, k, x.dtype, align=addrs & -addrs
                           if addrs % 16 else 16)
    part = torch.empty(plan.partials, dtype=torch.float32, device=x.device)
    rc = build.library().repro_conv1d_bwd(
        x.data_ptr(), w32.data_ptr(), b32.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), dw.data_ptr(), db.data_ptr(), part.data_ptr(), bsz, s,
        c, k, plan.vec, plan.rows, code, build.stream_ptr(x.device))
    build.check(rc, "repro_conv1d_bwd")
    causal_conv1d_bwd_cuda.launches += 1
    return dx, dw, db


causal_conv1d_bwd_cuda.launches = 0
