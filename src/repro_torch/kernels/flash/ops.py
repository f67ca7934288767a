"""Prefill attention: the device picks the path.

A CPU tensor runs the plain ``attention_ref``; a CUDA tensor launches the
hand-written kernel (``csrc/flash.cu``) or raises; a ``meta`` tensor (the
static walk, :mod:`repro_torch.core.op_analysis`) records one kernel and
returns an empty output.  It runs in the ``attn_core`` scope.  The kernel reads q, k
and v through their strides (unit stride along ``d``), so a caller may
pass ``cache.transpose(1, 2)`` of a bucket slice of a ``[B, S, KV, d]``
cache and no copy is made.

``kv_wrap`` ([B] cursors) and ``ring_len`` select the ring layout of a
chunked prefill over a rolling sliding-window cache (``flash.ref``'s
module docstring): the first ``ring_len`` key slots are a ring with
modulus ``window``, the rest the in-flight chunk.  As in the Pallas
kernel, the ring needs ``causal``, a ``window`` and ``kv_wrap``.  Ring
launches are counted apart from plain ones:
``flash_attention.ring_launches`` and ``flash_attention.launches``.

Each launch follows :func:`flash_plan`, from shapes only: bf16 runs the
``wgmma`` + TMA kernel (Q and K padded to 64, 128 or 256 columns, Q K^T
over the d / 16 k-steps that hold data, P V at N = d for d = 80 and 96)
with a GQA group's query heads packed into one block's 128 rows (192 where
that pads no more rows, at d = 64 to 96) and, when that
leaves fewer blocks than the card's SMs (132 on an H100 SXM,
``build.sm_count``), each query tile's keys split
across blocks (gemma3-1b's chunk: 32 tiles x 4 splits); fp32 runs on CUDA
cores.  Either way one call is one launch.

A call that needs a gradient (:mod:`repro_torch.kernels.grad`) over a
full sequence (no offsets or ring; Sq = Skv; a head_dim in
``BWD_HEAD_DIMS`` on the card), causal, causal in a window or non-causal
without one, runs :class:`FlashFn`: the forward kernel, which also
writes each row's log-sum-exp, and the backward kernels
(``csrc/flash_bwd.cu``, one call of three launches as
:func:`flash_bwd_plan` says: wgmma in bf16 at head dims 64 to 256, CUDA
cores otherwise) on the card; the plain versions on the CPU.  Any other
such call (the ring and offset modes of chunked serving, a non-causal
window) raises on the card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.op_analysis import kernel_cost
from repro_torch.core.scope import scope
from repro_torch.kernels import build
from repro_torch.kernels.flash import ref as _ref
from repro_torch.kernels.grad import needs_grad, no_backward

# head_dim values the kernel is instantiated for: qwen2.5-0.5b's and
# llama3.2-1b's (64), zamba2-2.7b's (80), phi-3-mini's (96), llama3-8b's
# (128), gemma3-1b's (256) and the reduced test sizes
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
BLOCK_ROWS = 128               # query rows a wgmma block
WIDE_ROWS = 192                # ... with three consumer warpgroups
WIDE_HEAD_DIMS = (64, 80, 96)   # the head dims built with them
KEY_TILE = 64                  # keys a tile
MAX_SPLIT = 8                  # key splits of a query tile
MIN_SPLIT_TILES = 2            # KV tiles an active key split takes
BWD_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)   # the backward's instances
BWD_WGMMA_HEAD_DIMS = (64, 80, 96, 128, 256)   # its wgmma instances (bf16)
BWD_STAGES = 4                 # depth of the backward's streamed ring


class FlashPlan(NamedTuple):
    """How one call is cut into blocks: ``route`` "wgmma" (bf16) or
    "fp32"; ``heads_packed``
    query heads of one KV head share a block's ``rows`` query rows,
    ``positions`` query positions each; ``q_tiles`` x ``head_groups`` x B
    query tiles, each cut into ``splits`` key splits; ``blocks`` in
    all."""
    route: str
    heads_packed: int
    positions: int
    q_tiles: int
    head_groups: int
    splits: int
    blocks: int
    rows: int = BLOCK_ROWS


def flash_plan(b: int, h: int, kvh: int, sq: int, skv: int, d: int,
               dtype, *, heads_packed: Optional[int] = None,
               splits: Optional[int] = None, ring: bool = False,
               rows: Optional[int] = None) -> FlashPlan:
    """The launch plan, from shapes only.  On the wgmma route a block
    holds 128 query rows: the G = H / KVH heads of one KV head packed
    together (G of 1, 2, 4 or 8; one head otherwise), 128 / G positions
    each, so each K/V tile is loaded once for the group.  When the query
    tiles number fewer than the 132 SMs, the keys of each are split into
    ``min(8, 132 // tiles, ceil(Skv / 64))`` ranges of whole 64-key tiles,
    of which the kernel uses as many as the masks leave two tiles each
    (:func:`key_split`), merged exactly by the block that finishes last
    (``SMS`` is ``build.sm_count()``: 132 on an H100 SXM).  A block
    holds 192 rows instead (three consumer warpgroups) at a head dim of
    ``WIDE_HEAD_DIMS`` in the plain layout when that pads no more query
    rows than 128 would and still gives every SM a tile: each K/V tile
    then serves 1.5x the rows (hubert-xlarge's 1500 frames: 8 tiles of
    192, not 12 of 128).  In fp32 a block is 16 rows of one head.
    ``heads_packed``, ``splits`` and ``rows`` force the wgmma route's
    choices (the card tests do); they must divide G and the rows, lie in
    [1, 8], and be 128 or 192."""
    if dtype == torch.bfloat16:
        g = h // kvh
        hp = heads_packed or (g if g in (1, 2, 4, 8) else 1)
        sms = build.sm_count()
        if rows is None:
            rows = BLOCK_ROWS
            tiles_wide = -(-sq * hp // WIDE_ROWS)
            if (d in WIDE_HEAD_DIMS and not ring and tiles_wide * WIDE_ROWS
                    <= -(-sq * hp // BLOCK_ROWS) * BLOCK_ROWS
                    and tiles_wide * (h // hp) * b >= sms):
                rows = WIDE_ROWS
        if rows not in (BLOCK_ROWS, WIDE_ROWS) or (
                rows == WIDE_ROWS and (d not in WIDE_HEAD_DIMS or ring)):
            raise ValueError(f"rows must be {BLOCK_ROWS}, or {WIDE_ROWS} at "
                             f"head_dim {WIDE_HEAD_DIMS} without a ring")
        if g % hp or rows % hp:
            raise ValueError(f"heads_packed {hp} must divide the group {g} "
                             f"and {rows}")
        npos = rows // hp
        qt = -(-sq // npos)
        tiles = qt * (h // hp) * b
        if splits is None:
            splits = 1
            if tiles < sms:
                splits = max(1, min(MAX_SPLIT, sms // tiles,
                                    -(-skv // KEY_TILE)))
        if not 1 <= splits <= MAX_SPLIT:
            raise ValueError(f"splits must be in [1, {MAX_SPLIT}], got "
                             f"{splits}")
        return FlashPlan("wgmma", hp, npos, qt, h // hp, splits,
                         tiles * splits, rows)
    if (heads_packed not in (None, 1) or splits not in (None, 1)
            or rows not in (None, BLOCK_ROWS)):
        raise ValueError("heads_packed, splits and rows apply to the wgmma "
                         "route (bf16)")
    rows = 16
    qt = -(-sq // rows)
    return FlashPlan("fp32", 1, rows, qt, h, 1, qt * h * b)


class FlashBwdPlan(NamedTuple):
    """How one backward call is cut: ``route`` "wgmma" (bf16 at a head dim
    of ``BWD_WGMMA_HEAD_DIMS``) or "cuda_cores"; ``blocks`` and
    ``smem_bytes`` (dynamic shared memory a block) of its three launches,
    in order (the row stats, dK/dV, dQ); ``scratch``, the shape of its
    one fp32 scratch (the stats: (lse log2 e, Dr) of each row, rows padded
    to a multiple of 128, on the wgmma route; Dr on CUDA cores)."""
    route: str
    blocks: Tuple[int, int, int]
    smem_bytes: Tuple[int, int, int]
    scratch: Tuple[int, ...]


def flash_bwd_plan(b: int, h: int, kvh: int, s: int, d: int,
                   dtype) -> FlashBwdPlan:
    """The backward's launch plan, from shapes only.  On the wgmma route
    (``csrc/flash_bwd.cu``, WBwdSmem) the row stats take a warp a padded
    row; a dK/dV block owns 128 keys of one KV head (K and V, 128 rows of
    d padded to 64 or 128 columns, in bf16, and a ring of ``BWD_STAGES``
    stages of 64 rows of Q and dO), a dQ block 128 rows of one head (Q
    and dO, and a ring of 64 keys of K and V); 1024 bytes align the
    tiles.  At d = 256 a block owns 64 keys (rows), its two warpgroups
    each accumulate half of the columns, and the ring is 2 stages deep.
    On CUDA cores (fp32, and d = 16 and 32) a block owns a 64-row tile
    (32 at d = 256), staged as fp32 rows padded by one element
    (BwdSmem).  The masks (causal, window, non-causal) change which tiles
    a block walks, not the plan."""
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"flash backward built for head_dim in "
                         f"{BWD_HEAD_DIMS}, got {d}")
    if h % kvh:
        raise ValueError(f"heads {h} must be a multiple of KV heads {kvh}")
    if dtype == torch.bfloat16 and d in BWD_WGMMA_HEAD_DIMS:
        dp = -(-d // 64) * 64
        rows, stages = (64, 2) if d > 128 else (128, BWD_STAGES)
        tiles = -(-s // rows)
        spad = -(-s // 128) * 128
        smem = 2 * rows * dp * 2 + stages * 2 * 64 * dp * 2 + 1024
        return FlashBwdPlan("wgmma", (-(-b * h * spad // 8), tiles * kvh * b,
                                      tiles * h * b), (0, smem, smem),
                            (b, h, spad, 2))
    tr = 32 if d > 128 else 64
    tiles = -(-s // tr)
    smem = 4 * (4 * tr * (d + 1) + 2 * tr * (tr + 1) + 2 * tr)
    return FlashBwdPlan("cuda_cores", (-(-b * h * s // 8), tiles * kvh * b,
                                       tiles * h * b), (0, smem, smem),
                        (b, h, s))


def key_split(n_tiles: int, splits: int, s: int) -> Tuple[int, int]:
    """Split ``s``'s range [lo, hi) of a query tile's ``n_tiles`` KV tiles
    (the tiles the masks leave it, in the kernel's order), as the kernel
    cuts them: the first ``max(1, min(splits, n_tiles // 2))`` splits share
    the tiles in contiguous ranges of at least two (sizes within one of
    each other); the rest get none and return at once."""
    active = max(1, min(splits, n_tiles // MIN_SPLIT_TILES))
    if s >= active:
        return n_tiles, n_tiles
    return n_tiles * s // active, n_tiles * (s + 1) // active


_TICKETS = {}
# counters replaced by larger ones: kept, since a captured CUDA graph reads
# the counters it was captured with
_RETIRED_TICKETS = []


def ticket_counters(device, n: int) -> torch.Tensor:
    """At least ``n`` int32 ticket counters on ``device``, zeroed once when
    made.  A split kernel (flash or decode attention) draws one ticket per
    split block, and the block that draws the last writes the counter back
    to zero, so the same counters serve every later call and every replay
    of a captured CUDA graph (none is ever freed).  Kernels on one stream
    only: two calls in flight at once would share them."""
    have = _TICKETS.get(device)
    if have is None or have.numel() < n:
        if have is not None:
            _RETIRED_TICKETS.append(have)
        have = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[device] = have
    return have


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset=None,
                    kv_wrap=None, ring_len: Optional[int] = None
                    ) -> torch.Tensor:
    """q: [B, H, Sq, d]; k, v: [B, KVH, Skv, d] -> [B, H, Sq, d].
    ``q_offset`` (None, a scalar or [B] int32): query i of row b sits at
    absolute position ``q_offset[b] + i``.  ``kv_wrap`` (a scalar or [B])
    and ``ring_len`` select the ring layout."""
    check_ring(causal, window, kv_wrap, ring_len, k.shape[2])
    with scope("attn_core"):
        if needs_grad(q, k, v) and q.device.type != "meta":
            if (q_offset is None and ring_len is None
                    and q.shape[2] == k.shape[2]
                    and (causal or window is None)
                    and (q.device.type == "cpu"
                         or q.shape[3] in BWD_HEAD_DIMS)):
                return FlashFn.apply(q, k, v, causal, window)
            if q.device.type == "cuda":
                raise no_backward("flash_attention", "its ring and offset "
                                  "modes or a non-causal window (or "
                                  f"head_dim {q.shape[3]})")
        if q.device.type == "cpu":
            return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                      q_offset=0 if q_offset is None
                                      else q_offset, kv_wrap=kv_wrap,
                                      ring_len=ring_len)
        if q.device.type == "meta":
            return _flash_meta(q, k, v, causal, window, q_offset, ring_len)
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, kv_wrap=kv_wrap,
                                    ring_len=ring_len)


def _flash_meta(q, k, v, causal, window, q_offset, ring_len):
    """One kernel in the static walk: q.k and p.v, 4 d FLOPs for each key a
    query sees.  Shapes alone give the keys: a one-shot causal prompt's
    query i sees i + 1 of them; with offsets (their values are data) or
    a ring, every key of the call, at most ``window``."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if causal and q_offset is None and ring_len is None and sq == skv:
        seen = sum(min(i + 1, window or skv) for i in range(sq))
    else:
        seen = sq * min(skv, window or skv)
    o = torch.empty((b, sq, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    name = "flash_attention" if ring_len is None else "flash_attention_ring"
    kernel_cost(name, 4.0 * b * h * d * seen, (q, k, v), (o,))
    return o


def check_ring(causal: bool, window: Optional[int], kv_wrap,
               ring_len: Optional[int], skv: int) -> None:
    """The Pallas kernel's contract (``kernel.py:144-146``): a ring needs
    causal attention, a window and ``kv_wrap``; ``ring_len`` fits the
    keys."""
    if kv_wrap is None and ring_len is None:
        return
    if not (causal and window is not None and kv_wrap is not None
            and ring_len is not None):
        raise ValueError("ring KV layout requires causal attention, a "
                         "window, kv_wrap and ring_len")
    if not 1 <= ring_len <= skv:
        raise ValueError(f"ring_len must be in [1, {skv}], got {ring_len}")


def check_strided(name: str, t: torch.Tensor) -> None:
    """The kernels' 16-byte loads: unit stride along the last dim, the
    other strides and the base aligned to 16 bytes."""
    per = 16 // t.element_size()
    if (t.stride(-1) != 1 or any(s % per for s in t.stride()[:-1])
            or t.data_ptr() % 16):
        raise ValueError(f"{name}: strides {t.stride()} are not 16-byte "
                         "aligned with a unit last stride")


def row_vector(x, b: int, device, name: str) -> torch.Tensor:
    """A scalar or [B] integer -> contiguous [B] int32 on ``device``."""
    t = torch.as_tensor(x, device=device)
    if t.dim() > 1 or (t.dim() == 1 and t.shape[0] not in (1, b)):
        raise ValueError(f"{name} must be a scalar or [{b}], got "
                         f"{tuple(t.shape)}")
    return t.to(torch.int32).reshape(-1).expand(b).contiguous()


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None, q_offset=None,
                         kv_wrap=None, ring_len: Optional[int] = None,
                         heads_packed: Optional[int] = None,
                         splits: Optional[int] = None,
                         rows: Optional[int] = None, lse: bool = False):
    """The kernel; ``heads_packed``, ``splits`` and ``rows`` override the
    plan's choices (:func:`flash_plan`).  ``lse`` returns (o, each query
    row's log-sum-exp of its scaled scores, fp32 [B, H, Sq])."""
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel needs a CUDA tensor, got {q.device}")
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernel built for head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if (k.shape != (b, kvh, skv, d) or v.shape != k.shape or h % kvh
            or sq == 0 or skv == 0):
        raise ValueError(f"bad flash shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    code = build.dtype_code(q.dtype)
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_strided(name, t)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    qoff = (None if q_offset is None
            else row_vector(q_offset, b, q.device, "q_offset"))
    wrap = (None if ring_len is None
            else row_vector(kv_wrap, b, q.device, "kv_wrap"))
    # [B, Sq, H, d] storage: the caller's layout after the projection
    o = torch.empty((b, sq, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    plan = flash_plan(b, h, kvh, sq, skv, d, q.dtype,
                      heads_packed=heads_packed, splits=splits,
                      ring=ring_len is not None, rows=rows)
    part_acc = part_ml = tickets = None
    if plan.splits > 1:
        tiles = plan.blocks // plan.splits
        part_acc = torch.empty((tiles, plan.splits, plan.rows, d),
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty((tiles, plan.splits, plan.rows, 2),
                              dtype=torch.float32, device=q.device)
        tickets = ticket_counters(q.device, tiles)
    lse_t = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
             if lse else None)
    lib = build.library()
    rc = lib.repro_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        0 if qoff is None else qoff.data_ptr(),
        0 if wrap is None else wrap.data_ptr(), b, h, kvh, sq, skv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(causal), int(window or 0), int(ring_len or 0),
        plan.heads_packed, plan.splits, plan.rows,
        0 if part_acc is None else part_acc.data_ptr(),
        0 if part_ml is None else part_ml.data_ptr(),
        0 if tickets is None else tickets.data_ptr(),
        0 if lse_t is None else lse_t.data_ptr(), code,
        build.stream_ptr(q.device))
    build.check(rc, "repro_flash_fwd")
    if wrap is None:
        flash_attention.launches += 1
    else:
        flash_attention.ring_launches += 1
    return (o, lse_t) if lse else o


flash_attention.launches = 0
flash_attention.ring_launches = 0


class FlashFn(torch.autograd.Function):
    """Attention over a full sequence (causal, causal in a window, or
    non-causal) with its backward: the kernels on the card, the plain
    versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.device.type == "cpu":
            o, lse = _ref.attention_lse_ref(q, k, v, causal=causal,
                                            window=window)
        else:
            o, lse = flash_attention_cuda(q, k, v, causal=causal,
                                          window=window, lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.masks = dict(causal=causal, window=window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = _ref.flash_bwd_ref(q, k, v, o, do, lse, **ctx.masks)
        else:
            grads = flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                             **ctx.masks)
        return (*grads, None, None)


def flash_attention_bwd_cuda(q, k, v, o, do, lse, *, causal: bool = True,
                             window: Optional[int] = None):
    """The backward kernels (``csrc/flash_bwd.cu``, launched as
    :func:`flash_bwd_plan` says) of attention over a full sequence, causal
    (in a ``window`` when given) or not: (dq [B,H,S,d], dk, dv
    [B,KVH,S,d]) in q's dtype, from the forward's output ``o`` and
    log-sum-exp ``lse`` ([B,H,S] fp32).  The operands are made contiguous
    first (a copy of a strided view)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash backward kernel needs a CUDA tensor, got "
                         f"{q.device}")
    b, h, s, d = q.shape
    kvh = k.shape[1]
    if (k.shape != (b, kvh, s, d) or v.shape != k.shape or h % kvh
            or o.shape != q.shape or do.shape != q.shape
            or lse.shape != (b, h, s)):
        raise ValueError(f"bad flash backward shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)}")
    if window is not None and (window < 1 or not causal):
        raise ValueError(f"the backward takes a window >= 1 with causal "
                         f"attention, got window {window}, causal {causal}")
    plan = flash_bwd_plan(b, h, kvh, s, d, q.dtype)
    code = build.dtype_code(q.dtype)
    q, k, v, o = (t.contiguous() for t in (q, k, v, o))
    do = do.to(q.dtype).contiguous()
    lse = lse.float().contiguous()
    scratch = torch.empty(plan.scratch, dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    rc = build.library().repro_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, kvh, s, d, int(causal),
        int(window or 0), code, build.stream_ptr(q.device))
    build.check(rc, "repro_flash_bwd")
    flash_attention_bwd_cuda.launches += 1
    flash_attention_bwd_cuda.mode_launches[
        "window" if window is not None
        else "causal" if causal else "noncausal"] += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
# the launches by mode, counted with ``launches``
flash_attention_bwd_cuda.mode_launches = dict.fromkeys(
    ("causal", "window", "noncausal"), 0)
