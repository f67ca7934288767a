"""Decode attention: the device picks the path.

A CPU tensor runs the plain ``decode_attention_ref``; a CUDA tensor
launches the hand-written split-K kernel (``csrc/attn_decode.cu``) or
raises; a ``meta`` tensor (the static walk,
:mod:`repro_torch.core.op_analysis`) records one kernel and returns an
empty output.  It runs in the ``attn_core`` scope.  k and v are read through their strides (unit stride along
``d``), so a caller may pass ``cache.transpose(1, 2)`` of a bucket slice
of a ``[B, S, KV, d]`` cache and no copy is made.

The split count is chosen here for the card's SMs (132 on an H100 SXM,
``build.sm_count``):
``split_k = min(16, ceil(S / 64), ceil(2 * SMs / (B * KVH)))``, at least 1
— about two waves of blocks over the SMs, down to one 64-key tile per
split, and at most 16 splits, since the block that merges them loads
every split's partial at once.  Each split covers ``ceil(S / split_k)``
keys rounded up to the 64-key tile, so the last may be shorter and none
is empty.  At the four shapes the served models decode (B=4):
zamba2-2.7b (32 KV heads, a 2048-row bucket) 3 splits of 704 keys, 384
blocks; llama3-8b (8 KV heads) 8 of 256, 256 blocks; gemma3-1b's global
layers (1 KV head) 16 of 128, 64 blocks; its local layers' 512-slot
ring 8 of 64, 32 blocks.  A block holds its KV head's whole query group
(up to 16 heads), so the split rule does not depend on the group.  Splits
that start at or past a row's
``valid_len`` return at once; the kernel merges the live ones itself (one
launch per call), through a per-(row, KV head) ticket counter that it
leaves at zero.  The result is the same for every split count up to
rounding.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.op_analysis import kernel_cost
from repro_torch.core.scope import scope
from repro_torch.kernels import build
from repro_torch.kernels.attn_decode import ref as _ref
from repro_torch.kernels.flash.ops import (check_strided, row_vector,
                                          ticket_counters)
from repro_torch.kernels.grad import needs_grad, no_backward

# head_dim values the kernel is instantiated for: qwen2.5-0.5b's and
# llama3.2-1b's (64), zamba2-2.7b's (80), phi-3-mini's (96), llama3-8b's
# (128), gemma3-1b's (256) and the reduced test sizes
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
# query heads per KV head: one N tile of 8 queries up to 8, two up to 16
# (glm4-9b's 32 heads on 2 KV heads)
MAX_GROUP = 16
TILE = 64               # keys per split tile
MAX_SPLIT = 16          # splits the kernel merges


def split_layout(batch: int, kv_heads: int, seq: int,
                 split_k: Optional[int] = None) -> Tuple[int, int]:
    """(splits, keys per split): ``split_k`` splits, or the H100 rule's
    when None (module docstring), each a whole number of 64-key tiles."""
    if split_k is None:
        split_k = max(1, min(MAX_SPLIT, -(-seq // TILE),
                             -(-2 * build.sm_count() // (batch * kv_heads))))
    if not 1 <= split_k <= MAX_SPLIT:
        raise ValueError(f"split_k must be in [1, {MAX_SPLIT}], got "
                         f"{split_k}")
    per = -(-seq // split_k)
    split_len = -(-per // TILE) * TILE
    return -(-seq // split_len), split_len


def decode_attention(q, k, v, *, valid_len,
                     split_k: Optional[int] = None) -> torch.Tensor:
    """q: [B, H, d]; k, v: [B, KVH, S, d]; valid_len: a scalar or [B].
    ``split_k`` None takes the H100 rule (:func:`split_layout`)."""
    with scope("attn_core"):
        if q.device.type == "cpu":
            return _ref.decode_attention_ref(q, k, v, valid_len=valid_len)
        if q.device.type == "meta":
            o = torch.empty_like(q)
            # q.k and p.v over every key of the cache: 4 d FLOPs a key
            b, h, d = q.shape
            kernel_cost("decode_attention", 4.0 * b * h * d * k.shape[2],
                        (q, k, v), (o,))
            return o
        if needs_grad(q, k, v):
            raise no_backward("decode_attention", "decode attention")
        return decode_attention_cuda(q, k, v, valid_len=valid_len,
                                     split_k=split_k)


def decode_attention_cuda(q, k, v, *, valid_len,
                          split_k: Optional[int] = None):
    if q.device.type != "cuda":
        raise ValueError(f"decode attention kernel needs a CUDA tensor, got "
                         f"{q.device}")
    b, h, d = q.shape
    kvh, s = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"decode attention kernel built for head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if (k.shape != (b, kvh, s, d) or v.shape != k.shape or h % kvh
            or h // kvh > MAX_GROUP or s == 0):
        raise ValueError(f"bad decode attention shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    code = build.dtype_code(q.dtype)
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_strided(name, t)
    valid = row_vector(valid_len, b, q.device, "valid_len")
    nsplit, split_len = split_layout(b, kvh, s, split_k)
    g = h // kvh
    o = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    part_acc = part_ml = tickets = None
    if nsplit > 1:
        part_acc = torch.empty((b, kvh, nsplit, g, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((b, kvh, nsplit, g, 2), dtype=torch.float32,
                              device=q.device)
        tickets = ticket_counters(q.device, b * kvh)
    lib = build.library()
    rc = lib.repro_decode_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        o.data_ptr(), 0 if part_acc is None else part_acc.data_ptr(),
        0 if part_ml is None else part_ml.data_ptr(),
        0 if tickets is None else tickets.data_ptr(), b, h, kvh, s, d,
        nsplit, split_len, *q.stride()[:2], *k.stride()[:3],
        *v.stride()[:3], code, build.stream_ptr(q.device))
    build.check(rc, "repro_decode_attn_fwd")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
