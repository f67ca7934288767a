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

``decode_attention_partials`` runs the same kernel in its partials mode
(one launch, its own counter): each (row, query head)'s unnormalised
fp32 sum of p * v and its (m, l) over this call's keys, the splits
merged but not normalised.  A sharded cache's ranks each run it over
their own rows and merge the partials with :func:`ref.merge_partials`
(:mod:`repro_torch.kernels.sharded`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

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
    ``split_k`` None takes the H100 rule (:func:`split_layout`).  DTensor
    inputs run on their shards (:mod:`repro_torch.kernels.sharded`)."""
    if isinstance(q, DTensor) or isinstance(k, DTensor):
        from repro_torch.kernels import sharded
        return sharded.decode_attention(decode_attention, q, k, v,
                                        valid_len=valid_len, split_k=split_k,
                                        partials=decode_attention_partials)
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


def decode_attention_partials(q, k, v, *, valid_len,
                              split_k: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The partials of :func:`decode_attention` over these keys: (acc
    [B, H, d], m [B, H], l [B, H]), all fp32: acc the unnormalised sum of
    p * v, m the running max of the scaled scores (-1e30 where a row has
    no live key) and l the sum of p = exp(score - m).  A CPU tensor runs
    ``decode_attention_partials_ref``, a CUDA tensor the kernel's partials
    mode, or raises."""
    with scope("attn_core"):
        if q.device.type == "cpu":
            return _ref.decode_attention_partials_ref(q, k, v,
                                                      valid_len=valid_len)
        if q.device.type == "meta":
            b, h, d = q.shape
            acc = torch.empty((b, h, d), dtype=torch.float32,
                              device=q.device)
            m, l = (torch.empty((b, h), dtype=torch.float32,
                                device=q.device) for _ in range(2))
            kernel_cost("decode_attention_partials",
                        4.0 * b * h * d * k.shape[2], (q, k, v), (acc, m, l))
            return acc, m, l
        if needs_grad(q, k, v):
            raise no_backward("decode_attention_partials",
                              "decode attention")
        return _launch(decode_attention_partials, q, k, v,
                       valid_len=valid_len, split_k=split_k, partials=True)


def decode_attention_cuda(q, k, v, *, valid_len,
                          split_k: Optional[int] = None):
    return _launch(decode_attention, q, k, v, valid_len=valid_len,
                   split_k=split_k, partials=False)


def _launch(wrapper, q, k, v, *, valid_len, split_k, partials: bool):
    """One launch of the kernel: the output in q's dtype, or in partials
    mode (acc, m, l) in fp32; counted on ``wrapper``."""
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
    o = acc = ml = None
    if partials:
        acc = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
        ml = torch.empty((b, h, 2), dtype=torch.float32, device=q.device)
    else:
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
        0 if o is None else o.data_ptr(),
        0 if acc is None else acc.data_ptr(),
        0 if ml is None else ml.data_ptr(),
        0 if part_acc is None else part_acc.data_ptr(),
        0 if part_ml is None else part_ml.data_ptr(),
        0 if tickets is None else tickets.data_ptr(), b, h, kvh, s, d,
        nsplit, split_len, *q.stride()[:2], *k.stride()[:3],
        *v.stride()[:3], code, build.stream_ptr(q.device))
    build.check(rc, "repro_decode_attn_fwd")
    wrapper.launches += 1
    return (acc, ml[..., 0], ml[..., 1]) if partials else o


decode_attention.launches = 0
decode_attention_partials.launches = 0
