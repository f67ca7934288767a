"""Prefill attention: the device picks the path.

A CPU tensor runs the plain ``attention_ref``; a CUDA tensor launches the
hand-written kernel (``csrc/flash.cu``) or raises.  The kernel reads q, k
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
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash import ref as _ref

# head_dim values the kernel is instantiated for: zamba2-2.7b's (80),
# llama3-8b's (128), gemma3-1b's (256) and the reduced test sizes
HEAD_DIMS = (16, 32, 80, 128, 256)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset=None,
                    kv_wrap=None, ring_len: Optional[int] = None
                    ) -> torch.Tensor:
    """q: [B, H, Sq, d]; k, v: [B, KVH, Skv, d] -> [B, H, Sq, d].
    ``q_offset`` (None, a scalar or [B] int32): query i of row b sits at
    absolute position ``q_offset[b] + i``.  ``kv_wrap`` (a scalar or [B])
    and ``ring_len`` select the ring layout."""
    check_ring(causal, window, kv_wrap, ring_len, k.shape[2])
    if q.device.type == "cpu":
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  q_offset=0 if q_offset is None
                                  else q_offset, kv_wrap=kv_wrap,
                                  ring_len=ring_len)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, kv_wrap=kv_wrap,
                                ring_len=ring_len)


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
                         kv_wrap=None, ring_len: Optional[int] = None):
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
    lib = build.library()
    rc = lib.repro_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        0 if qoff is None else qoff.data_ptr(),
        0 if wrap is None else wrap.data_ptr(), b, h, kvh, sq, skv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(causal), int(window or 0), int(ring_len or 0), code,
        build.stream_ptr(q.device))
    build.check(rc, "repro_flash_fwd")
    if wrap is None:
        flash_attention.launches += 1
    else:
        flash_attention.ring_launches += 1
    return o


flash_attention.launches = 0
flash_attention.ring_launches = 0
