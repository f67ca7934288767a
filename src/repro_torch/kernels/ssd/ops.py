"""Chunked SSD scan: the device picks the path.

A CPU tensor runs the plain ``ssd_chunked_ref``; a CUDA tensor launches
the hand-written kernel (``csrc/ssd.cu``) or raises.  The ``softplus`` and
``-exp(A_log)`` preprocessing stays plain torch here, outside the kernel,
as the reference keeps it outside its ``pallas_call``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd import ref as _ref

# (chunk, headdim, d_state) the kernel is instantiated for: mamba2-2.7b's,
# zamba2-2.7b's and the reduced test config's
SHAPES = {(128, 64, 128), (128, 64, 64), (16, 16, 16)}


def ssd_chunked(x, dt, A, Bm, Cm, D, *, chunk: int = 128,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y [B,S,H,P], final_state [B,H,P,N])."""
    if x.device.type == "cpu":
        return _ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=chunk,
                                    initial_state=initial_state)
    return ssd_chunked_cuda(x, dt, A, Bm, Cm, D, chunk=chunk,
                            initial_state=initial_state)


def ssd_chunked_cuda(x, dt, A, Bm, Cm, D, *, chunk: int = 128,
                     initial_state=None):
    if x.device.type != "cuda":
        raise ValueError(f"ssd kernel needs a CUDA tensor, got {x.device}")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if (chunk, p, n) not in SHAPES:
        raise ValueError(f"ssd kernel built for (chunk, P, N) in "
                         f"{sorted(SHAPES)}, got {(chunk, p, n)}")
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
    y = torch.empty_like(ins[0])
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    lib = build.library()
    rc = lib.repro_ssd_fwd(*[t.data_ptr() for t in ins], y.data_ptr(),
                           final.data_ptr(), b, s, h, p, g, n, chunk, code,
                           build.stream_ptr(x.device))
    build.check(rc, "repro_ssd_fwd")
    ssd_chunked.launches += 1
    return y, final


ssd_chunked.launches = 0


def ssd_chunked_raw(x, dt_raw, dt_bias, A_log, Bm, Cm, D, *,
                    chunk: int = 128,
                    initial_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw-dt entry point: softplus(dt_raw + dt_bias) and -exp(A_log) in
    plain torch, then the scan."""
    dt, A = _ref.preprocess_dt_A(dt_raw, dt_bias, A_log)
    return ssd_chunked(x, dt, A, Bm, Cm, D, chunk=chunk,
                       initial_state=initial_state)
