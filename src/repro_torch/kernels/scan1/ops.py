"""Mamba-1 selective scan: the device picks the path.

A CPU tensor runs the plain ``selective_scan_ref``; a CUDA tensor launches
the hand-written kernel (``csrc/scan1.cu``) or raises.  The softplus of
dt and ``-exp(A_log)`` stay plain torch in the model, outside the kernel,
as the reference keeps them outside its ``pallas_call``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.scan1 import ref as _ref

# d_state values the kernel is instantiated for
D_STATES = (8, 16)


def selective_scan(x, dt, A, Bm, Cm, D, *,
                   initial_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,C]; dt: [B,S,C] (post-softplus); A: [C,N]; Bm, Cm: [B,S,N];
    D: [C]; initial_state: [B,C,N].  Returns (y [B,S,C] in x's dtype,
    final state [B,C,N] fp32)."""
    if x.device.type == "cpu":
        return _ref.selective_scan_ref(x, dt, A, Bm, Cm, D, initial_state)
    return selective_scan_cuda(x, dt, A, Bm, Cm, D,
                               initial_state=initial_state)


def selective_scan_cuda(x, dt, A, Bm, Cm, D, *, initial_state=None):
    if x.device.type != "cuda":
        raise ValueError(f"selective scan kernel needs a CUDA tensor, got "
                         f"{x.device}")
    b, s, c = x.shape
    n = A.shape[-1]
    if n not in D_STATES:
        raise ValueError(f"selective scan kernel built for d_state in "
                         f"{D_STATES}, got {n}")
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
    y = torch.empty_like(ins[0])
    final = torch.empty((b, c, n), dtype=torch.float32, device=x.device)
    lib = build.library()
    rc = lib.repro_scan1_fwd(*[t.data_ptr() for t in ins], y.data_ptr(),
                             final.data_ptr(), b, s, c, n, code,
                             build.stream_ptr(x.device))
    build.check(rc, "repro_scan1_fwd")
    selective_scan.launches += 1
    return y, final


selective_scan.launches = 0
