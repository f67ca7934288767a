"""Fused Mamba-2 decode step: the device picks the path.

One call is one Mamba-2 layer's whole per-token recurrence: the conv shift
step, SiLU, softplus(dt), the state update ``h' = h*exp(dt*A) + dt*B*x``
and the readout ``y = C.h' + D*x``.  A CPU tensor runs the plain version;
a CUDA tensor launches ``csrc/decode_fused.cu`` or raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_fused import ref as _ref


def mamba2_decode_fused(conv_state, ssm_state, xbc_t, conv_w, conv_b,
                        dt_raw, dt_bias, A_log, D, *, n_groups: int,
                        d_state: int, headdim: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (y [B,H,P] in xbc's dtype, conv window' [B,K-1,C],
    ssm' [B,H,P,N] fp32)."""
    if xbc_t.device.type == "cpu":
        return _ref.mamba2_decode_fused_ref(
            conv_state, ssm_state, xbc_t, conv_w, conv_b, dt_raw, dt_bias,
            A_log, D, n_groups=n_groups, d_state=d_state, headdim=headdim)
    return mamba2_decode_fused_cuda(
        conv_state, ssm_state, xbc_t, conv_w, conv_b, dt_raw, dt_bias,
        A_log, D, n_groups=n_groups, d_state=d_state, headdim=headdim)


def mamba2_decode_fused_cuda(conv_state, ssm_state, xbc_t, conv_w, conv_b,
                             dt_raw, dt_bias, A_log, D, *, n_groups: int,
                             d_state: int, headdim: int):
    if xbc_t.device.type != "cuda":
        raise ValueError(f"decode kernel needs a CUDA tensor, got "
                         f"{xbc_t.device}")
    b, km1, c = conv_state.shape
    k = km1 + 1
    g, n, p = n_groups, d_state, headdim
    di = c - 2 * g * n
    h = di // p
    if (xbc_t.shape != (b, c) or di <= 0 or di % p or h % g
            or ssm_state.shape != (b, h, p, n) or conv_w.shape != (c, k)
            or conv_b.shape != (c,) or dt_raw.shape != (b, h)
            or not (dt_bias.shape == A_log.shape == D.shape == (h,))
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
    if any(t.device != xbc_t.device for t in ins):
        raise ValueError("all decode inputs must be on one device")
    y = torch.empty((b, h, p), dtype=xbc_t.dtype, device=xbc_t.device)
    nconv = torch.empty_like(ins[0])
    nssm = torch.empty_like(ins[1])
    lib = build.library()
    rc = lib.repro_mamba2_decode_fwd(
        *[t.data_ptr() for t in ins], y.data_ptr(), nconv.data_ptr(),
        nssm.data_ptr(), b, h, p, g, n, k, code,
        build.stream_ptr(xbc_t.device))
    build.check(rc, "repro_mamba2_decode_fwd")
    mamba2_decode_fused.launches += 1
    return y, nconv, nssm


mamba2_decode_fused.launches = 0
