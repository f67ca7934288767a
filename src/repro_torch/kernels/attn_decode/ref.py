"""Plain PyTorch decode attention: one query token against a KV cache.

q [B, H, d]; k, v [B, KVH, S, d]; keys at or past ``valid_len`` (a scalar
or [B]) are masked.  fp32 scores, probabilities and P.V, as in the
reference's ``decode_attention_ref``; the output is cast to q's dtype.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash.ref import NEG_INF


def decode_attention_ref(q, k, v, *, valid_len) -> torch.Tensor:
    b, h, d = q.shape
    kvh, s_len = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d).float()
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) * scale
    vl = torch.as_tensor(valid_len, device=q.device).to(torch.int64)
    vl = vl.reshape(-1).expand(b)[:, None, None, None]
    kpos = torch.arange(s_len, device=q.device)[None, None, None, :]
    s = torch.where(kpos < vl, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return o.reshape(b, h, d).to(q.dtype)
