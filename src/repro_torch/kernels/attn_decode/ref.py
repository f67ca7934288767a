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


def decode_attention_partials_ref(q, k, v, *, valid_len):
    """The partials of ``decode_attention_ref`` over these keys, as the
    kernel's partials mode writes them: (acc [B, H, d], m [B, H], l [B, H])
    in fp32, acc the unnormalised sum of p * v, m the max scaled score over
    the live keys (-1e30 where there is none) and l the sum of
    p = exp(score - m) over them (0 where there is none)."""
    b, h, d = q.shape
    kvh, s_len = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) * (1.0 / math.sqrt(d))
    vl = torch.as_tensor(valid_len, device=q.device).to(torch.int64)
    vl = vl.reshape(-1).expand(b)[:, None, None, None]
    live = torch.arange(s_len, device=q.device)[None, None, None, :] < vl
    s = torch.where(live, s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(-1)
    p = torch.where(live, torch.exp(s - m[..., None]),
                    torch.zeros((), device=q.device))
    acc = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return acc.reshape(b, h, d), m.reshape(b, h), p.sum(-1).reshape(b, h)


def merge_partials(acc, m, l) -> torch.Tensor:
    """Partials of one query over ``n`` disjoint key sets, stacked first
    (acc [n, ..., d], m and l [n, ...]), merged as :func:`merge_splits`
    merges splits: [..., d] in fp32."""
    return merge_splits(acc.movedim(0, -2), m.movedim(0, -1),
                        l.movedim(0, -1))


def merge_splits(acc, m, l) -> torch.Tensor:
    """The exact online-softmax merge of split partials, as the kernels
    run it (the reference's ``attn_decode/kernel.py:146-150``): ``acc``
    [..., n, d] each split's unnormalised sum of p * v, ``m`` and ``l``
    [..., n] its running max and sum of p; a split with no live key
    carries m = -1e30, l = 0 and vanishes.  Returns [..., d] in fp32."""
    mall = m.amax(-1, keepdim=True)
    w = torch.exp(m - mall)
    num = (acc * w[..., None]).sum(-2)
    return num / (l * w).sum(-1, keepdim=True).clamp_min(1e-37)


def decode_attention_split_ref(q, k, v, *, valid_len,
                               split_len: int) -> torch.Tensor:
    """``decode_attention_ref`` computed as the kernel computes it: keys cut
    into ``split_len``-key splits, each split's (acc, m, l) over its keys
    below ``valid_len``, splits that start at or past ``valid_len`` empty,
    then :func:`merge_splits`.  fp32 throughout; cast to q's dtype."""
    b, h, d = q.shape
    kvh, s_len = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) / math.sqrt(d)
    vl = torch.as_tensor(valid_len, device=q.device).to(torch.int64)
    vl = vl.reshape(-1).expand(b)[:, None, None, None]
    live = torch.arange(s_len, device=q.device)[None, None, None, :] < vl
    accs, ms, ls = [], [], []
    for lo in range(0, s_len, split_len):
        sl = slice(lo, lo + split_len)
        sc = torch.where(live[..., sl], s[..., sl],
                         torch.full((), NEG_INF, device=q.device))
        m = sc.amax(-1)
        p = torch.exp(sc - m[..., None])
        started = (vl[..., 0] > lo)                 # [B, 1, 1]
        m = torch.where(started, m, torch.full((), NEG_INF,
                                               device=q.device))
        p = torch.where(started[..., None], p,
                        torch.zeros((), device=q.device))
        accs.append(torch.einsum("bkgs,bksd->bkgd", p, v[..., sl, :].float()))
        ms.append(m)
        ls.append(p.sum(-1))
    o = merge_splits(torch.stack(accs, -2), torch.stack(ms, -1),
                     torch.stack(ls, -1))
    return o.reshape(b, h, d).to(q.dtype)
