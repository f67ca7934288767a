"""Mixture-of-Experts feed-forward: the port of the reference's
``repro.models.moe``.

Two dispatch paths, selected by ``MoEConfig.impl``:

* ``gshard`` (the default): GShard-style dispatch and combine with a
  capacity factor.  Tokens are cut into ``n_groups`` groups; within a
  group each (token, choice) takes the next free slot of its expert's
  buffer of ``_capacity`` rows, in the reference's order (a cumulative
  sum over the flattened (token, choice) axis), and a choice past the
  capacity is dropped.  Every expert's weights are read on every call.
* ``ragged``: sort the (token, choice) rows by expert (stable, as
  ``jnp.argsort``), one grouped product a weight over the sorted rows,
  then un-permute to ``[t, k, d]`` and sum over ``k``.  Nothing is
  dropped; only the routed experts' rows are computed.

Both run their products outside any hand-written kernel, as the
reference runs its einsums and ``ragged_dot`` outside any Pallas kernel.
Neither syncs with the host, so a decode step of either path can be
captured in a CUDA graph: both one-hots are comparisons with an
``arange`` (``jax.nn.one_hot`` gives a zero row for an index past its
width, where ``F.one_hot`` would raise), the ragged group offsets come
from a ``searchsorted`` on the device, and the grouped product is
``torch._grouped_mm`` with those offsets.  The ragged combine sums each
token's ``k`` rows in a fixed order (no atomic ``index_add_``), so a
graph replay is bit-identical to the eager call.

Both train on the card and on the CPU alike: autograd differentiates
their torch ops (gshard's products, the ragged path's
``torch._grouped_mm``).  The ragged path's gathers and scatters are
permutations (``order``) or a fixed-order sum, so their backwards sum in
one order too: a token's rows are gathered as its ``k`` (token, choice)
copies, whose gradients are summed over ``k`` like the combine.  The
gradient reaching each grouped product is made contiguous first (its
backward rejects a broadcast gradient, stride 0, such as a ``.sum()``'s).

The router runs in fp32 in the ``moe_route`` scope; its weight stays
fp32 (``repro_torch.models.lm.prepare_params`` casts only the expert
weights).  The reference's ``constrain`` calls are sharding annotations,
no-ops without a mesh: the port has none.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.core.config import MoEConfig
from repro_torch.core.scope import scope
from repro_torch.models.mlp import activation, gated
from repro_torch.models.params import ParamDef

# the matmul weights the compute dtype reads (cast once at load); the
# router is not among them
EXPERT_KEYS = ("wi", "wg", "wo", "shared_wi", "shared_wg", "shared_wo")


def moe_param_defs(d_model: int, m: MoEConfig) -> Dict[str, ParamDef]:
    e, f = m.n_experts, m.d_ff_expert
    defs = {
        "router": ParamDef((d_model, e), ("embed", None), fan_in=d_model),
        "wi": ParamDef((e, d_model, f), ("experts", "embed", "expert_ff"),
                       fan_in=d_model),
        "wg": ParamDef((e, d_model, f), ("experts", "embed", "expert_ff"),
                       fan_in=d_model),
        "wo": ParamDef((e, f, d_model), ("experts", "expert_ff", "embed"),
                       init="normal_out", fan_in=f),
    }
    if m.shared_expert:
        defs["shared_wi"] = ParamDef((d_model, f), ("embed", "ff"),
                                     fan_in=d_model)
        defs["shared_wg"] = ParamDef((d_model, f), ("embed", "ff"),
                                     fan_in=d_model)
        defs["shared_wo"] = ParamDef((f, d_model), ("ff", "embed"),
                                     init="normal_out", fan_in=f)
    return defs


def _capacity(tokens_per_group: int, m: MoEConfig) -> int:
    c = math.ceil(tokens_per_group * m.experts_per_token / m.n_experts
                  * m.capacity_factor)
    if c >= 16:
        return -(-c // 16) * 16
    return max(8, -(-c // 8) * 8)


def _router(p, x: torch.Tensor, m: MoEConfig):
    """x [g, t, d] -> (gates [g, t, k] fp32, softmax over the top k
    logits; idx [g, t, k] int64, largest logit first)."""
    with scope("moe_route"):
        logits = torch.matmul(x.float(), p["router"].float())
        gates, idx = torch.topk(logits, m.experts_per_token, dim=-1)
        return torch.softmax(gates, dim=-1), idx


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a zero row, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _shared_expert(p, x: torch.Tensor, act: str) -> torch.Tensor:
    with scope("moe_shared_expert"):
        return gated(x, p["shared_wi"], p["shared_wg"], p["shared_wo"], act)


def moe_gshard(p: Dict, x: torch.Tensor, m: MoEConfig, n_groups: int,
               act: str = "silu") -> torch.Tensor:
    """x: [B, S, D].  Tokens are reshaped into ``n_groups`` dispatch groups
    (the largest count up to ``n_groups`` that divides B*S), each with its
    own expert buffers of ``_capacity`` rows."""
    b, s, d = x.shape
    t = b * s
    g = min(n_groups, t)
    while t % g:
        g -= 1
    tg = t // g
    xg = x.reshape(g, tg, d)
    cap = _capacity(tg, m)
    e, k = m.n_experts, m.experts_per_token

    gates, idx = _router(p, xg, m)                          # [g, tg, k]
    with scope("moe_dispatch"):
        onehot = _one_hot(idx, e)                           # [g, tg, k, e]
        # each (token, choice)'s slot in its expert's buffer, in the
        # reference's order: a cumulative sum over (token, choice)
        pos = torch.cumsum(onehot.reshape(g, tg * k, e), dim=1).reshape(
            g, tg, k, e) - 1.0
        pos_k = (pos * onehot).sum(-1)                      # [g, tg, k]
        keep_k = pos_k < cap                                # capacity drop
        capslot = _one_hot(pos_k.to(torch.int64), cap)      # [g, tg, k, cap]
        weighted = onehot * (gates * keep_k)[..., None]     # [g, tg, k, e]
        # gtke,gtkc->gtec: one product per token over its k choices
        combine = torch.bmm(weighted.reshape(g * tg, k, e).transpose(1, 2),
                            capslot.reshape(g * tg, k, cap)).reshape(
            g, tg, e * cap)
        dispatch = (combine > 0).to(x.dtype)
        # gtec,gtd->gecd
        ex_in = torch.bmm(dispatch.transpose(1, 2), xg)     # [g, e*cap, d]
    with scope("moe_expert"):
        dt = x.dtype
        # expert-major rows: [e, g*cap, d]
        xe = ex_in.reshape(g, e, cap, d).transpose(0, 1).reshape(
            e, g * cap, d)
        h = torch.bmm(xe, p["wi"].to(dt))
        hg = torch.bmm(xe, p["wg"].to(dt))
        ex_out = torch.bmm(activation(act)(hg) * h, p["wo"].to(dt))
        ex_out = ex_out.reshape(e, g, cap, d).transpose(0, 1).reshape(
            g, e * cap, d)
    with scope("moe_combine"):
        # gtec,gecd->gtd
        y = torch.bmm(combine.to(dt), ex_out)
    y = y.reshape(b, s, d)
    if m.shared_expert:
        y = y + _shared_expert(p, x, act)
    return y


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _grouped_mm(a: torch.Tensor, w: torch.Tensor,
                offs: torch.Tensor) -> torch.Tensor:
    return _ContiguousGrad.apply(torch._grouped_mm(a, w, offs=offs))


def moe_ragged(p: Dict, x: torch.Tensor, m: MoEConfig,
               act: str = "silu") -> torch.Tensor:
    """Sort-based MoE: flatten, sort by expert, grouped products, unsort.
    No capacity drop."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    gates, idx = _router(p, xf[None], m)
    gates, idx = gates[0], idx[0]                            # [t, k]
    k, e = m.experts_per_token, m.n_experts
    flat_idx = idx.reshape(-1)                               # [t*k]
    sorted_idx, order = torch.sort(flat_idx, stable=True)
    # each token's k (token, choice) rows, then permuted: the gathered
    # rows are those of order // k
    xs = xf[:, None].expand(t, k, d).reshape(t * k, d)[order]  # [t*k, d]
    # each expert's end row among the sorted rows, on the device
    offs = torch.searchsorted(
        sorted_idx, torch.arange(e, device=x.device), right=True).to(
        torch.int32)
    with scope("moe_expert"):
        dt = x.dtype
        h = _grouped_mm(xs, p["wi"].to(dt), offs)
        hg = _grouped_mm(xs, p["wg"].to(dt), offs)
        o = _grouped_mm(activation(act)(hg) * h, p["wo"].to(dt), offs)
    with scope("moe_combine"):
        wsorted = gates.reshape(-1)[order]
        o = o * wsorted[:, None].to(o.dtype)
        # back to (token, choice) order, then each token's k rows summed
        # in a fixed order
        unsorted = torch.empty_like(o)
        unsorted[order] = o
        y = unsorted.reshape(t, k, d).sum(1)
    y = y.reshape(b, s, d).to(x.dtype)
    if m.shared_expert:
        y = y + _shared_expert(p, x, act)
    return y


def moe(p: Dict, x: torch.Tensor, m: MoEConfig, n_groups: int = 1,
        act: str = "silu") -> torch.Tensor:
    """The MoE feed-forward by ``m.impl``."""
    if m.impl == "ragged":
        return moe_ragged(p, x, m, act)
    return moe_gshard(p, x, m, n_groups, act)
