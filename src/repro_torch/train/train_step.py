"""The loss and the train step with microbatch gradient accumulation.

The port of the reference's ``repro.train.train_step`` without a sharding
plan (``plan=None``; distribution is a later slice).  The loss casts the
fp32 master params to the compute dtype once, so their gradients land on
the fp32 leaves, and runs :func:`repro_torch.models.lm.lm_forward` with
``train=True`` (each layer unit rematerialised in the backward when
``cfg.remat == "block"``); the gradients are cast to ``opt.grad_dtype``
(the ``grad_compress`` scope) and, over microbatches, summed in that type.
On the card every kernel of the forward has its backward kernel or raises
(:mod:`repro_torch.kernels.grad`).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.core.scope import scope
from repro_torch.models.lm import lm_forward
from repro_torch.models.params import cast_tree, tree_leaves, tree_unflatten
from repro_torch.train.optimizer import OptConfig, adamw_update


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean of logsumexp(logits) - logits[label] in fp32.  The reference
    picks the label's logit by a one-hot masked sum (friendly to a
    sharded vocab); a gather gives the same values."""
    with scope("loss"):
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return (lse - ll).mean()


def make_loss_fn(cfg: ModelConfig, plan=None):
    """loss_fn(params, batch) -> scalar: next-token cross entropy (the
    causal shift), per-frame for encoders.  ``batch`` holds ``labels`` and
    ``tokens`` and/or ``features``."""
    if plan is not None:
        raise NotImplementedError("sharding plans are not ported")
    cd = getattr(torch, cfg.compute_dtype)

    def loss_fn(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        params = cast_tree(params, cd)
        logits = lm_forward(cfg, params, batch.get("tokens"),
                            features=batch.get("features"), train=True)
        labels = batch["labels"]
        if labels.shape[1] != logits.shape[1]:
            labels = labels[:, :logits.shape[1]]
        if cfg.family in ("encoder", "audio"):
            return cross_entropy(logits, labels, cfg.vocab_size)
        return cross_entropy(logits[:, :-1], labels[:, 1:], cfg.vocab_size)

    return loss_fn


def make_train_step(cfg: ModelConfig, opt: OptConfig, plan=None,
                    microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {"loss", "grad_norm", "lr"}, scalar tensors on the device).
    The params' and moments' tensors are updated in place
    (:func:`repro_torch.train.optimizer.adamw_update`)."""
    loss_fn = make_loss_fn(cfg, plan)
    cd = getattr(torch, cfg.compute_dtype)
    gdtype = getattr(torch, opt.grad_dtype)

    def grads_of(params, batch):
        # the gradient of a master is its compute-dtype copy's, cast up
        # (the cast's backward), and then cast to grad_dtype: taking it at
        # the copy and casting it once to grad_dtype gives the same bits
        # (bf16 -> fp32 is exact) and holds no fp32 gradient tree
        live = [t.detach().to(cd).requires_grad_() if t.is_floating_point()
                else t for t in tree_leaves(params)]
        loss = loss_fn(tree_unflatten(params, live), batch)
        # a leaf the loss does not reach (a frontend without features) gets
        # zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        del live
        with scope("grad_compress"):
            return loss.detach(), [
                (torch.zeros(p.shape, dtype=gdtype, device=p.device)
                 if g is None else g.to(gdtype))
                for p, g in zip(tree_leaves(params), grads)]

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if microbatches == 1:
            loss, flat = grads_of(params, batch)
        else:
            def split(x):
                b = x.shape[0]
                if b % microbatches:
                    raise ValueError(f"batch {b} does not split into "
                                     f"{microbatches} microbatches")
                return x.reshape(microbatches, b // microbatches,
                                 *x.shape[1:])
            mb = {k: split(v) for k, v in batch.items()}
            loss = None
            flat = None
            for i in range(microbatches):
                li, gi = grads_of(params, {k: v[i] for k, v in mb.items()})
                # accumulate in the compressed grad dtype, as the
                # reference's scan carry does
                if flat is None:
                    loss = torch.zeros((), dtype=torch.float32,
                                       device=li.device) + li
                    flat = [torch.zeros_like(g) + g for g in gi]
                else:
                    loss = loss + li
                    flat = [a + g.to(a.dtype) for a, g in zip(flat, gi)]
            loss = loss / microbatches
            flat = [g / microbatches for g in flat]
        grads = tree_unflatten(params, flat)
        params, opt_state, om = adamw_update(params, grads, opt_state, opt)
        return params, opt_state, {"loss": loss, **om}

    return train_step
