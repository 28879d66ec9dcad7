"""Optimizers: AdamW, Adafactor, schedules, clipping (port of ``repro/train/optimizer.py``).

The reference's math, written for a dict of tensors keyed by parameter
name: AdamW with b2 = 0.95, decoupled weight decay on matrices only and
fp32 moments for parameters of any dtype; Adafactor (Shazeer & Stern,
2018; no momentum) with a factored second moment for the last two dims
when both are at least 128, and update clipping.  ``torch.optim``'s
``AdamW`` and ``Adafactor`` differ from these in details (the order of the
weight decay, Adafactor's relative step and epsilons), so they are not
used.

``update(grads, state, params, step, leaves=None)`` writes the new
parameters and slots into the tensors it is given, one leaf at a time, so
a step holds one leaf's temporaries at most (the reference's jitted step
donates its buffers to the same end); it returns ``(params, state)``.  The
learning rate and bias corrections are fp32 scalars on the host, as the
reference's are fp32.

``leaves`` says which parameters the reference holds as one leaf: its
``scan`` section stacks each weight of the repeating layer group along a
new leading axis.  That matters twice, and the port follows the reference
in both (``Model.reference_leaves`` gives the grouping): a stacked vector
(a norm scale) is a matrix to the reference, so AdamW decays it; and
Adafactor's update clipping takes the RMS over the whole stack.  Without
``leaves`` every parameter is its own leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

Tree = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def cosine_schedule(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32).cpu()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (x * scale).to(x.dtype) for k, x in tree.items()}, norm


# ---------------------------------------------------------------------------
# Optimizer interface
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree, Any], Tuple[Tree, Any]]
    # update(grads, state, params, step) -> (params, state), both updated in place


def _zeros32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _leaves(params, leaves):
    """[(names, stacked)]: each reference leaf's parameters, in stack order."""
    if leaves is None:
        return [([k], False) for k in params]
    return leaves


def _ndim(p, stacked):
    return p.dim() + (1 if stacked else 0)


def adamw(lr: Callable, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"m": {k: _zeros32(p) for k, p in params.items()},
                "v": {k: _zeros32(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step, leaves=None):
        stepf = torch.as_tensor(step).to(torch.float32).cpu() + 1.0
        lr_t = lr(step)
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf
        for names, stacked in _leaves(params, leaves):
            for k in names:
                p = params[k]
                g = grads[k].to(torch.float32)
                m = b1 * state["m"][k] + (1 - b1) * g
                v = b2 * state["v"][k] + (1 - b2) * g * g
                delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                if _ndim(p, stacked) >= 2:  # decoupled weight decay on matrices only
                    delta = delta + weight_decay * p.to(torch.float32)
                p.copy_(p.to(torch.float32) - lr_t * delta)
                state["m"][k].copy_(m)
                state["v"][k].copy_(v)
        return params, state

    return Optimizer(init, update)


def adafactor(lr: Callable, eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0, min_dim_factored: int = 128) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern, 2018), no momentum."""

    def _factored(p):
        return p.dim() >= 2 and p.shape[-1] >= min_dim_factored and p.shape[-2] >= min_dim_factored

    def init(params):
        def one(p):
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                          device=p.device)}
            return {"v": _zeros32(p)}
        return {"slots": {k: one(p) for k, p in params.items()}}

    def _one(g, slot, factored, decay):
        """The unclipped update of one parameter; its new slots written."""
        g2 = g * g + eps
        if factored:
            vr = decay * slot["vr"] + (1 - decay) * torch.mean(g2, dim=-1)
            vc = decay * slot["vc"] + (1 - decay) * torch.mean(g2, dim=-2)
            denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps)
            u = g * torch.rsqrt(vr[..., None] / denom[..., None])
            u = u * torch.rsqrt(vc[..., None, :])
            slot["vr"].copy_(vr)
            slot["vc"].copy_(vc)
        else:
            v = decay * slot["v"] + (1 - decay) * g2
            u = g * torch.rsqrt(v)
            slot["v"].copy_(v)
        return u

    @torch.no_grad()
    def update(grads, state, params, step, leaves=None):
        stepf = torch.as_tensor(step).to(torch.float32).cpu() + 1.0
        decay = 1.0 - stepf ** -0.8
        lr_t = lr(step)
        for names, stacked in _leaves(params, leaves):
            first = params[names[0]]
            if stacked and first.dim() == 1 and _factored(torch.empty((len(names),) + first.shape,
                                                                      device="meta")):
                raise NotImplementedError(
                    "a stack of >= 128 vectors of >= 128 entries, which the reference "
                    "factors across its layers")
            us = [_one(grads[k].to(torch.float32), state["slots"][k], _factored(params[k]),
                       decay) for k in names]
            # the update clipping's RMS is over the reference's whole leaf
            rms = torch.sqrt(sum(torch.sum(u * u) for u in us) / sum(u.numel() for u in us))
            for k, u in zip(names, us):
                p = params[k]
                u = u / torch.clamp(rms / clip_threshold, min=1.0)
                newp = p.to(torch.float32) - lr_t * u
                if weight_decay and _ndim(p, stacked) >= 2:
                    newp = newp - lr_t * weight_decay * p.to(torch.float32)
                p.copy_(newp)
        return params, state

    return Optimizer(init, update)


OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor}
