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

The parameters may be DTensors (``parallel.sharding``): the slots are made
with the parameters' placements (Adafactor's factored moments with the
placements of the dimensions they keep), each gradient is moved to its
parameter's placements, every new value to its slot's before it is
written, and the global norm's per-leaf sums are reduced over the ranks.

``leaves`` says which parameters the reference holds as one leaf: its
``scan`` section stacks each weight of the repeating layer group along a
new leading axis.  That matters three times, and the port follows the
reference in each (``Model.reference_leaves`` gives the grouping): a
stacked vector (a norm scale) is a matrix to the reference, so AdamW
decays it; Adafactor's update clipping takes the RMS over the whole stack;
and a stack of 128 or more vectors of 128 or more entries is a matrix
Adafactor factors: each layer keeps its own ``vr`` (a 0-d slot, the
reference's row of the stack) and the stack shares one ``vc`` (the
reference's column moment), held in the slots of the stack's first
parameter.  ``init`` takes ``leaves`` for that.  Without ``leaves`` every
parameter is its own leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.parallel.sharding import is_distributed

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


def _full(t):
    return t.full_tensor() if is_distributed(t) else t


def _like(t, like):
    """A whole tensor ``t`` in the placements of ``like`` where that is a
    DTensor (every rank holds all of ``t``), else ``t``."""
    if not is_distributed(like):
        return t
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, like.device_mesh, like.placements, src_data_rank=None)


def _placed(t, like):
    """``t`` in the placements of ``like`` (both DTensors), else as it is."""
    if is_distributed(like) and tuple(t.placements) != tuple(like.placements):
        return t.redistribute(like.device_mesh, like.placements)
    return t


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = [_full(torch.sum(torch.square(x.to(torch.float32)))) for x in tree.values()]
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
    init: Callable[..., Any]
    # init(params, leaves=None) -> state
    update: Callable[..., Tuple[Tree, Any]]
    # update(grads, state, params, step, leaves=None) -> (params, state), both updated in place


def _zeros32(p):
    return torch.zeros_like(p, dtype=torch.float32)


def _zeros32_without(p, dim):
    """fp32 zeros shaped like ``p`` without dimension ``dim`` (a negative
    index); a DTensor keeps the placements of the dimensions left."""
    shape = p.shape[:dim] + (p.shape[dim + 1:] if dim != -1 else ())
    if not is_distributed(p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    d = dim % p.dim()
    pl = [Replicate() if isinstance(x, Shard) and x.dim == d else
          Shard(x.dim - 1) if isinstance(x, Shard) and x.dim > d else x for x in p.placements]
    return distribute_tensor(torch.zeros(shape, dtype=torch.float32, device=p.device),
                             p.device_mesh, pl, src_data_rank=None)


def _leaves(params, leaves):
    """[(names, stacked)]: each reference leaf's parameters, in stack order."""
    if leaves is None:
        return [([k], False) for k in params]
    return leaves


def _ndim(p, stacked):
    return p.dim() + (1 if stacked else 0)


def adamw(lr: Callable, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params, leaves=None):
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
                g = _placed(grads[k].to(torch.float32), p)
                m = b1 * state["m"][k] + (1 - b1) * g
                v = b2 * state["v"][k] + (1 - b2) * g * g
                delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                if _ndim(p, stacked) >= 2:  # decoupled weight decay on matrices only
                    delta = delta + weight_decay * p.to(torch.float32)
                p.copy_(_placed(p.to(torch.float32) - lr_t * delta, p))
                state["m"][k].copy_(_placed(m, p))
                state["v"][k].copy_(_placed(v, p))
        return params, state

    return Optimizer(init, update)


def adafactor(lr: Callable, eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0, min_dim_factored: int = 128) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern, 2018), no momentum."""

    def _factored(p):
        return p.dim() >= 2 and p.shape[-1] >= min_dim_factored and p.shape[-2] >= min_dim_factored

    def _stack_factored(names, stacked, params):
        """A reference leaf of stacked vectors that it factors as an (L, d) matrix."""
        first = params[names[0]]
        return (stacked and first.dim() == 1 and len(names) >= min_dim_factored
                and first.shape[0] >= min_dim_factored)

    def init(params, leaves=None):
        slots = {}
        for names, stacked in _leaves(params, leaves):
            if _stack_factored(names, stacked, params):
                slots.update((k, {"vr": _zeros32_without(params[k], -1)}) for k in names)
                slots[names[0]]["vc"] = _zeros32(params[names[0]])
                continue
            for k in names:
                p = params[k]
                slots[k] = ({"vr": _zeros32_without(p, -1), "vc": _zeros32_without(p, -2)}
                            if _factored(p) else {"v": _zeros32(p)})
        return {"slots": slots}

    def _one(g, slot, factored, decay):
        """The unclipped update of one parameter; its new slots written."""
        g2 = g * g + eps
        if factored:
            vr = decay * slot["vr"] + (1 - decay) * torch.mean(g2, dim=-1)
            vc = decay * slot["vc"] + (1 - decay) * torch.mean(g2, dim=-2)
            denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps)
            u = g * torch.rsqrt(vr[..., None] / denom[..., None])
            u = u * torch.rsqrt(vc[..., None, :])
            slot["vr"].copy_(_placed(vr, slot["vr"]))
            slot["vc"].copy_(_placed(vc, slot["vc"]))
        else:
            v = decay * slot["v"] + (1 - decay) * g2
            u = g * torch.rsqrt(v)
            slot["v"].copy_(_placed(v, slot["v"]))
        return u

    def _one_stack(gs, slots, decay):
        """``_one`` of a factored stack of vectors, the reference's (L, d)
        leaf: a row moment per layer, the column moment shared (held in the
        first layer's slots); the unclipped update of each layer."""
        g = torch.stack([_full(x) for x in gs])                          # (L, d)
        g2 = g * g + eps
        vr = decay * torch.stack([_full(s["vr"]) for s in slots]) + (1 - decay) * g2.mean(-1)
        vc = decay * _full(slots[0]["vc"]) + (1 - decay) * g2.mean(-2)
        denom = torch.clamp(vr.mean(), min=eps)
        u = g * torch.rsqrt(vr[:, None] / denom)
        u = u * torch.rsqrt(vc[None, :])
        for i, slot in enumerate(slots):
            slot["vr"].copy_(_like(vr[i], slot["vr"]))
        slots[0]["vc"].copy_(_like(vc, slots[0]["vc"]))
        return [_like(x, gx) for x, gx in zip(u, gs)]

    @torch.no_grad()
    def update(grads, state, params, step, leaves=None):
        stepf = torch.as_tensor(step).to(torch.float32).cpu() + 1.0
        decay = 1.0 - stepf ** -0.8
        lr_t = lr(step)
        for names, stacked in _leaves(params, leaves):
            gs = [_placed(grads[k].to(torch.float32), params[k]) for k in names]
            if _stack_factored(names, stacked, params):
                us = _one_stack(gs, [state["slots"][k] for k in names], decay)
            else:
                us = [_one(g, state["slots"][k], _factored(params[k]), decay)
                      for g, k in zip(gs, names)]
            # the update clipping's RMS is over the reference's whole leaf
            rms = torch.sqrt(sum(torch.sum(u * u) for u in us) / sum(u.numel() for u in us))
            for k, u in zip(names, us):
                p = params[k]
                u = u / torch.clamp(rms / clip_threshold, min=1.0)
                newp = p.to(torch.float32) - lr_t * u
                if weight_decay and _ndim(p, stacked) >= 2:
                    newp = newp - lr_t * weight_decay * p.to(torch.float32)
                p.copy_(_placed(newp, p))
        return params, state

    return Optimizer(init, update)


OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor}
