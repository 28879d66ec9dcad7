"""Train-step factory: loss -> grads (microbatched) -> compress -> clip -> optimizer.

Port of ``repro/train/train_step.py``.  Gradient accumulation splits the
global batch into ``microbatch`` slices along the batch axis, accumulates
fp32 gradients over them and averages them (the reference ``lax.scan``s
over the slices); the loss is averaged the same way.  Optional int8
error-feedback compression (``parallel.compress``) is applied before the
clipping and the optimizer, which groups the parameters into the
reference's leaves (``Model.reference_leaves``).

The train state is a dict of tensors ``{"params", "opt", "step", ["ef"]}``:
``params`` holds the model's own parameters by name (``requires_grad`` on),
so the model computes with the state's weights; the step writes the new
parameters and optimizer slots into them in place.  ``step`` is an int32
scalar on the host.

Under a sharding policy (the model's, or ``policy``) the parameters, and
so the gradients, are DTensors.  A gradient comes out of the backward pass
as a pending sum over the ranks; with ``flags.grad_rs`` it is reduced
straight into its parameter's placements (a reduce-scatter, the
reference's ``train_step.py:65-70``), otherwise it is all-reduced and the
optimizer takes its parameter's slice.  The metrics are plain tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.parallel.sharding import is_distributed, maybe_context
from repro_torch.train.optimizer import Optimizer, clip_by_global_norm


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatch: int = 1
    max_grad_norm: float = 1.0
    grad_compress: bool = False


def _plain(t):
    t = t.detach()
    return t.full_tensor() if is_distributed(t) else t


def _grads_of(model, params, batch):
    loss, metrics = model.loss_fn(batch)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                materialize_grads=True)
    return _plain(loss), {k: _plain(v) for k, v in metrics.items()}, dict(zip(params, grads))


def _reduce_grads(grads, params, policy, into_shards: bool):
    """Each pending gradient sum reduced: into its parameter's placements
    (``into_shards``, a reduce-scatter) or whole on every rank."""
    from torch.distributed.tensor import Replicate

    out = {}
    for k, g in grads.items():
        if is_distributed(g):
            p = params[k]
            want = p.placements if into_shards else [Replicate()] * p.device_mesh.ndim
            g = g.redistribute(p.device_mesh, want)
        out[k] = g
    return out


def make_train_step(model, optimizer: Optimizer, cfg: TrainStepConfig = TrainStepConfig(),
                    policy=None):
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params", "opt", "step", ["ef"]}; ``batch`` holds tensors on the
    model's device (``data.to_device``).  The metrics are 0-d tensors:
    ``loss``, ``grad_norm`` and, without microbatching, ``ce`` and ``aux``.
    """

    leaves = model.reference_leaves()
    policy = policy if policy is not None else getattr(model, "policy", None)

    def train_step(state, batch):
        with maybe_context(policy):
            return _step(state, batch)

    def _step(state, batch):
        params = state["params"]
        if cfg.microbatch > 1:
            n = cfg.microbatch
            acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for k, p in params.items()}
            loss_sum = None
            for i in range(n):
                mb = {k: x[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)]
                      for k, x in batch.items()}
                loss, _, grads = _grads_of(model, params, mb)
                for k, g in grads.items():
                    acc[k] += g.to(torch.float32)
                loss_sum = loss.float() if loss_sum is None else loss_sum + loss
            grads = {k: g / n for k, g in acc.items()}
            loss = loss_sum / n
            metrics: Dict[str, Any] = {}
        else:
            loss, metrics, grads = _grads_of(model, params, batch)
        if policy is not None and policy.has_devices:
            grads = _reduce_grads(grads, params, policy, model.flags.grad_rs)

        new_state = {k: v for k, v in state.items() if k != "ef"}
        if cfg.grad_compress:
            from repro_torch.parallel.compress import ef_compress_tree

            grads, new_state["ef"] = ef_compress_tree(grads, state["ef"])
        grads, gnorm = clip_by_global_norm(grads, cfg.max_grad_norm)
        _, new_state["opt"] = optimizer.update(grads, state["opt"], params, state["step"],
                                               leaves)
        new_state["step"] = state["step"] + 1
        return new_state, {"loss": loss, "grad_norm": gnorm, **metrics}

    return train_step


def init_train_state(model, optimizer: Optimizer,
                     cfg: TrainStepConfig = TrainStepConfig()) -> Dict[str, Any]:
    """The train state over ``model``'s weights (which its seed drew), with
    gradients switched on for them."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    state = {"params": params, "opt": optimizer.init(params, model.reference_leaves()),
             "step": torch.zeros((), dtype=torch.int32)}
    if cfg.grad_compress:
        from repro_torch.parallel.compress import ef_init

        state["ef"] = ef_init(params)
    return state


@torch.no_grad()
def load_train_state(state, values):
    """Copy ``values`` (a tree like ``state``, e.g. a restored checkpoint)
    into ``state``'s tensors in place, so the model's parameters take them;
    returns ``state``."""
    def copy(dst, src, path):
        if isinstance(dst, dict):
            if set(dst) != set(src):
                raise KeyError(f"{path or 'state'}: keys differ: "
                               f"{sorted(set(dst) ^ set(src))[:8]}")
            for k in dst:
                copy(dst[k], src[k], f"{path}/{k}" if path else k)
        else:
            if tuple(dst.shape) != tuple(src.shape):
                raise ValueError(f"{path}: shape {tuple(src.shape)}, want {tuple(dst.shape)}")
            dst.copy_(src)
    copy(state, values, "")
    return state
