"""Pipeline parallelism: a GPipe microbatch pipeline over a ``pipe`` mesh
axis (port of ``repro/parallel/pipeline.py``).

Each rank of the axis is one stage and holds one slice of the stacked
stage parameters.  Over n_micro + n_stages − 1 ticks, stage 0 takes
microbatch t from the input and every other stage the activation its
predecessor sent at the previous tick; each stage runs ``stage_fn`` on a
microbatch it holds and sends the result to the next stage
(``batch_isend_irecv``, point to point).  The last stage keeps the
finished microbatches, and the output goes to every stage by a sum
all-reduce to which only the last stage contributes, as the reference's
masked ``psum``.  Bubble fraction = (S−1)/(M+S−1), ``bubble_fraction``.

Unlike the reference's ``lax.scan``, which runs every stage on every tick
(the bubble's stages compute on zeros and their results are dropped), a
stage here computes only on the ticks where it holds a microbatch.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def pipeline_apply(mesh, axis: str, stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_micro: torch.Tensor) -> torch.Tensor:
    """Run ``stage_fn`` as a pipeline over the ``axis`` of the DeviceMesh ``mesh``.

    stage_params: a tree whose leaves carry a leading (n_stages,) axis;
      stage s uses leaf[s].
    x_micro: (n_micro, mb, ...) microbatched input, the same on every stage.
    Returns the (n_micro, mb, ...) outputs of the final stage, on every stage.
    stage_fn must keep the microbatch's shape and dtype.
    """
    import torch.distributed as dist

    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)
    ranks = dist.get_process_group_ranks(group)
    params = _map(stage_params, lambda leaf: leaf[stage])
    n_micro = x_micro.shape[0]
    buf = torch.zeros_like(x_micro)
    inflight = torch.zeros_like(x_micro[0])
    for t in range(n_micro + n_stages - 1):
        m = t - stage                         # the microbatch this stage holds at tick t
        out = None
        if 0 <= m < n_micro:
            out = stage_fn(params, x_micro[m] if stage == 0 else inflight)
            if stage == n_stages - 1:
                buf[m] = out
        ops = []
        if out is not None and stage < n_stages - 1:
            ops.append(dist.P2POp(dist.isend, out.contiguous(), ranks[stage + 1], group))
        if stage > 0 and 0 <= m + 1 < n_micro:      # the predecessor sends m + 1 now
            inflight = torch.empty_like(x_micro[0])
            ops.append(dist.P2POp(dist.irecv, inflight, ranks[stage - 1], group))
        for req in dist.batch_isend_irecv(ops) if ops else []:
            req.wait()
    if stage != n_stages - 1:
        buf.zero_()
    dist.all_reduce(buf, group=group)
    return buf
