"""Gradient compression: int8 quantisation with error feedback (port of
``repro/parallel/compress.py``).

Two forms:
  * ``ef_compress_tree``: a quantise/dequantise transform with an
    error-feedback residual carried in the train state (Seide et al. 2014 /
    Karimireddy et al. 2019): the numerics of compressed training are
    exact, so convergence can be checked on one device;
  * ``psum_int8``: the collective-level variant over a process group or a
    mesh axis: quantise, integer all-reduce, dequantise, which is what
    shrinks the bytes on the wire (8/32 of the fp32 volume, plus one
    scalar).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8.  Returns (q int8, scale fp32)."""
    amax = x.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def ef_compress_tree(grads: Dict[str, torch.Tensor], ef_state: Dict[str, torch.Tensor]
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Error-feedback Q/DQ: g' = Q(g + e);  e' = (g + e) - g'."""
    out, ef = {}, {}
    for k, g in grads.items():
        corrected = g.to(torch.float32) + ef_state[k]
        q, s = _quantize(corrected)
        out[k] = _dequantize(q, s)
        ef[k] = corrected - out[k]
    return out, ef


def psum_int8(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` with int8 on the wire.

    ``group``: a process group (None: the default one) or ``(mesh, axis)``,
    a ``DeviceMesh`` and one of its axis names.  A shared scale (the global
    absmax, one scalar all-reduce MAX) keeps the integer sum (an int32
    all-reduce SUM) exact to dequantise, as the reference's ``psum_int8``
    inside ``shard_map``."""
    import torch.distributed as dist

    if isinstance(group, tuple):
        mesh, axis = group
        group = mesh.get_group(axis)
    amax = x.abs().max().to(torch.float32)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.to(torch.float32) * scale
