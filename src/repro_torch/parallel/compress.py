"""Gradient compression: int8 quantisation with error feedback (port of
``repro/parallel/compress.py``'s ``ef_compress_tree``).

A quantise/dequantise transform with an error-feedback residual carried in
the train state (Seide et al. 2014 / Karimireddy et al. 2019): the
numerics of compressed training are exact, so convergence can be checked
on one device.  The collective-level variant (``psum_int8``, an integer
all-reduce) waits for the parallel slice (ROADMAP slice 7b).
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
