"""Pieces the plain references share: float32 arithmetic with TF32 off, and
the control's fp8 rounding of every matrix product's operands.

Weights come in as the benchmark made them (a dict of parameter name to
tensor, in the served dtype) and are cast to float32 where they are used,
one layer at a time.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0          # largest finite float8_e4m3fn


def strict_fp32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the largest magnitude maps to 448), returned in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Precision:
    """Matrix products in float32, or (the control) with both operands
    rounded to fp8 first: activations per row, weights per output column."""

    def __init__(self, control: bool = False):
        self.control = control

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., K) @ w (K, N) in float32."""
        x, w = x.float(), w.float()
        if self.control:
            x, w = fp8(x, -1), fp8(w, 0)
        return x @ w

    def bmm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (E, T, K) @ w (E, K, N) in float32."""
        x, w = x.float(), w.float()
        if self.control:
            x, w = fp8(x, -1), fp8(w, 1)
        return torch.bmm(x, w)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale.float()


def swiglu(x, gate, up, down, prec: Precision):
    return prec.mm(F.silu(prec.mm(x, gate)) * prec.mm(x, up), down)


def layer_weights(weights: dict, prefix: str) -> dict:
    """The weights under ``prefix`` (a layer's), keyed by the rest of their names."""
    return {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)}


def logits(weights: dict, hidden: torch.Tensor, eps: float, prec: Precision) -> torch.Tensor:
    """The final norm and the LM head over hidden (S, d) -> (S, V) float32;
    a model without ``head.w`` ties its head to the embedding."""
    h = rmsnorm(hidden, weights["final_norm.scale"], eps)
    head = weights["head.w"] if "head.w" in weights else weights["embed.table"].T
    return prec.mm(h, head)
