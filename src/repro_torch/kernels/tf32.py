"""TF32 rounding, as the fp32 paths of K3 and K4 feed the tensor cores.

A TF32 operand keeps fp32's exponent and 10 of its 23 mantissa bits, so one
TF32 product keeps about 11 significant bits.  The kernels split each fp32
operand x into hi = tf32(x) and lo = tf32(x − hi) and add three products,
hi·hi + hi·lo + lo·hi, which keeps about 22 (the dropped lo·lo is below
2⁻²² of the product).  ``round_tf32`` repeats ``cvt.rna.tf32.f32`` with
integer operations, so the kernels' mirrors (``flash_attention_mirror_fp32``,
``ssd_scan_mirror`` in fp32) form the same parts on any device.
"""
from __future__ import annotations

import torch

_HALF_ULP = 1 << 12          # half a TF32 unit in the last place, in fp32 bits
_LOW_BITS = (1 << 13) - 1    # the 13 mantissa bits TF32 drops


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (to nearest, ties away from zero), held in
    fp32 with its low 13 mantissa bits zero, as ``cvt.rna.tf32.f32`` rounds
    it.  Adding half a unit to the bits rounds the magnitude up on a tie
    whatever the sign; a carry out of the mantissa steps the exponent, as it
    should.  Infinities and NaNs are left as they are."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    out = ((bits + _HALF_ULP) & ~_LOW_BITS).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def split_tf32(x: torch.Tensor):
    """(hi, lo): hi = tf32(x), lo = tf32(x − hi); hi + lo is x to about
    2⁻²² of |x|."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def product3(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` as three TF32 products in fp32, in the kernels'
    order: lo·hi, hi·lo, then hi·hi."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + torch.einsum(eq, ah, bh)
