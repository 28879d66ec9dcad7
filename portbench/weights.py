"""The served model's weights, made from the seed on the model's device.

The model is built empty (``seed=None``: its matrices allocated, its
constants set), and every matrix is filled from one ``torch.Generator`` on
the device with normals drawn in a few large calls in the served dtype,
then scaled: 0.1 for the conv taps, 0.02 for the rest.  Norm scales, conv
biases, ``A_log``, ``D`` and ``dt_bias`` keep the constants the model
sets.  The same tensors are what the reference reads.
"""
from __future__ import annotations

import numpy as np
import torch

CONSTANTS = ("scale", "bias_x", "bias_b", "bias_c", "A_log", "D", "dt_bias")
CONV = ("conv_x", "conv_b", "conv_c")
DRAW = 1 << 28           # elements drawn in one call


def torch_seed(seed: int) -> int:
    """A 63-bit seed for ``torch.Generator`` from any whole number."""
    return int(np.random.SeedSequence([int(seed), 2]).generate_state(1, np.uint64)[0] >> np.uint64(1))


def random_leaves(model) -> list:
    """(name, parameter, scale) of every parameter drawn at random."""
    out = []
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in CONSTANTS:
            continue
        out.append((name, p, 0.1 if leaf in CONV else 0.02))
    return out


@torch.no_grad()
def fill(model, seed: int) -> dict:
    """Fill ``model``'s random parameters from ``seed``; return every
    parameter by name (the tensors both sides read)."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed))
    by_dtype = {}
    for name, p, scale in random_leaves(model):
        by_dtype.setdefault(p.dtype, []).append((p, scale))
    for dtype, leaves in sorted(by_dtype.items(), key=lambda kv: str(kv[0])):
        total = sum(p.numel() for p, _ in leaves)
        pending = list(leaves)
        offset_in_leaf = 0
        while total > 0:
            n = min(DRAW, total)
            buf = torch.randn(n, generator=gen, device=device, dtype=dtype)
            at = 0
            while at < n:
                p, scale = pending[0]
                take = min(n - at, p.numel() - offset_in_leaf)
                p.view(-1)[offset_in_leaf:offset_in_leaf + take].copy_(buf[at:at + take]).mul_(scale)
                at += take
                offset_in_leaf += take
                if offset_in_leaf == p.numel():
                    pending.pop(0)
                    offset_in_leaf = 0
            total -= n
    return dict(model.named_parameters())
