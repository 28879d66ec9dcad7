"""Shared NN building blocks (port of ``repro/models/layers.py``).

Parameters keep the JAX package's names and layouts (``table`` (V, d),
``w`` (d, V), ``wi_gate``/``wi_up`` (d, f), ``wo`` (f, d), ``scale`` (d,)),
so weights carry across through numpy unchanged.  Each module allocates its
parameters on an explicit ``device``; with a ``torch.Generator`` it fills them
as the reference does (normal at std 0.02 drawn in fp32, then cast; norm
scales at one), and without one it leaves them empty for a later
``load_state_dict``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.parallel.sharding import is_distributed


def normal_param(shape, dtype, device, generator: Optional[torch.Generator],
                 scale: float = 0.02) -> nn.Parameter:
    """``scale * N(0, 1)`` drawn in fp32 then cast, as ``layers._normal``."""
    if generator is None:
        t = torch.empty(shape, dtype=dtype, device=device)
    else:
        t = (scale * torch.randn(shape, generator=generator, device=device,
                                 dtype=torch.float32)).to(dtype)
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps=1e-6):
    """RMS norm computed in fp32 and cast back to ``x``'s dtype."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dt)


def gated_rmsnorm(x, gate, scale, eps=1e-6):
    """Mamba-2 style: normalise ``x * silu(gate)``."""
    return rmsnorm(x * F.silu(gate), scale, eps)


class RMSNorm(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                  requires_grad=False)

    def forward(self, x, eps=1e-6):
        return rmsnorm(x, self.scale, eps)


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------


def embed(table, tokens):
    return table[tokens]


class Embedding(nn.Module):
    def __init__(self, vocab, d, dtype, device, generator=None):
        super().__init__()
        self.table = normal_param((vocab, d), dtype, device, generator)

    def forward(self, tokens):
        return embed(self.table, tokens)


class LMHead(nn.Module):
    """Holds the output projection ``w`` (d, V); ``Model._logits`` applies it."""

    def __init__(self, d, vocab, dtype, device, generator=None):
        super().__init__()
        self.w = normal_param((d, vocab), dtype, device, generator)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def linear(x, w):
    """x (..., D) @ w (D, F).  A three-dim DTensor ``x`` (a sharded model's
    activations) goes through a batched product instead: the product's
    flattening of (B, S) into rows is refused by DTensor's view rules when S
    is sharded (sequence parallelism), in PyTorch 2.11 at least."""
    if x.dim() == 3 and is_distributed(x):
        return torch.bmm(x, w.unsqueeze(0).expand(x.shape[0], *w.shape))
    return x @ w


def mlp(x, wi_gate, wi_up, wo):
    h = F.silu(linear(x, wi_gate)) * linear(x, wi_up)
    return linear(h, wo)


class MLP(nn.Module):
    def __init__(self, d, f, dtype, device, generator=None):
        super().__init__()
        self.wi_gate = normal_param((d, f), dtype, device, generator)
        self.wi_up = normal_param((d, f), dtype, device, generator)
        self.wo = normal_param((f, d), dtype, device, generator)

    def forward(self, x):
        return mlp(x, self.wi_gate, self.wi_up, self.wo)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(d_head, theta, device=None):
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta):
    """x: (..., S, H, d_head); positions: broadcastable to (..., S).

    Rotates split halves (``[x1, x2]`` with ``x1 = x[..., :d/2]``), not
    interleaved pairs, as the JAX package does.
    """
    d_head = x.shape[-1]
    inv = rope_freqs(d_head, theta, x.device)               # (d_head/2,)
    ang = positions[..., None].to(torch.float32) * inv      # (..., S, d/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
