"""Decoder stack (port of ``repro/models/transformer.py``).

The JAX package scans over stacked pattern groups; here the layers are an
``nn.ModuleList`` in layer order and the scan is a Python loop.  The order
is the reference's ``_sections``: the deviant ``head_layers/g*`` groups, then
the homogeneous ``scan`` groups, then the ``tail`` remainder.
``Stack.layout`` records, for each layer, where the reference keeps its
weights (section, group index within a scanned section, position in the
group), which is what ``models.convert`` uses to carry weights and caches
across.  Caches are a list with one ``{"k", "v"}`` dict per layer.

This slice ports attention mixers (``attn``, ``attn_local``) with dense
FFNs.  Mamba-2 mixers and MoE FFNs raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention
from repro_torch.models.layers import MLP, RMSNorm

_NOT_PORTED = {
    "mamba": "Mamba-2 mixers are not ported yet (ROADMAP Queue 1, slice 3: "
             "models/mamba2.py with the SSD kernel K4)",
    "moe": "MoE FFNs are not ported yet (ROADMAP Queue 1, slice 4: "
           "models/moe.py with the gating kernel K5)",
}


class DenseFFN(nn.Module):
    def __init__(self, cfg, dtype, device, generator=None):
        super().__init__()
        f = cfg.d_ff if cfg.d_ff else cfg.moe_d_ff
        self.norm = RMSNorm(cfg.d_model, dtype, device)
        self.mlp = MLP(cfg.d_model, f, dtype, device, generator)

    def forward(self, x, eps):
        return self.mlp(self.norm(x, eps))


class Layer(nn.Module):
    def __init__(self, spec, cfg, dtype, device, generator=None):
        super().__init__()
        if spec.mixer not in ("attn", "attn_local"):
            raise NotImplementedError(_NOT_PORTED["mamba"])
        if spec.ffn != "dense":
            raise NotImplementedError(_NOT_PORTED.get(spec.ffn, f"ffn {spec.ffn!r}"))
        self.cfg = cfg
        self.window = cfg.sliding_window if spec.mixer == "attn_local" else 0
        self.mixer = attention.Attention(cfg, dtype, device, generator)
        self.ffn = DenseFFN(cfg, dtype, device, generator)

    def full(self, x, flags):
        """Full-seq layer.  Returns (x, cache)."""
        h, cache = attention.full_attention(
            self.mixer, x, self.cfg, window=self.window, impl=flags.attn_impl,
            attn_block_q=flags.attn_block_q, attn_block_kv=flags.attn_block_kv)
        x = x + h
        return x + self.ffn(x, self.cfg.norm_eps), cache

    def decode(self, x, cache, pos):
        h, cache = attention.decode_attention(self.mixer, x, cache, pos, self.cfg,
                                              window=self.window)
        x = x + h
        return x + self.ffn(x, self.cfg.norm_eps), cache


def _group_layout(cfg: ArchConfig):
    g = len(cfg.pattern)
    return cfg.n_layers // g, cfg.n_layers % g  # (n_full_groups, remainder)


def sections(cfg: ArchConfig):
    """(section, group_specs, scanned?) in layer order, as the reference."""
    n_groups, rem = _group_layout(cfg)
    specs = cfg.layer_specs()
    base = tuple(cfg.pattern)
    out = []
    deviant = [gi for gi in range(n_groups)
               if tuple(specs[gi * len(base): (gi + 1) * len(base)]) != base]
    for gi in deviant:
        out.append((f"head_layers/g{gi}", specs[gi * len(base): (gi + 1) * len(base)], False))
    n_homog = n_groups - len(deviant)
    if n_homog:
        out.append(("scan", base, True))
    if rem:
        out.append(("tail", specs[-rem:], False))
    return out


def layer_layout(cfg: ArchConfig) -> List[Tuple[str, Optional[int], int, object]]:
    """Per layer in execution order: (section, scan group or None, index in group, spec)."""
    n_groups, _ = _group_layout(cfg)
    secs = sections(cfg)
    n_homog = n_groups - sum(1 for name, _, _ in secs if name.startswith("head_layers/"))
    out = []
    for name, gspecs, scanned in secs:
        if scanned:
            for g in range(n_homog):
                out.extend((name, g, i, s) for i, s in enumerate(gspecs))
        else:
            out.extend((name, None, i, s) for i, s in enumerate(gspecs))
    return out


class Stack(nn.Module):
    """The decoder layers, in the reference's section order."""

    def __init__(self, cfg: ArchConfig, dtype, device, generator=None):
        super().__init__()
        self.layout = layer_layout(cfg)
        self.layers = nn.ModuleList(
            Layer(spec, cfg, dtype, device, generator) for *_, spec in self.layout)

    def forward_full(self, x, flags, want_cache: bool):
        """x: (B,S,D) embedded input -> (hidden (B,S,D), caches | None)."""
        caches = []
        for layer in self.layers:
            x, c = layer.full(x, flags)
            if want_cache:
                caches.append(c)
        return x, (caches if want_cache else None)

    def forward_decode(self, x, caches, pos):
        """x: (B,1,D) -> (hidden (B,1,D), caches), caches updated in place."""
        for layer, c in zip(self.layers, caches):
            x, _ = layer.decode(x, c, pos)
        return x, caches


def empty_caches(cfg, batch, seq_len, dtype, device):
    return [attention.empty_cache(cfg, batch, seq_len, dtype, device)
            for _ in layer_layout(cfg)]
