"""Decoder stack (port of ``repro/models/transformer.py``).

The JAX package scans over stacked pattern groups; here the layers are an
``nn.ModuleList`` in layer order and the scan is a Python loop.  The order
is the reference's ``_sections``: the deviant ``head_layers/g*`` groups, then
the homogeneous ``scan`` groups, then the ``tail`` remainder.
``Stack.layout`` records, for each layer, where the reference keeps its
weights (section, group index within a scanned section, position in the
group), which is what ``models.convert`` uses to carry weights and caches
across.  Caches are a list with one dict per layer: ``{"k", "v"}`` for an
attention mixer, ``{"state", "conv"}`` for a Mamba-2 mixer.

Mixers: ``attn``, ``attn_local`` (``models.attention``) and ``mamba``
(``models.mamba2``); FFNs: ``dense``, ``moe`` (``models.moe``) and ``none``.
Each mixer's and FFN's output is added to the residual stream times the
configuration's ``residual_multiplier`` (1 by default: a plain add).

Training (``forward_full`` without caches, with gradients on) sums the MoE
layers' auxiliary losses and checkpoints activations per layer as
``flags.remat`` says, the counterpart of the reference's ``jax.checkpoint``
of its scan body: ``none`` keeps every activation; ``full`` keeps only
each layer's input and recomputes the layer in the backward pass;
``selective`` does the same but also keeps the outputs of the plain matrix
products (``aten.mm``/``addmm``, products without batch dimensions), the
counterpart of ``dots_with_no_batch_dims_saveable``.  The recompute runs
the same operations on the same inputs, so the three modes give the same
losses and gradients bit for bit on a deterministic device.

Under a sharding policy (``parallel.sharding``; the parameters and inputs
are DTensors) the residual stream is moved to the reference's placements
after each mixer and each FFN (``constrain_residual``, the reference's
``transformer.py:64-73``).  The Mamba-2 mixer, whose work is per sequence,
runs on each rank's rows and, where the model axis divides its heads, on
that rank's heads, with the weights in the reference's placements
(``mamba2.mamba_block_sharded``): its plain path or K4 sees plain local
tensors of H/tp heads, and its output is summed over model.  Its decode
step (``mamba2.mamba_decode_sharded``) runs the same way against the
cache in ``cache_spec``'s placements; the attention layers' K3 takes each
rank's block under every placement the rules give
(``attention._flash_blocks``).
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import trace
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, mamba2, moe
from repro_torch.models.layers import MLP, RMSNorm
from repro_torch.parallel.sharding import is_distributed, maybe_context


class DenseFFN(nn.Module):
    def __init__(self, cfg, dtype, device, generator=None):
        super().__init__()
        f = cfg.d_ff if cfg.d_ff else cfg.moe_d_ff
        self.norm = RMSNorm(cfg.d_model, dtype, device)
        self.mlp = MLP(cfg.d_model, f, dtype, device, generator)

    def forward(self, x, eps):
        return self.mlp(self.norm(x, eps))


class Layer(nn.Module):
    def __init__(self, spec, cfg, dtype, device, generator=None, index=0):
        super().__init__()
        self.cfg = cfg
        self.index = index                 # the layer's place in the stack, for its spans
        self.is_attn = spec.mixer in ("attn", "attn_local")
        self.mixer_span = "layer.attn" if self.is_attn else "layer.mamba"
        self.window = cfg.sliding_window if spec.mixer == "attn_local" else 0
        if self.is_attn:
            self.mixer = attention.Attention(cfg, dtype, device, generator)
        else:
            self.mixer = mamba2.Mamba(cfg, dtype, device, generator)
        self.ffn_kind = spec.ffn
        if spec.ffn == "dense":
            self.ffn = DenseFFN(cfg, dtype, device, generator)
        elif spec.ffn == "moe":
            self.ffn = moe.MoE(cfg, dtype, device, generator)

    def _residual(self, x, h):
        """x + r · h, r the configuration's ``residual_multiplier`` (1: x + h)."""
        r = self.cfg.residual_multiplier
        return x + h if r == 1.0 else x + h * r

    def _ffn(self, x, want_aux=False, policy=None, grouped=True):
        """(x + r · ffn(x), the MoE's aux loss or None)."""
        if self.ffn_kind not in ("dense", "moe"):
            return x, None
        with trace.span("layer.ffn", self.index):
            if self.ffn_kind == "dense":
                x = self._residual(x, self.ffn(x, self.cfg.norm_eps))
                aux = None
            else:
                y, aux = moe.moe_ffn(self.ffn, x, self.cfg, want_aux=want_aux, policy=policy,
                                     grouped=grouped)
                x = self._residual(x, y)
        if policy is not None:
            x = policy.constrain_residual(x)
        return x, aux

    def full(self, x, flags, want_aux=False, policy=None, want_cache=True):
        """Full-seq layer.  Returns (x, aux | None, cache | None)."""
        with trace.span(self.mixer_span, self.index):
            if self.is_attn:
                h, cache = attention.full_attention(
                    self.mixer, x, self.cfg, window=self.window, impl=flags.attn_impl,
                    attn_block_q=flags.attn_block_q, attn_block_kv=flags.attn_block_kv,
                    policy=policy)
            elif policy is not None and is_distributed(x):
                h, cache = mamba2.mamba_block_sharded(policy, self.mixer, x, self.cfg,
                                                      flags.ssd_impl, want_cache)
            else:
                h, cache = mamba2.mamba_block(self.mixer, x, self.cfg, impl=flags.ssd_impl)
        x = self._residual(x, h)
        if policy is not None:
            x = policy.constrain_residual(x)
        x, aux = self._ffn(x, want_aux, policy)
        return x, aux, cache

    def decode(self, x, cache, pos, policy=None):
        with trace.span(self.mixer_span, self.index):
            if self.is_attn:
                h, cache = attention.decode_attention(self.mixer, x, cache, pos, self.cfg,
                                                      window=self.window)
            elif is_distributed(x):
                h, cache = mamba2.mamba_decode_sharded(policy, self.mixer, x, cache, self.cfg)
            else:
                h, cache = mamba2.mamba_decode(self.mixer, x, cache, self.cfg)
        # the reference's decode MoE takes one dispatch group (policy None there)
        return self._ffn(self._residual(x, h), policy=policy, grouped=False)[0], cache


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


_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    """The selective policy: keep the plain matrix products, recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _train_layer(layer, flags, x, policy=None):
    # under the policy's context also when remat recomputes it in a backward pass
    with maybe_context(policy):
        x, aux, _ = layer.full(x, flags, want_aux=True, policy=policy, want_cache=False)
    return x, aux


class Stack(nn.Module):
    """The decoder layers, in the reference's section order."""

    def __init__(self, cfg: ArchConfig, dtype, device, generator=None):
        super().__init__()
        self.layout = layer_layout(cfg)
        self.layers = nn.ModuleList(
            Layer(spec, cfg, dtype, device, generator, index=i)
            for i, (*_, spec) in enumerate(self.layout))

    def forward_full(self, x, flags, want_cache: bool, policy=None):
        """x: (B,S,D) embedded input -> (hidden (B,S,D), aux_total, caches | None).

        With ``want_cache`` (prefill) the layers return their caches and no
        aux loss is computed (``aux_total`` is None).  Without it (the training
        forward) the MoE layers' aux losses are summed in fp32 and, when
        gradients are on, each layer is checkpointed as ``flags.remat``
        says."""
        if want_cache:
            caches = []
            for layer in self.layers:
                x, _, c = layer.full(x, flags, policy=policy)
                caches.append(c)
            return x, None, caches
        if flags.remat not in ("none", "selective", "full"):
            raise ValueError(f"remat {flags.remat!r}: want 'none', 'selective' or 'full'")
        remat = flags.remat != "none" and torch.is_grad_enabled()
        kwargs = {}
        if flags.remat == "selective":
            kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                     _save_products)
        aux_total = x.new_zeros((), dtype=torch.float32)
        for layer in self.layers:
            if remat:
                x, aux = checkpoint(_train_layer, layer, flags, x, policy,
                                    use_reentrant=False, **kwargs)
            else:
                x, aux = _train_layer(layer, flags, x, policy)
            if aux is not None:
                aux_total = aux_total + aux
        return x, aux_total, None

    def forward_decode(self, x, caches, pos, policy=None):
        """x: (B,1,D) -> (hidden (B,1,D), caches), caches updated in place."""
        for layer, c in zip(self.layers, caches):
            x, _ = layer.decode(x, c, pos, policy)
        return x, caches


def empty_caches(cfg, batch, seq_len, dtype, device):
    return [attention.empty_cache(cfg, batch, seq_len, dtype, device)
            if spec.mixer in ("attn", "attn_local")
            else mamba2.empty_mamba_cache(cfg, batch, device)
            for *_, spec in layer_layout(cfg)]
