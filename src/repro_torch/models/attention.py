"""GQA attention: full-sequence (prefill) and single-token decode paths.

Port of ``repro/models/attention.py``.  The full-sequence path runs either
the plain grouped computation (``impl="xla"``, the path the JAX package
leaves to XLA) or the flash-attention kernel K3 (``impl="flash"``,
``kernels.flash_attention``).  Decode attention is plain PyTorch in both
modes, as in the reference.

Weights keep the reference layouts: ``wq`` (d, H, dh), ``wk``/``wv``
(d, Hkv, dh), ``wo`` (H, dh, d).  A cache is ``{"k", "v"}`` of shape
(B, S, Hkv, dh).  Unlike the JAX package, ``decode_attention`` writes the new
token's K/V into the cache in place (the reference returns a new cache and
the engine donates the old one); it returns the same dict.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attention import NEG_INF, flash_attention
from repro_torch.models.layers import RMSNorm, apply_rope, normal_param


class Attention(nn.Module):
    def __init__(self, cfg, dtype, device, generator=None):
        super().__init__()
        d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        self.norm = RMSNorm(d, dtype, device)
        self.wq = normal_param((d, h, dh), dtype, device, generator)
        self.wk = normal_param((d, hkv, dh), dtype, device, generator)
        self.wv = normal_param((d, hkv, dh), dtype, device, generator)
        self.wo = normal_param((h, dh, d), dtype, device, generator)


def _project(p: Attention, x, cfg):
    """x (B, S, D) -> q (B,S,H,dh), k, v (B,S,Hkv,dh), all contiguous."""
    b, s, d = x.shape
    hx = p.norm(x, cfg.norm_eps)
    q = (hx @ p.wq.reshape(d, -1)).view(b, s, cfg.n_heads, cfg.d_head)
    k = (hx @ p.wk.reshape(d, -1)).view(b, s, cfg.n_kv_heads, cfg.d_head)
    v = (hx @ p.wv.reshape(d, -1)).view(b, s, cfg.n_kv_heads, cfg.d_head)
    return q, k, v


def _out(p: Attention, o):
    b, s, h, dh = o.shape
    return o.reshape(b, s, h * dh) @ p.wo.reshape(h * dh, -1)


def _gqa_attend(q, k, v, scale, mask):
    """Grouped attention without materialising repeated K/V heads.

    q: (B, Sq, H, dh); k, v: (B, Skv, Hkv, dh); mask: (Sq, Skv) bool or
    broadcastable to (B, Hkv, rep, Sq, Skv).  The logits are formed in the
    input dtype and only then cast to fp32, as the reference does.
    """
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    q5 = q.reshape(b, sq, hkv, rep, dh)
    logits = torch.einsum("bqkrd,bskd->bkrqs", q5, k).to(torch.float32) * scale
    if mask.dim() == 2:                  # (Sq, Skv) shared mask
        mask = mask[None, None, None]
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bkrqs,bskd->bqkrd", p, v)
    return o.reshape(b, sq, h, dh)


def full_attention(p: Attention, x, cfg, *, window=0, positions=None, impl="xla",
                   attn_block_q=256, attn_block_kv=256):
    """Causal (optionally sliding-window) self attention over the whole seq.

    x: (B, S, D) -> (out (B, S, D), cache {k, v}: (B, S, Hkv, dh))
    """
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    cache = {"k": k, "v": v}
    if impl == "flash":
        o = flash_attention(q, k, v, causal=True, window=window,
                            block_q=attn_block_q, block_kv=attn_block_kv)
    elif impl == "xla":
        idx_q = torch.arange(s, device=x.device)[:, None]
        idx_k = torch.arange(s, device=x.device)[None, :]
        mask = idx_k <= idx_q
        if window:
            mask &= (idx_q - idx_k) < window
        o = _gqa_attend(q, k, v, cfg.d_head ** -0.5, mask)
    else:
        raise ValueError(f"attn_impl {impl!r}: want 'xla' or 'flash'")
    return _out(p, o), cache


def decode_attention(p: Attention, x, cache, pos, cfg, *, window=0):
    """One-token decode against a (B, S_max, Hkv, dh) cache, updated in place.

    x: (B, 1, D); pos: an int (aligned batch decode) or a (B,) tensor of
    per-row positions (continuous batching: each row writes and attends at
    its own causal frontier).  Returns (out (B, 1, D), cache).
    """
    b = x.shape[0]
    s_max = cache["k"].shape[1]
    per_slot = torch.is_tensor(pos) and pos.dim() > 0
    q, k_new, v_new = _project(p, x, cfg)
    if per_slot:
        posb = pos.to(device=x.device, dtype=torch.long).reshape(b, 1)
    else:
        posb = torch.full((b, 1), int(pos), dtype=torch.long, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k_new = apply_rope(k_new, posb, cfg.rope_theta)

    if per_slot:
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, posb[:, 0]] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][rows, posb[:, 0]] = v_new[:, 0].to(cache["v"].dtype)
    else:
        cache["k"][:, int(pos)] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, int(pos)] = v_new[:, 0].to(cache["v"].dtype)

    idx = torch.arange(s_max, device=x.device)[None, :]
    mask = idx <= posb                   # (B, S): per-row causal frontier
    if window:
        mask &= (posb - idx) < window
    mask = mask[:, None, None, None, :]  # (B, 1, 1, 1, S) over (b,k,r,q,s)
    o = _gqa_attend(q, cache["k"], cache["v"], cfg.d_head ** -0.5, mask)
    return _out(p, o), cache


def empty_cache(cfg, batch, seq_len, dtype, device):
    shp = (batch, seq_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}
