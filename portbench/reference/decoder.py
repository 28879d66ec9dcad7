"""Plain reference of a decoder of attention layers with dense or
mixture-of-experts FFNs (DeepSeek-MoE), in float32, one sequence at a time.

Follows the published description as the configuration states it:
pre-norm layers (RMS norm), multi-head attention with rotary embeddings
over split halves, SwiGLU FFNs; a MoE FFN routes each token by a softmax
over the experts to its top k, with the k weights renormalised, adds the
shared experts, and drops assignments over an expert's capacity of
``capacity_factor`` · T · k / E (rounded up to 8, at least k) in the
prompt, which the server prefills as one group.  Each later position is a
token of its own there, which never exceeds a capacity.
"""
from __future__ import annotations

import torch

from portbench.flops import layer_kinds
from portbench.reference.common import Precision, layer_weights, logits, rmsnorm, swiglu

QUERY_BLOCK = 1024       # query rows whose scores are formed at once


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over split halves.  x: (S, H, dh), positions 0..S-1."""
    s, _, dh = x.shape
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float64, device=x.device) / dh)
    ang = (torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(w: dict, x: torch.Tensor, cfg: dict, prec: Precision) -> torch.Tensor:
    s, d = x.shape
    h, hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    hx = rmsnorm(x, w["mixer.norm.scale"], cfg["norm_eps"])
    q = rope(prec.mm(hx, w["mixer.wq"].reshape(d, -1)).view(s, h, dh), cfg["rope_theta"])
    k = rope(prec.mm(hx, w["mixer.wk"].reshape(d, -1)).view(s, hkv, dh), cfg["rope_theta"])
    v = prec.mm(hx, w["mixer.wv"].reshape(d, -1)).view(s, hkv, dh)
    k = k.repeat_interleave(h // hkv, dim=1).transpose(0, 1)          # (H, S, dh)
    v = v.repeat_interleave(h // hkv, dim=1).transpose(0, 1)
    out = torch.empty((s, h, dh), dtype=torch.float32, device=x.device)
    keys = torch.arange(s, device=x.device)
    for lo in range(0, s, QUERY_BLOCK):
        hi = min(s, lo + QUERY_BLOCK)
        scores = torch.einsum("qhd,hkd->hqk", q[lo:hi], k[:, :hi]) * dh ** -0.5
        mask = keys[None, :hi] <= torch.arange(lo, hi, device=x.device)[:, None]
        p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        out[lo:hi] = torch.einsum("hqk,hkd->qhd", p, v[:, :hi])
    return prec.mm(out.reshape(s, h * dh), w["mixer.wo"].reshape(h * dh, d))


def capacity(n_tokens: int, cfg: dict) -> int:
    c = int(n_tokens * cfg["moe_top_k"] * cfg["capacity_factor"] / cfg["n_experts"])
    c = max(c, cfg["moe_top_k"])
    return -(-c // 8) * 8


def moe(w: dict, x: torch.Tensor, cfg: dict, prompt_len: int, prec: Precision) -> torch.Tensor:
    e, k = cfg["n_experts"], cfg["moe_top_k"]
    hx = rmsnorm(x, w["ffn.norm.scale"], cfg["norm_eps"])
    probs = torch.softmax(prec.mm(hx, w["ffn.router"]), dim=-1)
    top_p, top_ids = torch.topk(probs, k, dim=-1)
    gate = top_p / top_p.sum(dim=-1, keepdim=True)
    # the prompt's assignments in arrival order (token, then rank k): those
    # past their expert's capacity are dropped
    keep = torch.ones_like(gate, dtype=torch.bool)
    ids = top_ids[:prompt_len].reshape(-1)
    onehot = torch.nn.functional.one_hot(ids, e)
    rank = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)
    keep[:prompt_len] = (rank < capacity(prompt_len, cfg)).view(prompt_len, k)
    out = torch.zeros_like(x)
    for ex in range(e):
        rows, slot = torch.nonzero((top_ids == ex) & keep, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = swiglu(hx[rows], w["ffn.experts.wi_gate"][ex], w["ffn.experts.wi_up"][ex],
                   w["ffn.experts.wo"][ex], prec)
        out.index_add_(0, rows, y * gate[rows, slot, None])
    if cfg["n_shared_experts"]:
        out = out + swiglu(hx, w["ffn.shared.wi_gate"], w["ffn.shared.wi_up"],
                           w["ffn.shared.wo"], prec)
    return out


def served_logits(weights: dict, cfg: dict, prompt: torch.Tensor, served: torch.Tensor,
                  prec: Precision = Precision()) -> torch.Tensor:
    """Logits (n, V) that predict each of the n served tokens, from one
    causal pass over the prompt and the served tokens before the last."""
    tokens = torch.cat([prompt, served[:-1]]).long()
    plen = prompt.numel()
    x = weights["embed.table"][tokens].float()
    for i, (_, ffn) in enumerate(layer_kinds(cfg)):
        w = layer_weights(weights, f"stack.layers.{i}.")
        x = x + attention(w, x, cfg, prec)
        if ffn == "dense":
            x = x + swiglu(rmsnorm(x, w["ffn.norm.scale"], cfg["norm_eps"]), w["ffn.mlp.wi_gate"],
                           w["ffn.mlp.wi_up"], w["ffn.mlp.wo"], prec)
        elif ffn == "moe":
            x = x + moe(w, x, cfg, plen, prec)
    return logits(weights, x[plen - 1:], cfg["norm_eps"], prec)
