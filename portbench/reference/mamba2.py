"""Plain reference of Mamba-2 (arXiv:2405.21060), in float32, one sequence
at a time.

Each layer: RMS norm; projections to z, x, B, C and dt; a causal depthwise
conv of width K with bias and SiLU on x, B and C; dt = softplus(dt + bias),
A = -exp(A_log); the SSD scan from a zero state in the paper's chunked
form (its ``ssd_minimal_discrete`` listing, with one group of B and C);
the D skip; a norm of y · silu(z); the output projection and the residual.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import Precision, layer_weights, logits, rmsnorm


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., T) -> (..., T, T): sum of x over (j, i] below the diagonal, -inf above."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd(x, a, b, c, chunk: int):
    """The chunked SSD scan from a zero state.  x (S, H, P) already times dt;
    a (S, H) = A·dt; b, c (S, N).  Returns y (S, H, P)."""
    s = x.shape[0]
    pad = -s % chunk
    if pad:
        x, a, b, c = (F.pad(t, (0, 0) * (t.dim() - 1) + (0, pad)) for t in (x, a, b, c))
    nc = x.shape[0] // chunk
    x = x.view(nc, chunk, *x.shape[1:])                 # (c, l, h, p)
    b = b.view(nc, chunk, -1)                           # (c, l, n)
    c = c.view(nc, chunk, -1)
    a = a.view(nc, chunk, -1).permute(2, 0, 1)          # (h, c, l)
    a_cum = torch.cumsum(a, dim=-1)
    # 1. within each chunk
    decay = torch.exp(segsum(a))                        # (h, c, l, s)
    cb = torch.einsum("cln,csn->cls", c, b)
    y = torch.einsum("hcls,cshp->clhp", decay * cb[None], x)
    # 2. each chunk's state from its own inputs
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)   # (h, c, l)
    states = torch.einsum("cln,hcl,clhp->chpn", b, decay_states, x)
    # 3. the states passed between chunks
    states = torch.cat([torch.zeros_like(states[:1]), states], dim=0)
    decay_chunk = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))   # (h, c+1, c+1)
    states = torch.einsum("hzc,chpn->zhpn", decay_chunk, states)[:-1]
    # 4. each chunk's incoming state to its outputs
    y = y + torch.einsum("cln,chpn,hcl->clhp", c, states, torch.exp(a_cum))
    return y.reshape(nc * chunk, *y.shape[2:])[:s]


def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (S, C), w (C, K) -> (S, C)."""
    k = w.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[j:j + x.shape[0]] * w[:, j].float() for j in range(k)) + bias.float()


def mixer(w: dict, x: torch.Tensor, cfg: dict, prec: Precision) -> torch.Tensor:
    s = x.shape[0]
    p = cfg["ssm_head_dim"]
    hx = rmsnorm(x, w["mixer.norm.scale"], cfg["norm_eps"])
    z = prec.mm(hx, w["mixer.wz"])
    xs = F.silu(causal_conv(prec.mm(hx, w["mixer.wx"]), w["mixer.conv_x"], w["mixer.bias_x"]))
    b = F.silu(causal_conv(prec.mm(hx, w["mixer.wb"]), w["mixer.conv_b"], w["mixer.bias_b"]))
    c = F.silu(causal_conv(prec.mm(hx, w["mixer.wc"]), w["mixer.conv_c"], w["mixer.bias_c"]))
    dt = F.softplus(prec.mm(hx, w["mixer.wdt"]) + w["mixer.dt_bias"].float())   # (S, H)
    a = -torch.exp(w["mixer.A_log"].float())
    xs = xs.view(s, -1, p)
    y = ssd(xs * dt[..., None], dt * a, b, c, cfg["ssm_chunk"])
    y = y + xs * w["mixer.D"].float()[:, None]
    g = y.reshape(s, -1) * F.silu(z)
    return prec.mm(rmsnorm(g, w["mixer.gated_norm.scale"], cfg["norm_eps"]), w["mixer.out_proj"])


def served_logits(weights: dict, cfg: dict, prompt: torch.Tensor, served: torch.Tensor,
                  prec: Precision = Precision()) -> torch.Tensor:
    """Logits (n, V) that predict each of the n served tokens, from one
    causal pass over the prompt and the served tokens before the last."""
    tokens = torch.cat([prompt, served[:-1]]).long()
    x = weights["embed.table"][tokens].float()
    for i in range(cfg["n_layers"]):
        x = x + mixer(layer_weights(weights, f"stack.layers.{i}."), x, cfg, prec)
    return logits(weights, x[prompt.numel() - 1:], cfg["norm_eps"], prec)
