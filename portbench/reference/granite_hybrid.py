"""Plain reference of a GraniteMoeHybrid model (granite-4.0-h), in float32,
one sequence at a time.

Follows the published equations (the model's config.json and its
``granitemoehybrid`` modelling), with r = ``residual_multiplier``:

    x0 = embedding_multiplier · embed(tokens)
    h  = x + r · mixer(rmsnorm(x))                  (Mamba-2, or attention)
    x' = h + r · (moe(rmsnorm(h)) + shared(rmsnorm(h)))
    logits = head(rmsnorm(x_L)) / logits_scaling    (head tied to the embedding)

The Mamba-2 mixer is ``reference.mamba2.mixer`` (its norm, projections
without bias, a causal conv with bias, the chunked SSD scan, the D skip, the
gated RMS norm and the output projection).  Attention is grouped-query
(``n_heads`` over ``n_kv_heads``) with no positional encoding
(``position_embedding_type`` "nope") and softmax scale ``attn_scale``
(``attention_multiplier``, 1/128), not d^-1/2; it forms the scores of
``QUERY_BLOCK`` query rows at a time, so that an 8192-token prompt fits
beside the served model's weights.  The MoE is ``reference.decoder.moe``:
a linear router to E logits, the softmax over the top k of them (which is
the softmax over all E renormalised over the top k, as that function
computes it), SwiGLU experts, and the shared SwiGLU MLP of width
``n_shared_experts`` · ``moe_d_ff`` on the same normed input.

Departures from the published model, each the configuration's: the
prompt's assignments past an expert's capacity (``capacity_factor`` 1.25,
the prompt one dispatch group) are dropped as the server drops them, where
the published model drops none; the weights are the benchmark's random
ones (conv biases 0, A = -1, D = 1, dt bias 0).
"""
from __future__ import annotations

import torch

from portbench.flops import layer_kinds
from portbench.reference import decoder, mamba2
from portbench.reference.common import Precision, layer_weights, logits, rmsnorm

QUERY_BLOCK = 512        # query rows whose scores are formed at once


def attention(w: dict, x: torch.Tensor, cfg: dict, prec: Precision) -> torch.Tensor:
    """NoPE grouped-query causal attention over x (S, d), normed inside."""
    s, d = x.shape
    h, hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    hx = rmsnorm(x, w["mixer.norm.scale"], cfg["norm_eps"])
    q = prec.mm(hx, w["mixer.wq"].reshape(d, -1)).view(s, h, dh)
    k = prec.mm(hx, w["mixer.wk"].reshape(d, -1)).view(s, hkv, dh)
    v = prec.mm(hx, w["mixer.wv"].reshape(d, -1)).view(s, hkv, dh)
    k = k.repeat_interleave(h // hkv, dim=1).transpose(0, 1)          # (H, S, dh)
    v = v.repeat_interleave(h // hkv, dim=1).transpose(0, 1)
    out = torch.empty((s, h, dh), dtype=torch.float32, device=x.device)
    keys = torch.arange(s, device=x.device)
    for lo in range(0, s, QUERY_BLOCK):
        hi = min(s, lo + QUERY_BLOCK)
        scores = torch.einsum("qhd,hkd->hqk", q[lo:hi], k[:, :hi]) * cfg["attn_scale"]
        mask = keys[None, :hi] <= torch.arange(lo, hi, device=x.device)[:, None]
        p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        out[lo:hi] = torch.einsum("hqk,hkd->qhd", p, v[:, :hi])
    return prec.mm(out.reshape(s, h * dh), w["mixer.wo"].reshape(h * dh, d))


def served_logits(weights: dict, cfg: dict, prompt: torch.Tensor, served: torch.Tensor,
                  prec: Precision = Precision()) -> torch.Tensor:
    """Logits (n, V) that predict each of the n served tokens, from one
    causal pass over the prompt and the served tokens before the last."""
    tokens = torch.cat([prompt, served[:-1]]).long()
    plen = prompt.numel()
    r = cfg["residual_multiplier"]
    x = weights["embed.table"][tokens].float() * cfg["embedding_multiplier"]
    for i, (mixer, ffn) in enumerate(layer_kinds(cfg)):
        w = layer_weights(weights, f"stack.layers.{i}.")
        if mixer == "mamba":
            x = x + r * mamba2.mixer(w, x, cfg, prec)
        else:
            x = x + r * attention(w, x, cfg, prec)
        if ffn == "moe":
            x = x + r * decoder.moe(w, x, cfg, plen, prec)
    return logits(weights, x[plen - 1:], cfg["norm_eps"], prec) / cfg["logits_scaling"]
