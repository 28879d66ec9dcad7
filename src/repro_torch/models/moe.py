"""Fine-grained Mixture-of-Experts FFN, DeepSeek-MoE style (port of ``repro/models/moe.py``).

Top-k routing with the weights renormalised over the selected experts,
per-expert capacity with over-capacity tokens dropped to a sentinel slot
(they fall through the residual connection), optional shared experts, as
the reference does with one dispatch group (g = 1: no sharding policy yet).

Routing goes through the gating kernel K5 (``kernels.topk_gating``): softmax
over the experts, then the top k, with ties to the lower expert index as
``lax.top_k`` orders them.  A CPU tensor takes its plain version.  The
router and its logits stay fp32.  The expert products are batched matrix
products (``torch.bmm``), left to the library as the reference leaves them
to XLA.

``moe_ffn`` also returns the Switch load-balance auxiliary loss,
E · Σ_e mean(p_e) · mean(sel_e) / k, as the reference does.  It needs the
full softmax over the experts, which K5 does not return, so the loss takes
a plain ``softmax`` of the same fp32 logits beside K5 (a K5 that also
emits per-expert sums is queued in ROADMAP).  Serving does not want the
loss: with ``want_aux=False`` it is not computed and ``None`` comes back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.topk_gating import topk_gating
from repro_torch.models.layers import MLP, RMSNorm, mlp, normal_param, rmsnorm


class Experts(nn.Module):
    """The routed experts' stacked weights: (E, d, f), (E, d, f), (E, f, d)."""

    def __init__(self, e, d, f, dtype, device, generator=None):
        super().__init__()
        self.wi_gate = normal_param((e, d, f), dtype, device, generator)
        self.wi_up = normal_param((e, d, f), dtype, device, generator)
        self.wo = normal_param((e, f, d), dtype, device, generator)


class MoE(nn.Module):
    def __init__(self, cfg, dtype, device, generator=None):
        super().__init__()
        d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.norm = RMSNorm(d, dtype, device)
        self.router = normal_param((d, e), torch.float32, device, generator)
        self.experts = Experts(e, d, f, dtype, device, generator)
        if cfg.n_shared_experts:
            self.shared = MLP(d, cfg.n_shared_experts * f, dtype, device, generator)


def expert_capacity(n_tokens, cfg):
    c = int(n_tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts)
    c = max(c, cfg.moe_top_k)
    return -(-c // 8) * 8  # round up to a multiple of 8


def _rank_in_expert(flat_ids, e):
    """Position of each assignment within its expert's arrival order.

    flat_ids: (A,) integer expert ids.  Returns (A,) int64 ranks, through a
    stable sort as the reference does.
    """
    a = flat_ids.shape[0]
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    seg_starts = torch.searchsorted(sorted_ids, torch.arange(e, device=flat_ids.device,
                                                             dtype=sorted_ids.dtype))
    rank_sorted = torch.arange(a, device=flat_ids.device) - seg_starts[sorted_ids]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    return rank


def switch_aux_loss(gate_logits, top_ids, e, k):
    """E · Σ_e mean_t(softmax_e) · mean_t(selected_e) / k (Switch, fp32)."""
    me = torch.softmax(gate_logits, dim=-1).mean(dim=0)
    ce = F.one_hot(top_ids, e).to(torch.float32).sum(dim=1).mean(dim=0) / k
    return e * torch.sum(me * ce)


def moe_ffn(p: MoE, x, cfg, want_aux: bool = True):
    """x: (B, S, D) -> (out (B, S, D), aux loss | None): routed plus shared
    experts, and the Switch loss when ``want_aux``."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    t = b * s
    c = expert_capacity(t, cfg)

    h = rmsnorm(x, p.norm.scale, cfg.norm_eps)
    xt = h.reshape(t, d)
    gate_logits = xt.float() @ p.router                      # (T, E) fp32
    top_p, top_ids = topk_gating(gate_logits, k)             # K5
    weights = top_p / top_p.sum(dim=-1, keepdim=True)

    top_ids = top_ids.long()
    aux = switch_aux_loss(gate_logits, top_ids, e, k) if want_aux else None
    rank = _rank_in_expert(top_ids.reshape(t * k), e).reshape(t, k)
    keep = rank < c
    slot = torch.where(keep, top_ids * c + rank, e * c)      # drops -> sentinel

    # dispatch: each kept assignment owns its slot, so the reference's
    # scatter-add of the token is a copy.  Every assignment is copied, the
    # dropped ones into the sentinel row e·c, which is then cut off: the
    # shapes stay static (no boolean mask, so no device-to-host sync, and
    # the build on the meta device can run it)
    buf = torch.zeros((e * c + 1, d), dtype=xt.dtype, device=x.device)
    buf.index_copy_(0, slot.reshape(t * k),
                    xt[:, None, :].expand(t, k, d).reshape(t * k, d))
    buf = buf[:e * c].reshape(e, c, d)

    we = p.experts
    y = torch.bmm(F.silu(torch.bmm(buf, we.wi_gate)) * torch.bmm(buf, we.wi_up), we.wo)

    # combine: each token pulls its k expert outputs (the sentinel row is 0)
    y_flat = torch.cat([y.reshape(e * c, d), y.new_zeros((1, d))], dim=0)
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for i in range(k):
        out = out + y_flat[slot[:, i]] * (weights[:, i, None] * keep[:, i, None]).to(x.dtype)
    out = out.reshape(b, s, d)
    if cfg.n_shared_experts:
        out = out + mlp(h, p.shared.wi_gate, p.shared.wi_up, p.shared.wo)
    return out, aux
