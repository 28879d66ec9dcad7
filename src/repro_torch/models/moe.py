"""Fine-grained Mixture-of-Experts FFN, DeepSeek-MoE style (port of ``repro/models/moe.py``).

Top-k routing with the weights renormalised over the selected experts,
per-expert capacity with over-capacity tokens dropped to a sentinel slot
(they fall through the residual connection), optional shared experts, as
the reference does: one dispatch group on one device, or under a sharding
policy one group per data-parallel rank (``moe_ffn``).

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

import types

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.topk_gating import topk_gating
from repro_torch.models.layers import MLP, RMSNorm, linear, mlp, normal_param, rmsnorm
from repro_torch.parallel.sharding import is_distributed


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


def aux_stats(gate_logits, top_ids, e, k):
    """The Switch loss's two means over the rows: (mean_t(softmax), mean_t(selected) / k)."""
    me = torch.softmax(gate_logits, dim=-1).mean(dim=0)
    ce = F.one_hot(top_ids, e).to(torch.float32).sum(dim=1).mean(dim=0) / k
    return me, ce


def switch_aux_loss(gate_logits, top_ids, e, k):
    """E · Σ_e mean_t(softmax_e) · mean_t(selected_e) / k (Switch, fp32)."""
    me, ce = aux_stats(gate_logits, top_ids, e, k)
    return e * torch.sum(me * ce)


def moe_ffn(p: MoE, x, cfg, want_aux: bool = True, policy=None, grouped: bool = True):
    """x: (B, S, D) -> (out (B, S, D), aux loss | None): routed plus shared
    experts, and the Switch loss when ``want_aux``.

    The dispatch is group-local, as the reference's (``moe.py:67-150``):
    under a sharding policy g = ``policy.moe_groups(B)`` groups of
    contiguous rows, each with its own capacity.  ``grouped=False`` (the
    decode step, as the reference's) keeps one group.  On plain tensors
    under a policy (a build on ``meta`` with a shape-only mesh) the g groups
    are dispatched on the one device."""
    if policy is not None and is_distributed(x):
        return _moe_sharded(p, x, cfg, want_aux, policy, grouped)
    groups = policy.moe_groups(x.shape[0]) if (policy is not None and grouped) else 1
    h = rmsnorm(x, p.norm.scale, cfg.norm_eps)
    out, stats = dispatch(h, linear(h.float(), p.router), cfg, want_aux, groups,
                          lambda buf: expert_products(buf, p.experts))
    out = _with_shared(p, out, h, cfg)
    return out, (None if stats is None else cfg.n_experts * torch.sum(stats[0] * stats[1]))


def _moe_sharded(p, x, cfg, want_aux, policy, grouped):
    """``moe_ffn`` on DTensors.  The norm, the router and the shared experts
    run under DTensor as the reference's do.  The gate logits and the
    normed rows go to each rank's group (its rows over the data axes, the
    reference's ``constrain_tokens_for_moe``) as plain tensors: K5 and the
    dispatch run there.  The expert buffer takes the reference's placement
    (``constrain_expert_buffer``: groups over data, experts over model), so
    each rank runs its own experts on its group's rows with those experts'
    weights gathered over the FSDP axes, and the combine gathers the expert
    outputs over model."""
    split = grouped and policy.row_split(x.shape[0])
    if split:
        x = policy.constrain_tokens_for_moe(x)
    h = rmsnorm(x, p.norm.scale, cfg.norm_eps)
    e = cfg.n_experts

    def experts(buf):
        we = p.experts
        local = types.SimpleNamespace(**{n: policy.expert_weights(getattr(we, n), split)
                                         for n in ("wi_gate", "wi_up", "wo")})
        y = expert_products(policy.expert_block(buf, split, x), local)
        return policy.expert_gather(y, e, split, x)

    out, stats = dispatch(policy.local_rows(h, split),
                          policy.local_rows(linear(h.float(), p.router), split),
                          cfg, want_aux, 1, experts)
    out = _with_shared(p, policy.constrain_residual(policy.from_rows(out, split, x)), h, cfg)
    if stats is None:
        return out, None
    # the means over every group's rows (equal-sized groups), then the product
    me, ce = (policy.from_rows(m[None], split, x).mean(dim=0) for m in stats)
    return out, e * torch.sum(me * ce)


def _with_shared(p, out, h, cfg):
    if cfg.n_shared_experts:
        out = out + mlp(h, p.shared.wi_gate, p.shared.wi_up, p.shared.wo)
    return out


def expert_products(buf, we):
    """SwiGLU of each expert on its rows: buf (E, C, D) -> (E, C, D)."""
    return torch.bmm(F.silu(torch.bmm(buf, we.wi_gate)) * torch.bmm(buf, we.wi_up), we.wo)


def dispatch(h, gate_logits, cfg, want_aux: bool, groups: int, experts):
    """Routing, dispatch and combine on plain tensors: the normed rows h
    (B, S, D) and their fp32 gate logits (B, S, E) -> (out (B, S, D),
    (me, ce) | None), the Switch loss's means when ``want_aux``.  With
    ``groups`` = g the rows form g equal groups of contiguous tokens, each
    dispatched within itself at capacity ``expert_capacity(T / g)``, as the
    reference's group-local dispatch on one device.  ``experts`` maps the
    expert buffer (E, g·C, D) to the experts' outputs of the same shape."""
    b, s, d = h.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    t = b * s
    g = groups
    if t % g:
        raise ValueError(f"{t} tokens do not split into {g} groups")
    tl = t // g
    c = expert_capacity(tl, cfg)

    xt = h.reshape(t, d)
    gate_logits = gate_logits.reshape(t, e)
    top_p, top_ids = topk_gating(gate_logits, k)             # K5
    weights = top_p / top_p.sum(dim=-1, keepdim=True)

    top_ids = top_ids.long()
    stats = aux_stats(gate_logits, top_ids, e, k) if want_aux else None
    # ranks within (group, expert): group i's experts are segments i·E .. i·E + E-1
    gid = torch.arange(t, device=h.device) // tl
    seg = top_ids + (gid * e)[:, None] if g > 1 else top_ids
    rank = _rank_in_expert(seg.reshape(t * k), g * e).reshape(t, k)
    keep = rank < c
    row = e * c + 1                                          # a group's rows, sentinel last
    slot = torch.where(keep, top_ids * c + rank, e * c)      # drops -> sentinel
    if g > 1:
        slot = slot + (gid * row)[:, None]

    # dispatch: each kept assignment owns its slot, so the reference's
    # scatter-add of the token is a copy.  Every assignment is copied, the
    # dropped ones into their group's sentinel row e·c, which is then cut
    # off: the shapes stay static (no boolean mask, so no device-to-host
    # sync, and the build on the meta device can run it)
    buf = torch.zeros((g * row, d), dtype=xt.dtype, device=h.device)
    buf.index_copy_(0, slot.reshape(t * k),
                    xt[:, None, :].expand(t, k, d).reshape(t * k, d))
    buf = buf.reshape(g, row, d)[:, :e * c].reshape(g, e, c, d)
    if g > 1:
        buf = buf.transpose(0, 1).reshape(e, g * c, d)
    else:
        buf = buf.reshape(e, c, d)

    y = experts(buf)

    # combine: each token pulls its k expert outputs (the sentinel rows are 0)
    y = y.reshape(e, g, c, d).transpose(0, 1).reshape(g, e * c, d) if g > 1 else y
    y_flat = torch.cat([y.reshape(g, e * c, d), y.new_zeros((g, 1, d))], dim=1).reshape(g * row, d)
    out = torch.zeros((t, d), dtype=h.dtype, device=h.device)
    for i in range(k):
        out = out + y_flat[slot[:, i]] * (weights[:, i, None] * keep[:, i, None]).to(h.dtype)
    return out.reshape(b, s, d), stats
