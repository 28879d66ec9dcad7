"""GQA attention: full-sequence (prefill) and single-token decode paths.

Port of ``repro/models/attention.py``.  The full-sequence path runs either
the plain grouped computation (``impl="xla"``, the path the JAX package
leaves to XLA) or the flash-attention kernel K3 (``impl="flash"``,
``kernels.flash_attention``).  Decode attention on the card is the kernel K6
(``kernels.decode_attention``: the rope, the cache write and the attention
in place on the cache); elsewhere, and for a sharded cache, it is
``decode_attention_plain``, the reference's plain computation.

Weights keep the reference layouts: ``wq`` (d, H, dh), ``wk``/``wv``
(d, Hkv, dh), ``wo`` (H, dh, d).  A cache is ``{"k", "v"}`` of shape
(B, S, Hkv, dh).  Unlike the JAX package, ``decode_attention`` writes the new
token's K/V into the cache in place (the reference returns a new cache and
the engine donates the old one); it returns the same dict.

Under a sharding policy (``parallel.sharding``) the inputs are DTensors:
``full_attention`` moves q, k and v to the reference's placements
(``constrain_attn_q``/``constrain_attn_kv``) and runs the plain grouped
path on them, or, with ``impl="flash"``, K3 on each rank's block
(``_flash_blocks``: a hand-written kernel has no DTensor rule), under SP
with q's sequence gathered and beside whole kv heads with each rank's kv
heads sliced; ``decode_attention`` writes the new token into the shard of
a sequence-sharded cache that holds its position.

Two settings of the configuration reach every path: ``cfg.rope`` (False:
no rotary embedding, as in NoPE attention) and ``cfg.softmax_scale`` (the
configured ``attn_scale``, or d ** -0.5 by default).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import decode_attention as k6
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention
from repro_torch.models.layers import RMSNorm, apply_rope, linear, normal_param
from repro_torch.parallel.sharding import is_distributed


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
    q = linear(hx, p.wq.reshape(d, -1)).view(b, s, cfg.n_heads, cfg.d_head)
    k = linear(hx, p.wk.reshape(d, -1)).view(b, s, cfg.n_kv_heads, cfg.d_head)
    v = linear(hx, p.wv.reshape(d, -1)).view(b, s, cfg.n_kv_heads, cfg.d_head)
    return q, k, v


def _out(p: Attention, o):
    b, s, h, dh = o.shape
    return linear(o.reshape(b, s, h * dh), p.wo.reshape(h * dh, -1))


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
                   attn_block_q=256, attn_block_kv=256, policy=None):
    """Causal (optionally sliding-window) self attention over the whole seq.

    x: (B, S, D) -> (out (B, S, D), cache {k, v}: (B, S, Hkv, dh))
    """
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project(p, x, cfg)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    cache = {"k": k, "v": v}
    if policy is not None:
        q = policy.constrain_attn_q(q)
        k = policy.constrain_attn_kv(k)
        v = policy.constrain_attn_kv(v)
    if impl == "flash":
        kw = dict(causal=True, window=window, scale=cfg.softmax_scale, block_q=attn_block_q,
                  block_kv=attn_block_kv)
        o = _flash_blocks(q, k, v, **kw) if is_distributed(q) else flash_attention(q, k, v, **kw)
    elif impl == "xla":
        idx_q = torch.arange(s, device=x.device)[:, None]
        idx_k = torch.arange(s, device=x.device)[None, :]
        mask = idx_k <= idx_q
        if window:
            mask &= (idx_q - idx_k) < window
        o = _gqa_attend(q, k, v, cfg.softmax_scale, mask)
    else:
        raise ValueError(f"attn_impl {impl!r}: want 'xla' or 'flash'")
    return _out(p, o), cache


def _flash_blocks(q, k, v, **kw):
    """K3 on each rank's block of the DTensors q (B, S, H, dh), k, v (B, S,
    Hkv, dh), under every placement the reference's rules give (a
    hand-written kernel has no DTensor rule; the reference's compiled
    program runs its kernel on gathered operands the same way):

    * a sequence split (``constrain_attn_q`` under SP, beside k/v whole over
      model): q's sequence is gathered, K3 runs on the rank's rows (batch
      over data) and all heads, and the output goes back to q's sequence
      shards.  Each rank computes every row of its sequences (a K3 that
      took a query-row offset would compute only its own);
    * q heads split beside kv heads whole (the kv heads not divisible, as
      glm4-9b's 2 under tp = 4): each rank takes the kv heads its q heads
      use (q head h uses kv head h // rep) and runs K3 at the local GQA
      ratio;
    * the batch over data, and both head counts split over model: each
      rank's block as it is.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = q.device_mesh
    want_q = tuple(Replicate() if pl == Shard(1) else pl for pl in q.placements)
    if any(pl not in (Replicate(), Shard(0), Shard(2)) for pl in want_q):
        raise ValueError(f"flash attention (K3) on q placed {tuple(q.placements)}")
    # k/v follow q's batch split; their heads stay split only beside q's
    want_kv = tuple(qp if qp != Shard(2) or kp == Shard(2) else Replicate()
                    for qp, kp in zip(want_q, k.placements))
    ql = q.redistribute(mesh, want_q).to_local()
    kl = k.redistribute(mesh, want_kv).to_local()
    vl = v.redistribute(mesh, want_kv).to_local()
    if any(qp == Shard(2) and kp != Shard(2) for qp, kp in zip(want_q, want_kv)):
        kl, vl = _kv_for_heads(q, ql.shape[2], k.shape[2], kl, vl)
    o = flash_attention(ql.contiguous(), kl.contiguous(), vl.contiguous(), **kw)
    return DTensor.from_local(o, mesh, want_q, run_check=False).redistribute(
        mesh, q.placements)


def _kv_for_heads(q, h_local, hkv, k, v):
    """The kv heads (whole on this rank) that this rank's ``h_local`` q
    heads of the DTensor ``q`` use: one kv head where the q heads lie in
    one GQA group, else whole groups of them."""
    from repro_torch.parallel.sharding import ShardingPolicy

    rep = q.shape[2] // hkv
    if rep % h_local and h_local % rep:
        raise ValueError(f"{h_local} q heads a rank do not fall evenly on GQA groups of {rep}")
    lo, n = ShardingPolicy.share_of(q, 2)[0] // rep, max(1, h_local // rep)
    return k[:, :, lo:lo + n], v[:, :, lo:lo + n]


def decode_attention(p: Attention, x, cache, pos, cfg, *, window=0):
    """One-token decode against a (B, S_max, Hkv, dh) cache, updated in place.

    x: (B, 1, D); pos: a (B,) tensor of per-row positions, or one int for
    every row (the form a sequence-sharded cache takes).  Returns (out (B, 1,
    D), cache).  A CUDA tensor goes through K6, which takes positions only
    as a (B,) tensor, so an int becomes one; a CPU or ``meta`` tensor (the
    explore loop's count) and a sharded cache go through
    ``decode_attention_plain``.
    """
    q, k_new, v_new = _project(p, x, cfg)
    attend = decode_attention_plain
    if x.device.type == "cuda" and not (is_distributed(cache["k"]) or is_distributed(x)):
        attend = k6.decode_attention
        if not torch.is_tensor(pos):
            pos = torch.full((x.shape[0],), pos, dtype=torch.int32, device=x.device)
    o = attend(q, k_new, v_new, cache["k"], cache["v"], pos, cfg.rope_theta,
               window=window, rope=cfg.rope, scale=cfg.softmax_scale)
    return _out(p, o), cache


def decode_attention_plain(q, k_new, v_new, cache_k, cache_v, pos, theta, *, window=0,
                           rope=True, scale=None):
    """K6's plain version: q (B, 1, H, dh), k_new, v_new (B, 1, Hkv, dh)
    before rope, the caches (B, S_max, Hkv, dh) written in place at ``pos``
    (an int or a (B,) tensor) -> o (B, 1, H, dh).

    Ropes q and k_new (unless ``rope`` is False), writes the new rows (into
    the shard of a sharded cache that holds the position), and attends over
    the whole cache under a mask of each row's frontier and window with
    ``_gqa_attend``, at softmax scale ``scale`` (None: dh ** -0.5).
    """
    b, s_max = q.shape[0], cache_k.shape[1]
    per_slot = torch.is_tensor(pos) and pos.dim() > 0
    if per_slot:
        posb = pos.to(device=q.device, dtype=torch.long).reshape(b, 1)
    else:
        posb = torch.full((b, 1), int(pos), dtype=torch.long, device=q.device)
    if rope:
        q = apply_rope(q, posb, theta)
        k_new = apply_rope(k_new, posb, theta)

    if is_distributed(cache_k):
        if per_slot:
            raise NotImplementedError("per-slot positions into a sharded cache")
        _write_sharded(cache_k, int(pos), k_new)
        _write_sharded(cache_v, int(pos), v_new)
    elif per_slot:
        rows = torch.arange(b, device=q.device)
        cache_k[rows, posb[:, 0]] = k_new[:, 0].to(cache_k.dtype)
        cache_v[rows, posb[:, 0]] = v_new[:, 0].to(cache_v.dtype)
    else:
        cache_k[:, int(pos)] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, int(pos)] = v_new[:, 0].to(cache_v.dtype)

    idx = torch.arange(s_max, device=q.device)[None, :]
    mask = idx <= posb                   # (B, S): per-row causal frontier
    if window:
        mask &= (posb - idx) < window
    mask = mask[:, None, None, None, :]  # (B, 1, 1, 1, S) over (b,k,r,q,s)
    return _gqa_attend(q, cache_k, cache_v, q.shape[-1] ** -0.5 if scale is None else scale,
                       mask)


@torch.no_grad()
def _write_sharded(cache, pos, new):
    """Write ``new`` (B, 1, Hkv, dh) at sequence position ``pos`` of the
    DTensor ``cache`` (B, S, Hkv, dh): on the rank whose shard holds it, in
    the shard's own storage."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel.sharding import ShardingPolicy

    want = [Replicate() if isinstance(pl, Shard) and pl.dim == 1 else pl
            for pl in cache.placements]
    new_local = new.redistribute(cache.device_mesh, want).to_local()
    lo, n = ShardingPolicy.share_of(cache, 1)
    if lo <= pos < lo + n:
        cache.to_local()[:, pos - lo] = new_local[:, 0].to(cache.dtype)


def empty_cache(cfg, batch, seq_len, dtype, device):
    shp = (batch, seq_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}
