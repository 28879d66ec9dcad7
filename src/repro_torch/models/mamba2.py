"""Mamba-2 SSD mixer block (port of ``repro/models/mamba2.py``).

The reference keeps separate projections per segment (``wz``, ``wx``,
``wb``, ``wc``, ``wdt``) and separate depthwise convs, with one group of B/C
heads; the port keeps its parameter names and layouts, so weights carry
across through numpy unchanged.  ``A_log``, ``D`` and ``dt_bias`` stay fp32
in a bf16 model.

The full-sequence scan runs either the plain chunked path (``impl="jnp"``,
the reference's default) or the CUDA kernel K4 (``impl="cuda"``,
``kernels.ssd_scan``, the counterpart of the reference's ``"pallas"``).
Decode is plain PyTorch in both modes, as in the reference.  A cache is
``{"state": (B, H, P, N) fp32, "conv": (B, K-1, d_inner + 2N)}``: prefill
returns ``conv`` in the model's dtype, ``empty_mamba_cache`` makes it fp32,
and decode follows JAX's type promotion between the two.  ``mamba_decode``
writes the new state and conv window into the cache's own tensors, in
place, and returns the same dict: a step captured in a CUDA graph
(``models.model``) finds the cache where it left it.

Under a sharding policy ``mamba_block_sharded`` and ``mamba_decode_sharded``
run the same computation (``_mixer``, ``_decode_step``) on each rank's rows
and heads, with the weights in the reference's placements.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models.layers import RMSNorm, gated_rmsnorm, normal_param, rmsnorm


class Mamba(nn.Module):
    def __init__(self, cfg, dtype, device, generator=None):
        super().__init__()
        d, di, n, h, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                          cfg.ssm_conv)
        self.norm = RMSNorm(d, dtype, device)
        self.wz = normal_param((d, di), dtype, device, generator)
        self.wx = normal_param((d, di), dtype, device, generator)
        self.wb = normal_param((d, n), dtype, device, generator)
        self.wc = normal_param((d, n), dtype, device, generator)
        self.wdt = normal_param((d, h), dtype, device, generator)
        self.conv_x = normal_param((di, k), dtype, device, generator, scale=0.1)
        self.conv_b = normal_param((n, k), dtype, device, generator, scale=0.1)
        self.conv_c = normal_param((n, k), dtype, device, generator, scale=0.1)
        const = lambda shape, value, dt: nn.Parameter(
            torch.full(shape, value, dtype=dt, device=device), requires_grad=False)
        self.bias_x = const((di,), 0.0, dtype)
        self.bias_b = const((n,), 0.0, dtype)
        self.bias_c = const((n,), 0.0, dtype)
        self.A_log = const((h,), 0.0, torch.float32)     # A = -exp(A_log) = -1
        self.D = const((h,), 1.0, torch.float32)
        self.dt_bias = const((h,), 0.0, torch.float32)
        self.gated_norm = RMSNorm(di, dtype, device)
        self.out_proj = normal_param((di, d), dtype, device, generator)


def _causal_conv(w, bias, x):
    """Depthwise causal conv as K unrolled shifts.  x: (B, S, C); w: (C, K).

    Shifts rather than ``F.conv1d``: on the card an fp32 convolution runs in
    TF32 by default, and the shifts stay exact.
    """
    k = w.shape[-1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + pad[:, j:j + x.shape[1], :] * w[None, None, :, j]
    return out + bias[None, None, :]


def ssd_chunked(x, a_log, b, c, dt, chunk, impl="jnp"):
    """Chunked SSD scan from a zero state.

    x: (B, S, H, P); a_log: (B, S, H) = dt*A (negative); b, c: (B, S, N);
    dt: (B, S, H).  Returns (y (B, S, H, P), state (B, H, P, N) fp32).
    """
    if impl == "cuda":
        return ssd_scan(x, a_log, b, c, dt, chunk=chunk)
    if impl != "jnp":
        raise ValueError(f"ssd_impl {impl!r}: want 'jnp' or 'cuda'")
    return ssd_scan_plain(x, a_log, b, c, dt, chunk=chunk)


def _projections(p: Mamba, hh):
    return hh @ p.wz, hh @ p.wx, hh @ p.wb, hh @ p.wc, hh @ p.wdt


def _gated_norm(y, z, scale, cfg, model_sum=None):
    """``gated_rmsnorm`` over d_inner.  With ``model_sum`` the rank holds
    a share of the channels: the sum of squares of ``y * silu(z)`` over
    its share is summed over model before the mean."""
    if model_sum is None:
        return gated_rmsnorm(y, z, scale, cfg.norm_eps)
    g = (y * F.silu(z)).float()
    var = model_sum(torch.sum(g * g, dim=-1, keepdim=True)) / cfg.d_inner
    return (g * torch.rsqrt(var + cfg.norm_eps) * scale.float()).to(y.dtype)


def _mixer(p: Mamba, hh, cfg, impl, model_sum=None):
    """The mixer from the normed input ``hh`` (B, S, D) on the heads whose
    weights ``p`` holds (all, or one rank's share: ``wx``'s columns say how
    many).  Returns (the output before any sum over ranks (B, S, D), the
    final state (B, h, P, N) fp32, the pre-conv segments x, B, C)."""
    bsz, s, _ = hh.shape
    hp = cfg.ssm_head_dim
    z, xs_raw, b_raw, c_raw, dt_raw = _projections(p, hh)
    xs = F.silu(_causal_conv(p.conv_x, p.bias_x, xs_raw))
    b = F.silu(_causal_conv(p.conv_b, p.bias_b, b_raw))
    c = F.silu(_causal_conv(p.conv_c, p.bias_c, c_raw))
    xs = xs.reshape(bsz, s, -1, hp)
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    a = -torch.exp(p.A_log)                                   # (h,)
    a_log = dt * a[None, None, :]
    y, state = ssd_chunked(xs, a_log, b, c, dt, cfg.ssm_chunk, impl=impl)
    y = y + xs * p.D[None, None, :, None].to(y.dtype)
    y = _gated_norm(y.reshape(bsz, s, -1), z, p.gated_norm.scale, cfg, model_sum)
    return y @ p.out_proj, state, (xs_raw, b_raw, c_raw)


def mamba_block(p: Mamba, x, cfg, impl="jnp"):
    """Full-sequence Mamba-2 block.  x: (B, S, D) -> (out, cache)."""
    hh = rmsnorm(x, p.norm.scale, cfg.norm_eps)
    out, state, (xs_raw, b_raw, c_raw) = _mixer(p, hh, cfg, impl)
    # decode cache: the last (ssm_conv - 1) pre-conv segment values + the state
    km1 = cfg.ssm_conv - 1
    conv = torch.cat([xs_raw[:, -km1:], b_raw[:, -km1:], c_raw[:, -km1:]], dim=-1)
    return out, {"state": state, "conv": conv}


def _promoted(*ts):
    """``ts`` cast to their common type, as JAX promotes mixed operands."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _decode_step(p: Mamba, z, dt_raw, new_seg, conv, state, cfg, dtype, x_lo=0,
                 model_sum=None):
    """One token through the conv window, the state and the gated norm on
    the heads whose weights ``p`` holds, whose x channels start at ``x_lo``
    of the window.  The fp32 ``state`` is updated in place, as
    ``state * decay + x·B·dt`` with the same two roundings.  Returns (the
    output before any sum over ranks, the new window (B, K-1, C), a view of
    a new tensor in the promoted dtype)."""
    bsz = z.shape[0]
    di, n, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    conv, new_seg = _promoted(conv, new_seg)
    window = torch.cat([conv, new_seg], dim=1)                   # (B, K, C)

    def seg_conv(w, bias, lo, hi):
        win, w, bias = _promoted(window[:, :, lo:hi], w, bias)
        return F.silu(torch.einsum("bkc,ck->bc", win, w) + bias)

    xs = seg_conv(p.conv_x, p.bias_x, x_lo, x_lo + p.conv_x.shape[0])
    b = seg_conv(p.conv_b, p.bias_b, di, di + n)
    c = seg_conv(p.conv_c, p.bias_c, di + n, di + 2 * n)
    xs = xs.reshape(bsz, -1, hp).float()
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias)
    a = -torch.exp(p.A_log)
    decay = torch.exp(dt * a[None, :])                           # (B, h)
    state.mul_(decay[:, :, None, None]).add_(torch.einsum("bhp,bn,bh->bhpn", xs, b.float(), dt))
    y = torch.einsum("bhpn,bn->bhp", state, c.float())
    y = y + xs * p.D[None, :, None]
    y = y.reshape(bsz, 1, -1).to(dtype)
    y = _gated_norm(y, z, p.gated_norm.scale, cfg, model_sum)
    return y @ p.out_proj, window[:, 1:]


def mamba_decode(p: Mamba, x, cache, cfg):
    """One-token decode.  x: (B, 1, D); cache {state (B,H,P,N), conv (B,K-1,C)}.

    The conv window is the cache's ``conv`` followed by the new segment; JAX
    promotes a bf16 segment against an fp32 cache to fp32, and so does this
    (the promoted type is the cache's own: prefill writes ``conv`` in the
    model's dtype, ``empty_mamba_cache`` in fp32).  The state and the
    window's last K-1 rows are written into the cache's tensors in place.
    """
    hh = rmsnorm(x, p.norm.scale, cfg.norm_eps)
    z, xs_raw, b_raw, c_raw, dt_raw = _projections(p, hh)
    new_seg = torch.cat([xs_raw, b_raw, c_raw], dim=-1)          # (B, 1, C)
    out, window = _decode_step(p, z, dt_raw, new_seg, cache["conv"], cache["state"], cfg,
                               x.dtype)
    cache["conv"].copy_(window)
    return out, cache


# ---------------------------------------------------------------------------
# Under a sharding policy: each rank's rows and heads
# ---------------------------------------------------------------------------

# the dimension of each weight that runs over the heads (the reference's
# rules split it over model where tp divides it); the others are whole
HEAD_DIMS = {"wz": 1, "wx": 1, "wdt": 1, "conv_x": 0, "bias_x": 0, "A_log": 0, "D": 0,
             "dt_bias": 0, "gated_norm.scale": 0, "out_proj": 0}


def _sharded_setup(policy, p: Mamba, x, cfg):
    """(rows split?, head split, this rank's weights, its normed input rows)."""
    split = policy.row_split(x.shape[0])
    heads = policy.head_split(cfg.n_ssm_heads)
    shares = policy.head_shares(p, HEAD_DIMS, split, heads)
    xl = policy.local_rows(x, split, partial=heads > 1)
    return split, heads, shares, rmsnorm(xl, shares.norm.scale, cfg.norm_eps)


def mamba_block_sharded(policy, p: Mamba, x, cfg, impl="jnp", want_cache=True):
    """The full-sequence block on the DTensor ``x`` (B, S, D): each rank
    takes its rows (the batch over the data axes where they divide it, the
    sequence gathered over model) and, where the model axis divides H, its
    H/tp heads.

    A rank's weights (``ShardingPolicy.head_shares``, each gathered over
    the data axes only): its heads' columns of ``wz``, ``wx``, ``wdt``, rows
    of ``conv_x`` and of ``out_proj`` (the reference's rules put
    ``out_proj``'s columns over model; a rank takes its rows, an all-to-all
    over model, which PyTorch does as a gather and a slice on gloo), and
    its share of the per-head vectors.  B and C (``wb``,
    ``wc``, ``conv_b``, ``conv_c``, split on N by the rules) are taken
    whole: the small (D, N) weights are gathered over model, and every
    rank forms the whole (rows, S, N) activations.  K4 (or the plain scan)
    runs on (rows, S, H/tp, P) with the whole B and C; the gated norm's
    sum of squares is summed over model (fp32, rows × S values), and the
    partial ``out_proj`` products are summed over model into the residual
    stream's placement (an all-reduce, or a reduce-scatter to the sequence
    shards under SP).

    Where the model axis does not divide H (and so where the rules leave
    d_inner or N whole, or split d_inner through a head), every model rank
    runs all heads with the weights whole, which is exact and repeats the
    work on each.  Returns (out, cache | None): the cache in
    ``cache_spec``'s placements, the state's heads over model as the
    scan's, the conv window's channels gathered and then split by
    ``cache_spec`` (its x | B | C split does not line up with the heads)."""
    split, heads, sh, hh = _sharded_setup(policy, p, x, cfg)
    ms = (lambda t: policy.model_all_reduce(t, x)) if heads > 1 else None
    part, state, (xs_raw, b_raw, c_raw) = _mixer(sh, hh, cfg, impl, ms)
    out = policy.reduced_rows(part, split, heads, x, policy.residual_spec(tuple(x.shape)))
    if not want_cache:
        return out, None
    km1 = cfg.ssm_conv - 1
    xs_tail = xs_raw[:, -km1:].detach()
    if heads > 1:
        xs_tail = policy.model_gather(xs_tail.contiguous(), 2, split, x)
    conv = torch.cat([xs_tail, b_raw[:, -km1:].detach(), c_raw[:, -km1:].detach()], dim=-1)
    b = x.shape[0]
    state_spec = policy.cache_spec("state", (b, cfg.n_ssm_heads) + tuple(state.shape[2:]))
    conv_spec = policy.cache_spec("conv", (b,) + tuple(conv.shape[1:]))
    return out, {"state": policy.from_rows(state.detach(), split, x, 1 if heads > 1 else None,
                                           state_spec),
                 "conv": policy.from_rows(conv, split, x, None, conv_spec)}


@torch.no_grad()
def mamba_decode_sharded(policy, p: Mamba, x, cache, cfg):
    """One-token decode on the DTensor ``x`` (B, 1, D) against the cache
    DTensors in ``cache_spec``'s placements, on each rank's rows and heads
    as ``mamba_block_sharded``.  The state (batch over data, heads over
    model) is updated in each rank's own storage.  The conv window
    (B, K-1, d_inner + 2N), its channels over model where tp divides them,
    is gathered over model with the new token's x channels (the rank needs
    its heads' x channels and the whole B and C, which its share does not
    line up with), and each rank writes back its share: per layer and
    step, an all-gather of (rows, K-1, C) and of (rows, 1, d_inner)
    values."""
    split, heads, sh, hh = _sharded_setup(policy, p, x, cfg)
    z, xs_raw, b_raw, c_raw, dt_raw = _projections(sh, hh)
    x_lo = 0
    if heads > 1:
        x_lo = policy.model_rank(x) * xs_raw.shape[-1]
        xs_raw = policy.model_gather(xs_raw.contiguous(), 2, split, x)
    new_seg = torch.cat([xs_raw, b_raw, c_raw], dim=-1)
    conv_dt, state_dt = cache["conv"], cache["state"]
    conv = policy.local_rows(conv_dt, split)
    ms = (lambda t: policy.model_all_reduce(t, x)) if heads > 1 else None
    part, window = _decode_step(sh, z, dt_raw, new_seg, conv, state_dt.to_local(), cfg,
                                x.dtype, x_lo, ms)
    off, n = policy.share_of(conv_dt, 2)
    conv_dt.to_local().copy_(window[..., off:off + n])
    return policy.reduced_rows(part, split, heads, x, policy.residual_spec(tuple(x.shape))), cache


def empty_mamba_cache(cfg, batch, device):
    di, n = cfg.d_inner, cfg.ssm_state
    return {
        "state": torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_head_dim, n),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * n),
                            dtype=torch.float32, device=device),
    }
