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
writes the new state and conv window into the cache dict it is given and
returns the same dict.
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


def mamba_block(p: Mamba, x, cfg, impl="jnp"):
    """Full-sequence Mamba-2 block.  x: (B, S, D) -> (out, cache)."""
    bsz, s, _ = x.shape
    di, h, hp = cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_head_dim
    hh = rmsnorm(x, p.norm.scale, cfg.norm_eps)
    z, xs_raw, b_raw, c_raw, dt_raw = _projections(p, hh)
    xs = F.silu(_causal_conv(p.conv_x, p.bias_x, xs_raw))
    b = F.silu(_causal_conv(p.conv_b, p.bias_b, b_raw))
    c = F.silu(_causal_conv(p.conv_c, p.bias_c, c_raw))
    xs = xs.reshape(bsz, s, h, hp)
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    a = -torch.exp(p.A_log)                                   # (H,)
    a_log = dt * a[None, None, :]
    y, state = ssd_chunked(xs, a_log, b, c, dt, cfg.ssm_chunk, impl=impl)
    y = y + xs * p.D[None, None, :, None].to(y.dtype)
    y = gated_rmsnorm(y.reshape(bsz, s, di), z, p.gated_norm.scale, cfg.norm_eps)
    out = y @ p.out_proj
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


def mamba_decode(p: Mamba, x, cache, cfg):
    """One-token decode.  x: (B, 1, D); cache {state (B,H,P,N), conv (B,K-1,C)}.

    The conv window is the cache's ``conv`` followed by the new segment; JAX
    promotes a bf16 segment against an fp32 cache to fp32, and so does this.
    """
    bsz = x.shape[0]
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    hh = rmsnorm(x, p.norm.scale, cfg.norm_eps)
    z, xs_raw, b_raw, c_raw, dt_raw = _projections(p, hh)
    new_seg = torch.cat([xs_raw, b_raw, c_raw], dim=-1)          # (B, 1, C)
    conv, new_seg = _promoted(cache["conv"], new_seg)
    window = torch.cat([conv, new_seg], dim=1)                   # (B, K, C)

    def seg_conv(w, bias, lo, hi):
        win, w, bias = _promoted(window[:, :, lo:hi], w, bias)
        return F.silu(torch.einsum("bkc,ck->bc", win, w) + bias)

    xs = seg_conv(p.conv_x, p.bias_x, 0, di)
    b = seg_conv(p.conv_b, p.bias_b, di, di + n)
    c = seg_conv(p.conv_c, p.bias_c, di + n, di + 2 * n)
    xs = xs.reshape(bsz, h, hp).float()
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias)
    a = -torch.exp(p.A_log)
    decay = torch.exp(dt * a[None, :])                           # (B, H)
    state = cache["state"] * decay[:, :, None, None] + torch.einsum(
        "bhp,bn,bh->bhpn", xs, b.float(), dt)
    y = torch.einsum("bhpn,bn->bhp", state, c.float())
    y = y + xs * p.D[None, :, None]
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = gated_rmsnorm(y, z, p.gated_norm.scale, cfg.norm_eps)
    out = y @ p.out_proj
    cache["state"] = state
    cache["conv"] = torch.cat([conv[:, 1:], new_seg], dim=1)
    return out, cache


def empty_mamba_cache(cfg, batch, device):
    di, n = cfg.d_inner, cfg.ssm_state
    return {
        "state": torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_head_dim, n),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * n),
                            dtype=torch.float32, device=device),
    }
