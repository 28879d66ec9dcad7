"""Analytic HBM-traffic model (fusion-aware memory-roofline term).

A copy of ``repro/roofline/traffic.py`` over the port's ``configs`` and
``models.model.count_params_analytic``; ``hbm_est_per_device`` of an
Artifact is bit-identical to the reference's.

``compiled.cost_analysis()['bytes accessed']`` on the CPU dry-run backend
counts every HLO op's operands — it does not model the TPU fusion that keeps
elementwise chains in VMEM/registers, so it overstates HBM traffic by ~5-10×
(the reference's own measurement).  This module estimates what a fused
TPU execution actually moves through HBM, term by term:

  weights      materialised per device per pass = Ntot·b/tp  (FSDP gathers
               land in HBM once per step regardless of the data-axis shards)
  activations  per-token boundary traffic per layer (matmul inputs/outputs;
               flash-attention score traffic stays in VMEM, but K/V are
               re-read once per q-block)
  optimizer    AdamW: m,v fp32 read+write + fp32 grads r/w;  Adafactor: ~5%
  logits       T·V fp32 write+read (backward)
  KV caches    decode reads the full (sequence-sharded) cache every step;
               prefill writes it once
  MoE decode   only experts actually hit are read: E_touch = E·(1-(1-k/E)^B)

Accuracy target is ±30% — enough to rank bottlenecks and steer the §Perf
hillclimb; exact byte movement requires a real TPU profile.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeConfig


def _dtype_bytes(flags) -> int:
    return 4 if flags.dtype == "float32" else 2


def _layer_token_bytes(arch: ArchConfig, spec, flags, seq_len: int) -> float:
    """Activation HBM bytes per token for one layer (one forward pass)."""
    b = _dtype_bytes(flags)
    d = arch.d_model
    total = 4 * d * b  # residual in/out at both block boundaries
    if spec.mixer in ("attn", "attn_local"):
        h, hkv, dh = arch.n_heads, arch.n_kv_heads, arch.d_head
        total += (2 * h + 2 * hkv) * dh * b          # q,k,v,o tensors
        # flash attention: scores stay in VMEM; K/V re-read once per q block
        window = arch.sliding_window if spec.mixer == "attn_local" else 0
        kv_span = min(window, seq_len) if window else seq_len
        total += (kv_span / max(flags.attn_block_q, 1)) * 2 * hkv * dh * b
    else:
        di, n, hs, ps = arch.d_inner, arch.ssm_state, arch.n_ssm_heads, arch.ssm_head_dim
        total += (2 * di + 2 * (di + 2 * n)) * b     # in_proj out, conv in/out
        total += 2 * di * b                          # gated-norm + out_proj in
        total += 8.0 * hs * ps * n / max(arch.ssm_chunk, 1)  # chunk state r/w f32
    if spec.ffn == "dense":
        f = arch.d_ff if arch.d_ff else arch.moe_d_ff
        total += (2 * d + 2 * f) * b
    elif spec.ffn == "moe":
        k, fe = arch.moe_top_k, arch.moe_d_ff
        total += (2 * k * d + 2 * k * fe) * b        # dispatch/combine + expert h
        if arch.n_shared_experts:
            total += 2 * arch.n_shared_experts * fe * b
    return total


def _weights_bytes(arch: ArchConfig, flags, tp: int, touch_frac: float = 1.0) -> float:
    """Per-device materialised weight bytes for one pass over the model."""
    b = _dtype_bytes(flags)
    from repro_torch.models.model import count_params_analytic

    n_tot = count_params_analytic(arch)
    n_act = count_params_analytic(arch, active_only=True)
    moe_extra = n_tot - n_act
    return (n_act + moe_extra * touch_frac) * b / tp


def _moe_touch_frac(arch: ArchConfig, n_seqs: int) -> float:
    if not arch.n_experts:
        return 1.0
    k, e = arch.moe_top_k, arch.n_experts
    return 1.0 - (1.0 - k / e) ** max(n_seqs, 1)


def analytic_hbm_bytes_per_device(arch: ArchConfig, shape: ShapeConfig, flags,
                                  n_dev: int, dp: int, tp: int,
                                  optimizer: str = "adamw") -> float:
    b = _dtype_bytes(flags)
    from repro_torch.models.model import count_params_analytic

    n_tot = count_params_analytic(arch)
    tokens_dev = shape.global_batch * shape.seq_len / n_dev
    specs = arch.layer_specs()

    if shape.kind == "train":
        remat_extra = 1 if flags.remat in ("full", "selective") else 0
        w = _weights_bytes(arch, flags, tp) * (2 + remat_extra)
        # activation boundary traffic: fwd (+recompute) + bwd ≈ (2+r)×
        act = sum(_layer_token_bytes(arch, s, flags, shape.seq_len) for s in specs)
        act_total = tokens_dev * act * (2 + remat_extra)
        opt = n_tot / n_dev * (24.0 if optimizer == "adamw" else 9.0)
        logits = 2 * tokens_dev * arch.vocab_size * 4
        return w + act_total + opt + logits

    if shape.kind == "prefill":
        w = _weights_bytes(arch, flags, tp)
        act = sum(_layer_token_bytes(arch, s, flags, shape.seq_len) for s in specs)
        cache_write = tokens_dev * sum(
            2 * arch.n_kv_heads * arch.d_head * b for s in specs
            if s.mixer in ("attn", "attn_local"))
        logits = shape.global_batch * arch.vocab_size * 4 / n_dev
        return w + tokens_dev * act + cache_write + logits

    # decode: one token per sequence against a seq_len cache
    touch = _moe_touch_frac(arch, shape.global_batch)
    w = _weights_bytes(arch, flags, tp, touch_frac=touch)
    cache = 0.0
    for s in specs:
        if s.mixer in ("attn", "attn_local"):
            span = (min(arch.sliding_window, shape.seq_len)
                    if s.mixer == "attn_local" else shape.seq_len)
            cache += shape.global_batch * span * 2 * arch.n_kv_heads * arch.d_head * b
        else:
            cache += (shape.global_batch * arch.n_ssm_heads * arch.ssm_head_dim
                      * arch.ssm_state * 4)
    act = shape.global_batch * sum(
        _layer_token_bytes(arch, s, flags, 1) for s in specs)
    logits = shape.global_batch * arch.vocab_size * 4
    return w + (cache + act + logits) / n_dev
