"""Operations and bytes: the model's work from its configuration and the
tokens alone, and each kernel's least time on one H100.

The peaks are NVIDIA's H100 SXM data sheet (dense): 989 TFLOP/s in bf16,
3.35 TB/s of HBM.  ``flash_bound``, ``ssd_bound`` and ``topk_bound`` are
frozen copies of the functions of the same names in ``chip_smoke.py``
(bf16 only), so that the yardstick does not move with the program.

Model FLOPs count 2 per multiply-add of the matrix products a token needs:
its share of every projection and of the k routed plus the shared experts
(no capacity padding), attention over the positions it really attends to
(causal in prefill, pos + 1 in decode), the LM head once a prefill (the
last position's logits) and once a decoded token, and the SSD scan in the
configuration's chunked form (the causal half of each chunk).  Norms,
rotary embeddings, softmax and the elementwise work are left out.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12


def layer_kinds(cfg: dict):
    """[(mixer, ffn)] per layer: the pattern repeated, the first
    ``first_k_dense`` MoE layers dense."""
    pattern = [tuple(p) for p in cfg["pattern"]]
    out = []
    for i in range(cfg["n_layers"]):
        mixer, ffn = pattern[i % len(pattern)]
        if ffn == "moe" and i < cfg.get("first_k_dense", 0):
            ffn = "dense"
        out.append((mixer, ffn))
    return out


def attended_pairs(s: int) -> int:
    """(query, key) pairs of a causal attention over s positions."""
    return s * (s + 1) // 2


def flash_bound(b, s, h, hkv, d):
    """(bound seconds, bound by) of one bf16 causal K3 call: q, k, v read
    once, o written once, 4·h·d flops per attended pair."""
    nbytes = 2 * b * s * d * (2 * h + 2 * hkv)
    flops = 4 * b * h * d * attended_pairs(s)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ssd_flops(b, s, h, p, n, q):
    """The operations of one chunked SSD scan: C·Bᵀ once per (batch, chunk),
    per head the causal S·X product, exp and the decay's 2 products as 3 per
    pair, the incoming state's term and the state update."""
    flops = 0
    for c0 in range(0, s, q):
        length = min(q, s - c0)
        pairs = length * (length + 1) // 2
        flops += b * 2 * n * pairs
        flops += b * h * (2 * p * pairs + 3 * pairs + 4 * n * p * length)
    return flops


def ssd_bound(b, s, h, p, n, q):
    """(bound seconds, bound by) of one bf16 K4 call: x, a_log, dt, b, c read
    once, y and the fp32 state written once."""
    nbytes = 2 * (2 * b * s * h * p + 2 * b * s * n) + 4 * 2 * b * s * h + 4 * b * h * p * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ssd_flops(b, s, h, p, n, q) / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def topk_bound(t, e, k, peak_fp32=67e12):
    """(bound seconds, bound by) of one K5 call: logits read once, p and ids
    written once; softmax and k compare-and-select steps, fp32 off the
    tensor cores."""
    nbytes = 4 * t * e + 8 * t * k
    flops = t * e * (4 + 2 * k)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_fp32
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ssd_chunk(cfg: dict, s: int) -> int:
    """The chunk a scan over s positions takes: the configuration's, or the
    next power of two at or above s (at least 8) where that is smaller."""
    return min(cfg["ssm_chunk"], max(8, 1 << (s - 1).bit_length()))


def _token_matmul_flops(cfg: dict) -> int:
    """Projection and FFN flops of one token through every layer (no
    attention scores, no scan, no LM head)."""
    d = cfg["d_model"]
    total = 0
    for mixer, ffn in layer_kinds(cfg):
        if mixer in ("attn", "attn_local"):
            h, hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
            total += 2 * d * (2 * h * dh + 2 * hkv * dh)
        else:
            di, n, heads = _ssm_sizes(cfg)
            total += 2 * d * (2 * di + 2 * n + heads)          # z, x, B, C, dt
            total += 2 * cfg["ssm_conv"] * (di + 2 * n)         # depthwise conv
            total += 2 * di * d                                 # out_proj
        if ffn == "dense":
            total += 2 * 3 * d * cfg["d_ff"]
        elif ffn == "moe":
            f = cfg["moe_d_ff"]
            total += 2 * d * cfg["n_experts"]                   # router
            total += 2 * 3 * d * f * (cfg["moe_top_k"] + cfg["n_shared_experts"])
    return total


def _ssm_sizes(cfg: dict):
    di = cfg["ssm_expand"] * cfg["d_model"]
    return di, cfg["ssm_state"], di // cfg["ssm_head_dim"]


def prefill_flops(cfg: dict, s: int) -> int:
    """Model FLOPs of one prefill of s tokens (logits of the last position)."""
    total = s * _token_matmul_flops(cfg) + 2 * cfg["d_model"] * cfg["vocab_size"]
    for mixer, _ in layer_kinds(cfg):
        if mixer in ("attn", "attn_local"):
            total += 4 * cfg["n_heads"] * cfg["head_dim"] * attended_pairs(s)
        else:
            _, n, heads = _ssm_sizes(cfg)
            total += ssd_flops(1, s, heads, cfg["ssm_head_dim"], n, ssd_chunk(cfg, s))
    return total


def decode_flops(cfg: dict, pos: int) -> int:
    """Model FLOPs of one decoded token written at position ``pos``."""
    total = _token_matmul_flops(cfg) + 2 * cfg["d_model"] * cfg["vocab_size"]
    for mixer, _ in layer_kinds(cfg):
        if mixer in ("attn", "attn_local"):
            total += 4 * cfg["n_heads"] * cfg["head_dim"] * (pos + 1)
        else:
            _, n, heads = _ssm_sizes(cfg)
            total += 6 * heads * cfg["ssm_head_dim"] * n        # state update and readout
    return total
