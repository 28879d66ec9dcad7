"""The FLOP and byte counts against hand counts at small shapes."""
import pytest

from portbench import flops

DENSE = {"n_layers": 2, "d_model": 8, "vocab_size": 10, "n_heads": 2, "n_kv_heads": 1,
         "head_dim": 4, "d_ff": 16, "pattern": [["attn", "dense"]]}
MOE = dict(DENSE, n_experts=4, n_shared_experts=1, moe_top_k=2, moe_d_ff=6, first_k_dense=1,
           pattern=[["attn", "moe"]])
SSM = {"n_layers": 1, "d_model": 8, "vocab_size": 10, "ssm_state": 4, "ssm_head_dim": 4,
       "ssm_expand": 2, "ssm_conv": 4, "ssm_chunk": 4, "pattern": [["mamba", "none"]]}


def test_layer_kinds_first_dense():
    assert flops.layer_kinds(MOE) == [("attn", "dense"), ("attn", "moe")]


def test_dense_prefill_and_decode_by_hand():
    # per token and layer: q 8x8, k 8x4, v 8x4, o 8x8 -> 2 * 192; SwiGLU 3 * 8 * 16 -> 2 * 384
    per_token = 2 * (2 * (192 + 384))
    s = 3
    attn = 2 * (4 * 2 * 4) * (s * (s + 1) // 2)   # 2 layers, 4 * H * d per attended pair
    assert flops.prefill_flops(DENSE, s) == s * per_token + attn + 2 * 8 * 10
    assert flops.decode_flops(DENSE, 5) == per_token + 2 * (4 * 2 * 4 * 6) + 2 * 8 * 10


def test_moe_counts_the_routed_and_shared_experts_not_capacity():
    dense_layer = 2 * (192 + 384)
    moe_layer = 2 * 192 + 2 * 8 * 4 + 2 * 3 * 8 * 6 * (2 + 1)
    assert flops.decode_flops(MOE, 0) == dense_layer + moe_layer + 2 * (4 * 2 * 4 * 1) + 160


def test_ssd_by_hand():
    # one chunk of 3: C.B^T over 6 pairs once, per head 2*P*pairs + 3*pairs + 4*N*P*L
    assert flops.ssd_flops(1, 3, 2, 4, 4, 4) == 2 * 4 * 6 + 2 * (2 * 4 * 6 + 3 * 6 + 4 * 4 * 4 * 3)
    assert flops.ssd_chunk(SSM, 3) == 4 and flops.ssd_chunk({"ssm_chunk": 256}, 100) == 128
    per_token = 2 * 8 * (2 * 16 + 2 * 4 + 4) + 2 * 4 * (16 + 8) + 2 * 16 * 8
    assert flops.prefill_flops(SSM, 3) == 3 * per_token + flops.ssd_flops(1, 3, 4, 4, 4, 4) + 160
    assert flops.decode_flops(SSM, 9) == per_token + 6 * 4 * 4 * 4 + 160


def test_bounds_by_hand():
    t, by = flops.flash_bound(1, 4096, 16, 16, 128)
    assert by == "operations"
    assert t == pytest.approx(4 * 16 * 128 * 4096 * 4097 / 2 / 989e12)
    t, by = flops.flash_bound(1, 64, 16, 16, 128)
    assert by == "bytes" and t == pytest.approx(2 * 64 * 128 * 64 / 3.35e12)
    t, by = flops.ssd_bound(1, 8192, 48, 64, 128, 256)
    assert by == "bytes"
    assert t == pytest.approx((2 * (2 * 8192 * 48 * 64 + 2 * 8192 * 128) + 8 * 8192 * 48
                               + 4 * 48 * 64 * 128) / 3.35e12)
    t, by = flops.topk_bound(100, 64, 6)
    assert t == pytest.approx(max((400 * 64 + 4800) / 3.35e12, 100 * 64 * 16 / 67e12))
