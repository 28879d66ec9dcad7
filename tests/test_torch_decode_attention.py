"""Decode attention on the CPU: K6's plain version and K6's schedule.

``models.attention.decode_attention_plain`` is the port's decode attention
before K6 moved into a kernel: the model's CPU path must give what that
code gave, bitwise, with rows at the cache's first and last position and a
window of one position.  The card tests hold K6 to the plain version.
"""
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import decode_attention as k6
from repro_torch.kernels.flash_attention import NEG_INF
from repro_torch.models import attention
from repro_torch.models.layers import apply_rope


def _decode_before_k6(p, x, cache, pos, cfg, *, window=0):
    """The port's ``attention.decode_attention`` as it was before K6."""
    b = x.shape[0]
    s_max = cache["k"].shape[1]
    per_slot = torch.is_tensor(pos) and pos.dim() > 0
    q, k_new, v_new = attention._project(p, x, cfg)
    if per_slot:
        posb = pos.to(device=x.device, dtype=torch.long).reshape(b, 1)
    else:
        posb = torch.full((b, 1), int(pos), dtype=torch.long, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k_new = apply_rope(k_new, posb, cfg.rope_theta)
    if per_slot:
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, posb[:, 0]] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][rows, posb[:, 0]] = v_new[:, 0].to(cache["v"].dtype)
    else:
        cache["k"][:, int(pos)] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, int(pos)] = v_new[:, 0].to(cache["v"].dtype)
    idx = torch.arange(s_max, device=x.device)[None, :]
    mask = idx <= posb
    if window:
        mask &= (posb - idx) < window
    mask = mask[:, None, None, None, :]
    # _gqa_attend as it was
    qq, kk, vv = q, cache["k"], cache["v"]
    b, sq, h, dh = qq.shape
    hkv = kk.shape[2]
    q5 = qq.reshape(b, sq, hkv, h // hkv, dh)
    logits = torch.einsum("bqkrd,bskd->bkrqs", q5, kk).to(torch.float32) * cfg.d_head ** -0.5
    logits = torch.where(mask, logits, NEG_INF)
    pr = torch.softmax(logits, dim=-1).to(qq.dtype)
    o = torch.einsum("bkrqs,bskd->bqkrd", pr, vv).reshape(b, sq, h, dh)
    return attention._out(p, o), cache


@pytest.mark.parametrize("pos", [9, 0, 13, (0, 6, 13), (13, 4, 0)],
                         ids=["aligned", "aligned_first", "aligned_last", "per_slot",
                              "per_slot_edges"])
@pytest.mark.parametrize("window", [0, 1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_cpu_decode_is_the_code_before_k6_bitwise(pos, window, dtype):
    cfg = reduced(get_arch("tinyllama-1.1b"))
    gen = torch.Generator().manual_seed(3)
    p = attention.Attention(cfg, dtype, "cpu", gen)
    b, s_max = 3, 14
    x = torch.randn((b, 1, cfg.d_model), generator=gen).to(dtype)
    shp = (b, s_max, cfg.n_kv_heads, cfg.d_head)
    cache = {"k": torch.randn(shp, generator=gen).to(dtype),
             "v": torch.randn(shp, generator=gen).to(dtype)}
    tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, tuple) else pos
    want, wcache = _decode_before_k6(p, x, {k: v.clone() for k, v in cache.items()}, tpos,
                                     cfg, window=window)
    before = k6.decode_attention.launches
    got, gcache = attention.decode_attention(p, x, {k: v.clone() for k, v in cache.items()},
                                             tpos, cfg, window=window)
    assert k6.decode_attention.launches == before
    for g, w in ((got, want), (gcache["k"], wcache["k"]), (gcache["v"], wcache["v"])):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_k6_wrapper_takes_only_cuda_tensors():
    """The model takes the plain version off the card; K6 itself raises."""
    q = torch.zeros((2, 1, 4, 16))
    kv = torch.zeros((2, 1, 2, 16))
    cache = torch.zeros((2, 8, 2, 16))
    with pytest.raises(ValueError, match="runs on cuda"):
        k6.decode_attention(q, kv, kv, cache, cache.clone(), 3, 1e4)


def test_schedule_covers_the_cache_in_aligned_splits():
    for s_max in (1, 17, 63, 64, 65, 200, 2560, 4096, 16416):
        for rows in (1, 2, 8, 64, 384, 512, 4096, 10000):
            splits, split_len = k6.schedule(s_max, rows)
            assert split_len % k6.SPLIT_ALIGN == 0 and split_len > 0
            assert (splits - 1) * split_len < s_max <= splits * split_len
            assert splits <= -(-s_max // k6.SPLIT_ALIGN)
            if rows >= k6.TARGET_BLOCKS:
                assert splits == 1
    # the served shapes: dsmoe16b's chat (32 slots x 16 kv heads, 2560) and longdoc (24, 4096)
    assert k6.schedule(2560, 32 * 16) == (8, 320)
    assert k6.schedule(4096, 24 * 16) == (11, 384)
    assert all(t % k6.SPLIT_ALIGN == 0 or k6.SPLIT_ALIGN % t == 0 for t in k6.TILES.values())
