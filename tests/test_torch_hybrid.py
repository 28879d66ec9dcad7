"""The port's settings for granite-4.0-h-style hybrids on the CPU: NoPE
attention, a configured softmax scale and the three stream multipliers,
each read in prefill, decode and the training forward; K5's wrapper at
k = 10 of E = 72; the MoE and recurrent-state counters."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.kernels import topk_gating as k5
from repro_torch.models import BuildFlags, Model
from repro_torch.models.attention import decode_attention_plain
from repro_torch.models.layers import apply_rope
from repro_torch.serve import SlotServer

PATTERN = tuple([LayerSpec("mamba", "moe")] * 2 + [LayerSpec("attn", "moe")]
                + [LayerSpec("mamba", "moe")])
HYBRID = ArchConfig(name="hybrid-tiny", family="hybrid", n_layers=4, d_model=64, vocab_size=256,
                    n_heads=4, n_kv_heads=2, head_dim=16, n_experts=16, n_shared_experts=2,
                    moe_top_k=10, moe_d_ff=32, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
                    pattern=PATTERN, tie_embeddings=True, norm_eps=1e-5, rope=False,
                    attn_scale=1 / 16, embedding_multiplier=12.0, residual_multiplier=0.22,
                    logits_scaling=16.0)
NEUTRAL = {"rope": True, "attn_scale": 0.0, "embedding_multiplier": 1.0,
           "residual_multiplier": 1.0, "logits_scaling": 1.0}


def _outputs(cfg, path):
    model = Model(cfg, BuildFlags(dtype="float32", attn_impl="flash"), device="cpu", seed=0)
    tokens = torch.tensor([[5, 17, 3, 99, 42, 8, 200, 1, 64, 7, 12]])
    with torch.no_grad():
        if path == "train":                   # the training forward's logits
            hidden, _, _ = model.stack.forward_full(model._embed_inputs({"tokens": tokens}),
                                                    model.flags, want_cache=False)
            return model._logits(hidden)
        logits, caches = model.prefill({"tokens": tokens})
        if path == "prefill":
            return logits
        from repro_torch.serve.engine import pad_caches

        caches = pad_caches(caches, tokens.shape[1], tokens.shape[1] + 2)
        return model.decode_step(torch.tensor([[9]]), caches, tokens.shape[1])[0]


@pytest.mark.parametrize("path", ["prefill", "decode", "train"])
@pytest.mark.parametrize("field", sorted(NEUTRAL))
def test_each_setting_is_read(field, path):
    """Each setting, set back to its neutral default, moves the logits by
    more than float32 sums in another order would; so none is silently
    ignored on any path."""
    base = _outputs(HYBRID, path)
    moved = _outputs(dataclasses.replace(HYBRID, **{field: NEUTRAL[field]}), path)
    assert (moved - base).abs().max() > 1e-6 * base.abs().max()


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("scale", [None, 1 / 128])
def test_plain_decode_attention_takes_rope_and_scale(rope, scale):
    """``decode_attention_plain`` against a direct computation: q and the
    new k roped or not, the new rows written, softmax at the scale given."""
    g = torch.Generator().manual_seed(3)
    b, s, h, hkv, d = 3, 20, 8, 2, 16
    q = torch.randn(b, 1, h, d, generator=g)
    kn, vn = torch.randn(b, 1, hkv, d, generator=g), torch.randn(b, 1, hkv, d, generator=g)
    ck, cv = torch.randn(b, s, hkv, d, generator=g), torch.randn(b, s, hkv, d, generator=g)
    pos = torch.tensor([4, 19, 0])
    got = decode_attention_plain(q, kn, vn, ck, cv, pos, 1e4, rope=rope, scale=scale)
    posb = pos[:, None]
    qr = apply_rope(q, posb, 1e4) if rope else q
    kr = apply_rope(kn, posb, 1e4) if rope else kn
    assert torch.equal(ck[torch.arange(b), pos], kr[:, 0])
    assert torch.equal(cv[torch.arange(b), pos], vn[:, 0])
    k = ck.repeat_interleave(h // hkv, dim=2)
    v = cv.repeat_interleave(h // hkv, dim=2)
    lg = torch.einsum("bhd,bshd->bhs", qr[:, 0], k) * (d ** -0.5 if scale is None else scale)
    lg = lg.masked_fill(torch.arange(s)[None, None, :] > posb[:, :, None], -torch.inf)
    want = torch.einsum("bhs,bshd->bhd", torch.softmax(lg, dim=-1), v)
    torch.testing.assert_close(got[:, 0], want, atol=1e-6, rtol=1e-5)


def test_k5_wrapper_takes_k_up_to_a_warp():
    """K5's wrapper takes granite's k = 10 of E = 72 (checked on ``meta``,
    which launches nothing) and refuses k past 32 or past E; the plain
    version keeps ties in index order at k = 10."""
    assert k5.MAX_K == 32
    p, ids = k5.topk_gating(torch.empty((7, 72), device="meta"), 10)
    assert p.shape == ids.shape == (7, 10)
    with pytest.raises(ValueError, match="k <="):
        k5.topk_gating(torch.empty((7, 72), device="meta"), 33)
    with pytest.raises(ValueError, match="k <="):
        k5.topk_gating(torch.empty((7, 8), device="meta"), 10)
    logits = torch.zeros((2, 72))
    logits[0, 40:] = 1.0                      # 32 equal largest: the 10 lowest of them first
    p, ids = k5.topk_gating(logits, 10)
    assert ids[0].tolist() == list(range(40, 50)) and ids[1].tolist() == list(range(10))
    top = torch.softmax(logits, dim=-1).max(dim=-1).values       # each pick is a row's largest
    torch.testing.assert_close(p, top[:, None].expand(2, 10))


def test_counters_of_routing_and_recurrent_state():
    """With tracing on, a SlotServer step records ``serve.state_bytes`` (the
    busy slots' Mamba state and conv window) beside ``serve.kv_used``, and
    each model step ``moe.assignments`` (rows × k a MoE layer) and
    ``moe.dropped``."""
    model = Model(HYBRID, BuildFlags(dtype="float32"), device="cpu", seed=0)
    srv = SlotServer(model, n_slots=2, max_len=48)
    per_slot = 3 * 4 * (8 * 16 * 16 + 3 * (128 + 32))      # 3 Mamba layers, fp32
    assert srv.slot_state_bytes == per_slot
    rng = np.random.default_rng(0)
    srv.submit(0, rng.integers(0, 256, 30).astype(np.int32), 3)
    trace.drain()
    trace.enable()
    try:
        srv.step()
    finally:
        trace.disable()
    _, counters = trace.drain()
    values = {}
    for name, _, v in counters:
        values.setdefault(name, []).append(v)
    assert values["serve.state_bytes"] == [per_slot]
    assert values["moe.assignments"] == [4 * 30 * 10, 4 * 2 * 10]    # the prefill, a decode step
    dropped = [int(v) for v in values["moe.dropped"]]
    assert dropped[1] == 0 and 0 <= dropped[0] < 4 * 30 * 10


# ---------------------------------------------------------------------------
# The Mamba-2 decode step writes its cache in place, and the decode step's
# CUDA graph is taken only on the card
# ---------------------------------------------------------------------------

def _mamba_decode_out_of_place(p, x, conv, state, cfg):
    """``mamba2.mamba_decode`` as it computed before it wrote its cache in
    place: (out, a new state, a new window)."""
    import torch.nn.functional as F

    from repro_torch.models import mamba2
    from repro_torch.models.layers import rmsnorm

    hh = rmsnorm(x, p.norm.scale, cfg.norm_eps)
    z, xs_raw, b_raw, c_raw, dt_raw = mamba2._projections(p, hh)
    new_seg = torch.cat([xs_raw, b_raw, c_raw], dim=-1)
    bsz = z.shape[0]
    di, n, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    conv, new_seg = mamba2._promoted(conv, new_seg)
    window = torch.cat([conv, new_seg], dim=1)

    def seg_conv(w, bias, lo, hi):
        win, w, bias = mamba2._promoted(window[:, :, lo:hi], w, bias)
        return F.silu(torch.einsum("bkc,ck->bc", win, w) + bias)

    xs = seg_conv(p.conv_x, p.bias_x, 0, di)
    b = seg_conv(p.conv_b, p.bias_b, di, di + n)
    c = seg_conv(p.conv_c, p.bias_c, di + n, di + 2 * n)
    xs = xs.reshape(bsz, -1, hp).float()
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias)
    a = -torch.exp(p.A_log)
    decay = torch.exp(dt * a[None, :])
    state = state * decay[:, :, None, None] + torch.einsum("bhp,bn,bh->bhpn", xs, b.float(), dt)
    y = torch.einsum("bhpn,bn->bhp", state, c.float())
    y = y + xs * p.D[None, :, None]
    y = y.reshape(bsz, 1, -1).to(x.dtype)
    y = mamba2._gated_norm(y, z, p.gated_norm.scale, cfg)
    return y @ p.out_proj, state, torch.cat([conv[:, 1:], new_seg], dim=1)


@pytest.mark.parametrize("dtype,conv_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                              ("bfloat16", "float32")],
                         ids=["fp32", "bf16_engine", "bf16_slot_server"])
@pytest.mark.parametrize("arch", ["mamba2", "granite"])
def test_mamba_decode_writes_its_cache_in_place(arch, dtype, conv_dtype):
    """``mamba_decode`` leaves the cache's state and conv window in their own
    storage (the addresses a captured decode step reads), and its output,
    state and window are bitwise what the out-of-place step computed, at the
    reduced mamba2-780m's and the granite-style hybrid's Mamba-2 shapes, for
    a model in fp32 and in bf16 against prefill's bf16 window (Engine) and
    the shared fp32 one (SlotServer)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import mamba2

    cfg = reduced(get_arch("mamba2-780m")) if arch == "mamba2" else HYBRID
    tdtype = getattr(torch, dtype)
    g = torch.Generator().manual_seed(7)
    p = mamba2.Mamba(cfg, tdtype, "cpu", g)
    with torch.no_grad():
        p.A_log.copy_(torch.rand(p.A_log.shape, generator=g))
        p.dt_bias.copy_(torch.randn(p.dt_bias.shape, generator=g))
        p.D.copy_(torch.randn(p.D.shape, generator=g))
    b = 3
    x = torch.randn((b, 1, cfg.d_model), generator=g).to(tdtype)
    empty = mamba2.empty_mamba_cache(cfg, b, "cpu")
    state = torch.randn(empty["state"].shape, generator=g)
    conv = torch.randn(empty["conv"].shape, generator=g).to(getattr(torch, conv_dtype))
    with torch.no_grad():
        want, want_state, want_conv = _mamba_decode_out_of_place(p, x, conv, state, cfg)
        cache = {"state": state.clone(), "conv": conv.clone()}
        ptrs = {k: v.data_ptr() for k, v in cache.items()}
        got, out_cache = mamba2.mamba_decode(p, x, cache, cfg)
    assert out_cache is cache
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs
    assert cache["conv"].dtype == want_conv.dtype
    assert torch.equal(got, want)
    assert torch.equal(cache["state"], want_state)
    assert torch.equal(cache["conv"], want_conv)


@pytest.mark.parametrize("case", ["cpu", "meta", "int_position", "dtensor_cache"])
def test_decode_step_stays_eager_off_the_graphs_path(case, monkeypatch):
    """A model on the CPU or on ``meta``, an int position (a sharded cache's
    form) and a DTensor cache take the eager decode step: ``_graph_key`` refuses each,
    the last two also where the model reads as on the card (where the same
    call with a (B,) position tensor and plain caches would be captured),
    and no graph is captured or replayed."""
    dev = "meta" if case == "meta" else "cpu"
    model = Model(HYBRID, BuildFlags(dtype="float32"), device=dev,
                  seed=None if case == "meta" else 0)
    caches = model.empty_caches(2, 16)
    tokens = torch.zeros((2, 1), dtype=torch.long, device=dev)
    per_slot = torch.tensor([3, 5], dtype=torch.int32, device=dev)
    pos = 3 if case == "int_position" else per_slot
    if case in ("int_position", "dtensor_cache"):
        with monkeypatch.context() as m:
            m.setattr(Model, "device", property(lambda self: torch.device("cuda")))
            assert model._graph_key(tokens, caches, per_slot) is not None
    if case == "dtensor_cache":
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import DTensor, Replicate
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
        try:
            mesh = DeviceMesh("cpu", [0])
            caches[0]["state"] = DTensor.from_local(caches[0]["state"], mesh, [Replicate()])
            with monkeypatch.context() as m:
                m.setattr(Model, "device", property(lambda self: torch.device("cuda")))
                assert model._graph_key(tokens, caches, pos) is None
        finally:
            dist.destroy_process_group()
    else:
        with monkeypatch.context() as m:
            if case == "int_position":
                m.setattr(Model, "device", property(lambda self: torch.device("cuda")))
            assert model._graph_key(tokens, caches, pos) is None
        with torch.no_grad():
            logits, out = model.decode_step(tokens, caches, pos)
        assert logits.shape == (2, HYBRID.vocab_size) and out is caches
    assert model.decode_graph_captures == model.decode_graph_replays == 0
    assert model._decode_graph is None
