"""The port's roofline layer and its build on the ``meta`` device.

* ``roofline/hw.py`` (``HwModel``, ``HwModelBatch``), ``roofline/traffic.py``,
  ``core/jmeasure.py`` and ``core/jconfig.py`` against the JAX package's on
  the same inputs, made with numpy from a seed: bit-identical.
* ``launch/build.py`` (no reference run: the reference's Artifacts are XLA's
  counts of one scanned layer group, ROADMAP Queue 3): every non-frontend
  arch builds at full width on ``meta`` and allocates nothing; its prefill
  and decode FLOPs equal the analytic count below (exact up to float
  rounding, 1e-12 relative, dense, MoE and Mamba-2 alike); the tensor-
  parallel wire bytes equal a hand count; builds in two threads at once
  equal serial ones.
* The MoE dispatch's shape-static scatter gives bitwise the outputs of the
  boolean-mask dispatch it replaced.
"""
import threading

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_arch as ref_get_arch
from repro.configs.base import ShapeConfig as RefShape
from repro.core import jconfig as ref_jconfig
from repro.core import jmeasure as ref_jmeasure
from repro.core.space import tpu_pod_space as ref_pod_space
from repro.models.model import BuildFlags as RefFlags
from repro.roofline import analysis as ref_analysis
from repro.roofline import hw as ref_hw
from repro.roofline import traffic as ref_traffic
from repro_torch.configs import ShapeConfig, get_arch, list_archs, reduced
from repro_torch.core import jconfig, jmeasure
from repro_torch.core.space import tpu_pod_space
from repro_torch.launch import build
from repro_torch.launch.explore import generation_space
from repro_torch.models import moe
from repro_torch.models.model import BuildFlags
from repro_torch.roofline import analysis, hw, traffic

ARCHS = list_archs()
PLAIN_ARCHS = [a for a in ARCHS if not get_arch(a).frontend]


def _same(a, b):
    """Bit-identical values: equal scalars, or arrays equal in shape and
    every element (strings included)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind
        if a.dtype.kind == "f":
            assert np.array_equal(a.view(np.uint64), b.view(np.uint64))
        else:
            assert np.array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def _same_dict(a, b):
    assert a.keys() == b.keys()
    for k in a:
        _same(a[k], b[k])


def _knob_sets(rng, n):
    return [{"clock_scale": float(rng.choice(hw.CLOCK_LADDER)),
             "hbm_scale": float(rng.choice(hw.HBM_LADDER)),
             "ici_scale": float(rng.choice(hw.ICI_LADDER))} for _ in range(n)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_hw_model_bit_identical(seed, dtype):
    rng = np.random.default_rng(seed)
    n_chips = int(rng.choice([1, 8, 256]))
    knobs = _knob_sets(rng, 16)
    flops, hbm, coll = (float(v) for v in 10.0 ** rng.uniform(6, 15, 3))
    for k in knobs:
        ours = hw.HwModel(n_chips=n_chips, dtype=dtype, **k)
        ref = ref_hw.HwModel(n_chips=n_chips, dtype=dtype, **k)
        _same_dict(ours.roofline_terms(flops, hbm, coll), ref.roofline_terms(flops, hbm, coll))
        t = float(rng.uniform(0.0, 2.0))
        _same(ours.power_w(flops, hbm, t), ref.power_w(flops, hbm, t))
    cols = [np.asarray([k[f] for k in knobs]) for f in ("clock_scale", "hbm_scale", "ici_scale")]
    ours = hw.HwModelBatch(n_chips, *cols, dtype=dtype)
    ref = ref_hw.HwModelBatch(n_chips, *cols, dtype=dtype)
    _same_dict(ours.roofline_terms_batch(flops, hbm, coll),
               ref.roofline_terms_batch(flops, hbm, coll))
    steps = rng.uniform(0.0, 2.0, len(knobs))
    steps[0] = 0.0
    _same(ours.power_w_batch(flops, hbm, steps), ref.power_w_batch(flops, hbm, steps))
    _same(hw._clock_pow_2_5(cols[0]), ref_hw._clock_pow_2_5(cols[0]))


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_hbm_bytes_bit_identical(arch):
    ours_arch, ref_arch = get_arch(arch), ref_get_arch(arch)
    for kind, seq, batch in (("prefill", 64, 1), ("decode", 215, 1), ("train", 4096, 256),
                             ("prefill", 32768, 32), ("decode", 32768, 128)):
        for dtype in ("bfloat16", "float32"):
            for bq in (128, 256, 512):
                for remat in ("none", "full"):
                    for dp, tp in ((1, 8), (16, 16)):
                        kw = dict(dtype=dtype, attn_block_q=bq, remat=remat)
                        for opt in ("adamw", "adafactor"):
                            got = traffic.analytic_hbm_bytes_per_device(
                                ours_arch, ShapeConfig("s", kind, seq, batch), BuildFlags(**kw),
                                dp * tp, dp, tp, optimizer=opt)
                            want = ref_traffic.analytic_hbm_bytes_per_device(
                                ref_arch, RefShape("s", kind, seq, batch), RefFlags(**kw),
                                dp * tp, dp, tp, optimizer=opt)
                            _same(got, want)


def _artifacts(rng, with_decode):
    """The same random Artifact (and decode Artifact) in both packages."""
    def fields():
        return dict(flops_per_device=float(10 ** rng.uniform(8, 13)),
                    bytes_per_device=float(10 ** rng.uniform(7, 11)),
                    wire_bytes_per_device=float(10 ** rng.uniform(5, 9)),
                    collectives={"all-reduce": 1.0},
                    arg_bytes=int(rng.integers(1, 2 ** 34)),
                    temp_bytes=int(rng.integers(1, 2 ** 32)),
                    output_bytes=int(rng.integers(1, 2 ** 30)),
                    n_devices=8,
                    hbm_est_per_device=(None if rng.random() < 0.3
                                        else float(10 ** rng.uniform(7, 11))))
    pre = fields()
    meta_ours, meta_ref = {}, {}
    if with_decode:
        dec = fields()
        n_tok = int(rng.integers(0, 200))
        meta_ours = {"decode_artifact": analysis.Artifact(**dec), "n_decode_tokens": n_tok}
        meta_ref = {"decode_artifact": ref_analysis.Artifact(**dec), "n_decode_tokens": n_tok}
    if rng.random() < 0.5:
        meta_ours["n_steps"] = meta_ref["n_steps"] = int(rng.integers(1, 10))
    return (analysis.Artifact(**pre), meta_ours), (ref_analysis.Artifact(**pre), meta_ref)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("with_decode", [False, True])
def test_jmeasure_bit_identical(seed, with_decode):
    rng = np.random.default_rng(seed)
    (art, meta), (ref_art, ref_meta) = _artifacts(rng, with_decode)
    space = generation_space(get_arch("llama2-7b"), 8)
    jc = jconfig.JConfig(space, n_chips=8)
    ref_jc = ref_jconfig.JConfig(space, n_chips=8)
    knobs = [space.sample(rng) for _ in range(12)]
    for ours_m, ref_m in zip(jmeasure.DEFAULT_MEASURES, ref_jmeasure.DEFAULT_MEASURES):
        assert type(ours_m).__name__ == type(ref_m).__name__
        for k in knobs:
            _same_dict(ours_m.measure(art, jc.hw_model(k), meta),
                       ref_m.measure(ref_art, ref_jc.hw_model(k), ref_meta))
        _same_dict(ours_m.measure_batch(art, jc.hw_model_batch(knobs), meta),
                   ref_m.measure_batch(ref_art, ref_jc.hw_model_batch(knobs), ref_meta))
    assert jmeasure.JMemory.HBM_BYTES == ref_jmeasure.JMemory.HBM_BYTES
    ours_r = analysis.roofline_report(art, jc.hw_model(knobs[0]))
    ref_r = ref_analysis.roofline_report(ref_art, ref_jc.hw_model(knobs[0]))
    _same_dict(ours_r, ref_r)


@pytest.mark.parametrize("which", ["generation", "pod"])
def test_jconfig_equal(which):
    rng = np.random.default_rng(1)
    if which == "generation":
        space = generation_space(get_arch("mamba2-780m"), 8)
        ref_space, n_chips = space, 8
    else:
        space, ref_space, n_chips = tpu_pod_space(n_chips=256), ref_pod_space(n_chips=256), 256
    jc, ref_jc = jconfig.JConfig(space, n_chips), ref_jconfig.JConfig(ref_space, n_chips)
    assert jc.identity() == ref_jc.identity()
    for _ in range(20):
        k = space.sample(rng)
        tc = jconfig.TestConfig(3, "a", "generate", k)
        ref_tc = ref_jconfig.TestConfig(3, "a", "generate", k)
        assert jc.cache_key(tc) == ref_jc.cache_key(ref_tc)
        assert jc.hw_model(k) == jconfig.HwModel(**vars(ref_jc.hw_model(k)))
        assert jc.mesh_factors(k) == ref_jc.mesh_factors(k)
        assert dataclasses_equal(jc.build_flags(k), ref_jc.build_flags(k))
        assert tc.to_wire() == ref_tc.to_wire()
        assert jconfig.TestConfig.from_wire(ref_tc.to_wire()) == tc


def dataclasses_equal(ours, ref):
    """Every field the reference's BuildFlags has, equal in the port's."""
    import dataclasses

    return all(getattr(ours, f.name) == getattr(ref, f.name)
               for f in dataclasses.fields(ref))


# ---------------------------------------------------------------------------
# the build on meta
# ---------------------------------------------------------------------------


def analytic_flops(arch, kind, s, b):
    """The matrix products the port's plain paths run: every projection,
    the full (masked) score matrix of the grouped attention, the MoE's
    capacity buffers of every expert, the Mamba-2 chunked scan at the chunk
    the sequence is padded to, and the head at the projected positions
    (the last one of a prefill)."""
    d, v = arch.d_model, arch.vocab_size
    t = b * s if kind == "prefill" else b
    sq = s if kind == "prefill" else 1
    total = 0
    for spec in arch.layer_specs():
        if spec.mixer in ("attn", "attn_local"):
            h, hkv, dh = arch.n_heads, arch.n_kv_heads, arch.d_head
            total += 2 * t * d * (h + 2 * hkv) * dh + 2 * t * h * dh * d
            total += 2 * 2 * b * h * sq * s * dh
        else:
            di, n, hs, p = arch.d_inner, arch.ssm_state, arch.n_ssm_heads, arch.ssm_head_dim
            total += 2 * t * d * (2 * di + 2 * n + hs) + 2 * t * di * d
            if kind == "prefill":
                q = arch.ssm_chunk
                nc = -(-s // q)
                # C·Bᵀ, the masked scores on X, the incoming state, the update
                total += b * nc * (2 * q * q * n + 2 * q * q * hs * p + 4 * q * hs * p * n)
            else:
                total += 2 * b * arch.ssm_conv * (di + 2 * n) + 2 * b * hs * p * n
        if spec.ffn == "dense":
            total += 6 * t * d * (arch.d_ff or arch.moe_d_ff)
        elif spec.ffn == "moe":
            e, fe = arch.n_experts, arch.moe_d_ff
            c = moe.expert_capacity(t, arch)
            total += 2 * t * d * e + 6 * e * c * d * fe + 6 * t * d * arch.n_shared_experts * fe
    return total + 2 * b * d * v


@pytest.fixture
def built_models(monkeypatch):
    """Every ``Model`` the build constructs."""
    made = []

    class Recording(build.Model):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(build, "Model", Recording)
    return made


@pytest.mark.parametrize("arch", PLAIN_ARCHS)
def test_full_width_build_on_meta(arch, built_models):
    """Full width, prompt 64 and a 215-token cache (the explore defaults):
    nothing allocated on a device, FLOPs equal the analytic count."""
    cfg = get_arch(arch)
    pre, dec = build.build_generation(cfg, 1, 8, BuildFlags(), prompt_len=64, max_len=215)
    assert len(built_models) == 2
    for m in built_models:
        for t in list(m.parameters()) + list(m.buffers()):
            assert t.device.type == "meta"
    for cell, kind, s in ((pre, "prefill", 64), (dec, "decode", 215)):
        art = cell.artifact
        assert art.n_devices == 8
        want = analytic_flops(cfg, kind, s, 1) / 8
        assert art.flops_per_device == pytest.approx(want, rel=1e-12, abs=0)
        assert art.bytes_per_device > 0 and art.temp_bytes > 0 and art.output_bytes > 0
        # the parameters over tp=8 (fsdp over dp=1 divides by nothing more)
        params = sum(t.numel() * t.element_size() for t in built_models[0].parameters())
        assert art.arg_bytes >= params // 8


def test_cost_mode_counts_what_flop_counter_mode_counts():
    cfg = reduced(get_arch("deepseek-moe-16b"))
    model = build.Model(cfg, BuildFlags(), device="meta", seed=None)
    tokens = {"tokens": torch.zeros((2, 12), dtype=torch.long, device="meta")}
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model.prefill(tokens)
    mode, _, _ = build._count(model.prefill, tokens)
    assert mode.flops == fc.get_total_flops() > 0


def test_train_shapes_name_their_slice():
    with pytest.raises(NotImplementedError, match="slice 7"):
        build.build_cell(reduced(get_arch("llama2-7b")), ShapeConfig("t", "train", 8, 2), 1, 1)


@pytest.mark.parametrize("sp", [False, True])
def test_tp_wire_bytes_hand_count(sp):
    """One reduced llama layer, prompt 16, batch 2, bf16, tp = 8: the
    attention's and the FFN's outputs, 2·16·64·2 = 4096 B each, and the
    head's 2·256·2 = 1024 B of logits."""
    cfg = reduced(get_arch("llama2-7b"), n_layers=1)
    art = build.build_cell(cfg, ShapeConfig("p", "prefill", 16, 2), 1, 8,
                           BuildFlags(sp=sp)).artifact
    x, head, g = 4096, 1024, 8
    if sp:
        want = {"all-gather": 2 * x * 7 / 8 + head * 7 / 8,
                "reduce-scatter": 2 * x * 7 / 8}
    else:
        want = {"all-reduce": 2 * 2 * x * (g - 1) / g, "all-gather": head * 7 / 8}
    assert art.collectives == want
    assert art.wire_bytes_per_device == sum(want.values())
    one = build.build_cell(cfg, ShapeConfig("p", "prefill", 16, 2), 1, 1,
                           BuildFlags(sp=sp)).artifact
    assert one.collectives == {} and one.wire_bytes_per_device == 0


def test_builds_in_two_threads_equal_serial():
    jobs = [(reduced(get_arch("llama2-7b")), BuildFlags()),
            (reduced(get_arch("mamba2-780m")), BuildFlags(dtype="float32")),
            (reduced(get_arch("deepseek-moe-16b")), BuildFlags()),
            (reduced(get_arch("jamba-v0.1-52b")), BuildFlags(attn_block_q=128))]

    def run(job):
        return build.build_generation(job[0], 1, 8, job[1], prompt_len=40, max_len=96)

    serial = [run(j) for j in jobs]
    threaded = [None] * len(jobs)

    def worker(i):
        for k in range(i, len(jobs), 2):
            threaded[k] = run(jobs[k])

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for a, b in zip(serial, threaded):
        assert [c.artifact for c in a] == [c.artifact for c in b]


# ---------------------------------------------------------------------------
# the MoE dispatch
# ---------------------------------------------------------------------------


def _moe_ffn_masked(p, x, cfg):
    """``moe.moe_ffn`` as it was with the boolean-mask dispatch."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    t = b * s
    c = moe.expert_capacity(t, cfg)
    h = moe.rmsnorm(x, p.norm.scale, cfg.norm_eps)
    xt = h.reshape(t, d)
    top_p, top_ids = moe.topk_gating(xt.float() @ p.router, k)
    weights = top_p / top_p.sum(dim=-1, keepdim=True)
    top_ids = top_ids.long()
    rank = moe._rank_in_expert(top_ids.reshape(t * k), e).reshape(t, k)
    keep = rank < c
    slot = torch.where(keep, top_ids * c + rank, e * c)
    tok = torch.arange(t)[:, None].expand(t, k)
    buf = torch.zeros((e * c, d), dtype=xt.dtype)
    buf[slot[keep]] = xt[tok[keep]]
    buf = buf.reshape(e, c, d)
    we = p.experts
    y = torch.bmm(moe.F.silu(torch.bmm(buf, we.wi_gate)) * torch.bmm(buf, we.wi_up), we.wo)
    y_flat = torch.cat([y.reshape(e * c, d), y.new_zeros((1, d))], dim=0)
    out = torch.zeros((t, d), dtype=x.dtype)
    for i in range(k):
        out = out + y_flat[slot[:, i]] * (weights[:, i, None] * keep[:, i, None]).to(x.dtype)
    out = out.reshape(b, s, d)
    if cfg.n_shared_experts:
        out = out + moe.mlp(h, p.shared.wi_gate, p.shared.wi_up, p.shared.wo)
    return out


@pytest.mark.parametrize("arch,dtype,capacity", [
    ("deepseek-moe-16b", torch.float32, 1.25),
    ("deepseek-moe-16b", torch.bfloat16, 0.5),      # tokens dropped
    ("llama4-maverick-400b-a17b", torch.float32, 1.0),
    ("jamba-v0.1-52b", torch.bfloat16, 0.25),
])
def test_moe_scatter_dispatch_bitwise_unchanged(arch, dtype, capacity):
    cfg = reduced(get_arch(arch), capacity_factor=capacity)
    gen = torch.Generator().manual_seed(0)
    p = moe.MoE(cfg, dtype, "cpu", gen)
    x = torch.randn((2, 13, cfg.d_model), generator=gen).to(dtype)
    torch.testing.assert_close(moe.moe_ffn(p, x, cfg)[0], _moe_ffn_masked(p, x, cfg),
                               atol=0, rtol=0)


def test_moe_builds_on_meta_without_launching():
    from repro_torch.kernels import topk_gating as k5

    before = k5.topk_gating.launches
    logits = torch.empty((7, 64), device="meta")
    p, ids = k5.topk_gating(logits, 6)
    assert p.shape == ids.shape == (7, 6) and p.device.type == ids.device.type == "meta"
    assert p.dtype == torch.float32 and ids.dtype == torch.int32
    assert k5.topk_gating.launches == before
