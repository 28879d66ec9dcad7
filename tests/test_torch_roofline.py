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
from repro_torch.launch.explore import make_build_fn as generation_build_fn
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


def train_flops(arch, s, b, dp, remat):
    """One train step's matrix products in the port's plain paths at the
    reference's MoE groups (g = dp when dp divides the batch): the forward
    (the head over every position), its gradients (two products per
    product: the inputs' and the weights'), and remat's recompute of each
    layer's products inside the backward pass: ``full`` all of them,
    ``selective`` those it does not keep (the batched ones, ``aten.bmm``:
    attention scores and values, the experts).  The recompute (a
    non-reentrant checkpoint) stops once the tensors the backward pass saved
    are back, so a dense layer's last product, the FFN's ``wo``, whose
    output the backward does not need, is not run again; a MoE layer ends
    with its aux loss's product, which needs the recompute to run to the
    end."""
    d, v, t = arch.d_model, arch.vocab_size, b * s
    g = dp if b % dp == 0 and dp > 1 else 1
    mm = bmm = last = 0
    for spec in arch.layer_specs():
        h, hkv, dh = arch.n_heads, arch.n_kv_heads, arch.d_head
        mm += 2 * t * d * (h + 2 * hkv) * dh + 2 * t * h * dh * d
        bmm += 2 * 2 * b * h * s * s * dh
        if spec.ffn == "dense":
            mm += 6 * t * d * (arch.d_ff or arch.moe_d_ff)
            last += 2 * t * d * (arch.d_ff or arch.moe_d_ff)
        elif spec.ffn == "moe":
            e, fe = arch.n_experts, arch.moe_d_ff
            c = moe.expert_capacity(t // g, arch)
            mm += 2 * t * d * e + 6 * t * d * arch.n_shared_experts * fe
            bmm += 6 * e * g * c * d * fe
    head = 2 * t * d * v
    recompute = {"none": 0, "selective": bmm, "full": mm - last + bmm}[remat]
    return 3 * (mm + bmm + head) + recompute


TRAIN = ShapeConfig("train_4k", "train", 4096, 256)


@pytest.mark.parametrize("arch", ["llama2-7b", "deepseek-moe-16b"])
def test_full_width_train_cell_on_meta(arch, built_models):
    """train_4k at full width at dp = 4, tp = 2: nothing allocated off meta,
    the FLOPs of forward, backward and selective remat's recompute equal the
    analytic count, AdamW (under 100e9 parameters) named in the meta."""
    cfg = get_arch(arch)
    cell = build.build_cell(cfg, TRAIN, 4, 2, BuildFlags())
    assert len(built_models) == 1
    for t in list(built_models[0].parameters()) + list(built_models[0].buffers()):
        assert t.device.type == "meta"
    art = cell.artifact
    assert cell.kind == "train" and cell.meta["optimizer"] == "adamw"
    want = train_flops(cfg, 4096, 256, 4, "selective") / 8
    assert art.flops_per_device == pytest.approx(want, rel=1e-12, abs=0)
    assert art.bytes_per_device > 0 and art.temp_bytes > 0
    assert art.output_bytes < art.arg_bytes


@pytest.mark.parametrize("remat", ["none", "selective", "full"])
@pytest.mark.parametrize("arch", ["llama2-7b", "deepseek-moe-16b"])
@pytest.mark.parametrize("dp", [1, 2])
def test_train_cell_flops_per_remat(arch, remat, dp):
    cfg = reduced(get_arch(arch))
    cell = build.build_cell(cfg, ShapeConfig("t", "train", 16, 4), dp, 1,
                            BuildFlags(remat=remat))
    want = train_flops(cfg, 16, 4, dp, remat) / dp
    assert cell.artifact.flops_per_device == pytest.approx(want, rel=1e-12, abs=0)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("grad_rs", [False, True])
@pytest.mark.parametrize("sp", [False, True])
def test_train_cell_state_bytes_and_collectives_hand_count(fsdp, grad_rs, sp):
    """Reduced llama (2 layers, bf16) at dp = 2, tp = 2, batch 4 × 16: the
    state per device from the reference's specs, and the wire bytes of the
    docstring's formulas, counted here leaf by leaf."""
    cfg = reduced(get_arch("llama2-7b"))
    flags = BuildFlags(fsdp=fsdp, grad_rs=grad_rs, sp=sp, remat="full")
    art = build.build_cell(cfg, ShapeConfig("t", "train", 16, 4), 2, 2, flags).artifact
    policy = build.mesh_policy(2, 2, flags)
    model = build.Model(cfg, flags, device="meta", seed=None)
    state, gather, rs, ar = 4.0, 0.0, 0.0, 0.0
    for name, spec in policy.param_specs(model).items():
        p = dict(model.named_parameters())[name]
        axes = {a for e in spec if e for a in ((e,) if isinstance(e, str) else e)}
        n = p.numel() * 2
        state += (n + 8 * p.numel()) / ((2 if "data" in axes else 1) * (2 if "model" in axes else 1))
        pm = n / (2 if "model" in axes else 1)
        if "data" in axes:
            gather += 2 * pm / 2
            rs, ar = (rs + pm / 2, ar) if grad_rs else (rs, ar + pm)
        else:
            ar += pm
    assert ("data" in str(policy.param_specs(model))) == fsdp
    x = 4 * 16 / 2 * 64 * 2                    # tokens / dp × d_model × bf16
    tp_red = 3 * 4 * x / 2                     # 3 passes (remat) × 4 reductions
    ce = 3 * 2 * (4 * 16 / 2) * 4 / 2          # max, sum, gold: fp32 all-reduces
    if sp:   # + the embedding's sum over vocab shares, the head's input gather
        gather, rs = gather + tp_red + 2 * x / 2, rs + tp_red + 2 * x / 2
    else:    # + the embedding's sum, the head's input gradient summed over vocab shares
        ar += 2 * tp_red + 2 * 2 * x / 2
    ar += ce
    want = {k: v for k, v in (("all-gather", gather), ("reduce-scatter", rs),
                              ("all-reduce", ar)) if v}
    assert art.collectives == pytest.approx(want, rel=1e-12)
    assert art.output_bytes == int(state)
    assert art.arg_bytes == int(state + 2 * 4 * 16 * 8 / 2)      # tokens, labels: int64 / dp


@pytest.mark.parametrize("sp", [False, True])
def test_train_moe_collectives_follow_the_expert_layout(sp):
    """Reduced deepseek-moe-16b (an attention + dense layer, an attention +
    MoE layer with one shared expert; E = 4, V = 256) at dp = 2, tp = 2,
    batch 4 × 16, bf16, remat full: the tensor-parallel wire bytes of the
    docstring's formulas, counted here by hand (no parameter terms)."""
    cfg = reduced(get_arch("deepseek-moe-16b"))
    flags = BuildFlags(sp=sp, remat="full")
    got = build.train_collective_bytes(cfg, ShapeConfig("t", "train", 16, 4), flags, 2, 2, [])
    x = 32 * 64 * 2                            # tokens / dp × d_model × bf16
    c = moe.expert_capacity(32, cfg)           # g = 2 groups of 32 tokens
    assert c == 24
    experts = 3 * (4 * c * 64 * 2) / 2         # 3 passes × the group's (E, C, d) outputs
    ce = 3 * 2 * 32 * 4 / 2                    # max, sum, gold: fp32 all-reduces
    if sp:   # 2 mixers + dense + shared + the MoE's rows taken whole, 3 passes;
        #      the embedding; the head's input
        want = {"all-gather": 3 * 5 * x / 2 + experts + 2 * x / 2,
                "reduce-scatter": 3 * 5 * x / 2 + 2 * x / 2, "all-reduce": ce}
    else:    # 2 mixers + dense + shared, 3 passes; the embedding's and the head's all-reduces
        want = {"all-reduce": 3 * 4 * 2 * x / 2 + 2 * 2 * x / 2 + ce, "all-gather": experts}
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("tp", [2, 16])
@pytest.mark.parametrize("sp", [False, True])
def test_train_mamba_collectives_follow_the_head_split(sp, tp):
    """Reduced mamba2-780m (2 Mamba-2 layers, no FFN; D = 64, d_inner =
    128, H = 8, N = 16, K = 4, V = 256) at dp = 2, batch 4 × 16, bf16,
    remat full, ``loss_chunks`` 2: the tensor-parallel wire bytes counted
    here by hand.  At tp = 2 the heads split (``mamba_block_sharded``);
    at tp = 16, which does not divide H, every rank runs the whole mixer."""
    cfg = reduced(get_arch("mamba2-780m"))
    flags = BuildFlags(sp=sp, remat="full", loss_chunks=2)
    got = build.train_collective_bytes(cfg, ShapeConfig("t", "train", 16, 4), flags, 2, tp, [])
    f = (tp - 1) / tp
    tokens = 4 * 16 / 2
    x = tokens * 64 * 2                        # tokens / dp × d_model × bf16
    ce = 2 * 3 * 2 * tokens * 4 * f            # max, sum, gold; again in the recompute
    want = {"all-reduce": ce}
    add = lambda kind, v: want.__setitem__(kind, want.get(kind, 0.0) + v)
    if tp == 2:
        red = 3 * 2 * x * f                    # 3 passes × 2 mixers' output sums
        if sp:
            add("all-gather", red)
            add("reduce-scatter", red)
        else:
            add("all-reduce", 2 * red)
        w = 2 * (64 * 16 + 16 * 4) * 2         # wb, wc, conv_b, conv_c
        add("all-gather", 2 * 2 * w * f)       # forward and recompute, 2 layers
        add("reduce-scatter", 2 * w * f)       # their gradients
        add("all-to-all", 3 * 2 * (128 * 64 / 2 * 2) * f)      # out_proj's rows
        add("all-reduce", 3 * 2 * 2 * tokens * 4 * f)          # the gated norm's squares
    else:    # tp = 16: wz, wx, wb, wc, conv_x, conv_b, conv_c, out_proj gathered
        w = (2 * 64 * 128 + 2 * 64 * 16 + 128 * 4 + 2 * 16 * 4 + 128 * 64) * 2
        add("all-gather", 2 * 2 * w * f)
        if sp:
            add("all-gather", 3 * 2 * x * f)   # the input's sequence; the output's gradient
    if sp:   # the embedding; the head's input gathered twice (chunk recompute)
        add("all-gather", x * f + 2 * x * f)
        add("reduce-scatter", x * f + x * f)
    else:    # the embedding's sum; the head's input gradient
        add("all-reduce", 2 * x * f + 2 * x * f)
    assert got == pytest.approx(want, rel=1e-12)


def test_pick_optimizer_rule():
    assert build.pick_optimizer(get_arch("llama4-maverick-400b-a17b"))[1] == "adafactor"
    assert build.pick_optimizer(get_arch("llama2-7b"))[1] == "adamw"
    assert build.pick_optimizer(get_arch("llama2-7b"), "adafactor")[1] == "adafactor"


def test_explore_train_build_passes_the_optimizer_to_the_hbm_estimate():
    """llama4-maverick-400b-a17b at train_4k on 8 chips: the build picks
    Adafactor, and the HBM estimate is the reference's with Adafactor."""
    import types

    from repro.configs import SHAPES as REF_SHAPES
    from repro_torch.configs import SHAPES
    from repro_torch.core.jconfig import JConfig, TestConfig

    space = tpu_pod_space(get_arch("llama4-maverick-400b-a17b"), SHAPES["train_4k"], n_chips=8)
    jc = JConfig(space, n_chips=8)
    knobs = {k.name: k.values[0] for k in space.knobs}
    args = types.SimpleNamespace(reduced=False, prompt_len=64, gen_tokens=8)
    art, extra = generation_build_fn(args, jc)(
        TestConfig(config_id=0, arch="llama4-maverick-400b-a17b", shape="train_4k", knobs=knobs))
    dp, tp = jc.mesh_factors(knobs)
    flags = jc.build_flags(knobs)
    ref_flags = RefFlags(**{f: getattr(flags, f) for f in RefFlags.__dataclass_fields__})
    want = ref_traffic.analytic_hbm_bytes_per_device(
        ref_get_arch("llama4-maverick-400b-a17b"), REF_SHAPES["train_4k"], ref_flags, 8, dp, tp,
        optimizer="adafactor")
    adamw = ref_traffic.analytic_hbm_bytes_per_device(
        ref_get_arch("llama4-maverick-400b-a17b"), REF_SHAPES["train_4k"], ref_flags, 8, dp, tp)
    assert art.hbm_est_per_device == want != adamw
    assert extra == {}


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
