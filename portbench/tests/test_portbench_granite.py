"""The hybrid configuration (granite4h) at a tiny size on the CPU: the
port's prefill and decode through ``SlotServer`` against the plain
reference ``reference/granite_hybrid.py``, the cell run end to end with
the port's spans on, and the readers of its counters and spans."""
import time

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.harness import BENCH, Run, load_json, port_arch, reader
from portbench.reference import granite_hybrid
from portbench.reference.common import Precision
from portbench.tests._tiny import TRAFFIC, bench

MS = 1_000_000
# 10 layers (one period of the pattern: attention at index 5), GQA 4/2,
# NoPE at a scale of 1/16 (1/d as granite's 1/128), 16 experts of which 10
# are routed a token (so the plain K5 path runs k > 8), 2 shared of 32
TINY = dict(n_layers=10, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, attn_scale=1 / 16,
            n_experts=16, moe_top_k=10, moe_d_ff=32, n_shared_experts=2, ssm_state=16,
            ssm_head_dim=16, ssm_chunk=8, vocab_size=256, dtype="float32")


def _config():
    return dict(load_json(BENCH / "configs" / "granite4h.json"), **TINY)


def _serve(cfg, prompts, max_new, seed):
    """Serve ``prompts`` through a SlotServer of 3 slots; return the weights
    and, per request, its served tokens and the logits that chose them."""
    from repro_torch.models.model import BuildFlags, Model
    from repro_torch.serve.kv_cache import SlotServer

    model = Model(port_arch(cfg), BuildFlags(dtype="float32", attn_impl=cfg["attn_impl"],
                                             ssd_impl=cfg["ssd_impl"]),
                  device="cpu", seed=None)
    params = weights.fill(model, seed)
    server = SlotServer(model, 3, 64)
    logits = {i: {} for i in range(len(prompts))}
    by_prompt = {p.tobytes(): i for i, p in enumerate(prompts)}
    prefill, decode = model.prefill, model.decode_step

    def on_prefill(batch):
        out = prefill(batch)
        logits[by_prompt[np.asarray(batch["tokens"][0]).tobytes()]][0] = out[0][0]
        return out

    def on_decode(tokens, caches, pos):
        held = [(s, r.rid, len(r.out)) for s, r in enumerate(server.active) if r is not None]
        out = decode(tokens, caches, pos)
        for s, rid, at in held:
            logits[rid][at] = out[0][s]
        return out

    model.prefill, model.decode_step = on_prefill, on_decode
    for i, p in enumerate(prompts):
        server.submit(i, p, max_new)
    done = {r.rid: r for r in server.run()}
    served = [torch.tensor(done[i].out) for i in range(len(prompts))]
    return params, served, [torch.stack([logits[i][j] for j in range(len(served[i]))])
                            for i in range(len(prompts))]


@pytest.mark.parametrize("seed", [2**33 + 1, 7])
def test_reference_matches_the_slot_server(seed):
    """Five prompts (one of 41 tokens, whose prefill drops assignments over
    capacity) through 3 slots, so slots are freed and refilled: every
    served token's logits within 1e-5 of max |logit| of the reference's
    (both float32; they differ in the order of sums: the plain chunked scan,
    the cached decode), and the fp8 control over 100 times further off."""
    cfg = _config()
    rng = np.random.default_rng(seed % 2**32)
    prompts = [rng.integers(0, cfg["vocab_size"], n).astype(np.int32) for n in (5, 41, 13, 3, 22)]
    params, served, port = _serve(cfg, prompts, 7, seed)
    worst, low = 0.0, 0.0
    for p, toks, lg in zip(prompts, served, port):
        assert len(toks) == 7
        ref = granite_hybrid.served_logits(params, cfg, torch.as_tensor(p), toks)
        assert torch.allclose(ref, lg, atol=1e-5 * lg.abs().max(), rtol=0), \
            float((ref - lg).abs().max())
        worst = max(worst, float((ref - lg).abs().max()))
        ctl = granite_hybrid.served_logits(params, cfg, torch.as_tensor(p), toks,
                                           Precision(control=True))
        low = max(low, float((ctl - ref).abs().max()))
    assert low > 100 * worst


def test_the_long_prompt_drops_and_the_reference_follows():
    """The 41-token prompt drops assignments (capacity 32 of 410 over 16
    experts); the reference without the drops lies over 100 times further
    off than the reference with them."""
    from portbench.reference import decoder

    cfg = _config()
    assert decoder.capacity(41, cfg) == 32 and decoder.capacity(3, cfg) == 16
    prompt = torch.full((41,), 3, dtype=torch.int32)         # every token routes alike: drops
    params, served, port = _serve(cfg, [prompt.numpy()], 4, seed=5)
    ref = granite_hybrid.served_logits(params, cfg, prompt, served[0])
    off = (ref - port[0]).abs().max()
    assert off <= 1e-5 * port[0].abs().max()
    undropped = dict(cfg, capacity_factor=100.0)
    assert (granite_hybrid.served_logits(params, undropped, prompt, served[0])
            - port[0]).abs().max() > 100 * off


@pytest.mark.parametrize("key", ["attn_scale", "embedding_multiplier", "residual_multiplier",
                                 "logits_scaling"])
def test_the_reference_reads_each_setting(key):
    """Doubling one setting moves the reference's logits by more than ten
    times the 1e-7 of max |logit| that float32 sums in another order
    would (at random weights the embedding, times 12, dominates the
    stream, so the mixers' share of a logit is small)."""
    cfg = _config()
    prompt = torch.arange(9) % cfg["vocab_size"]
    params, served, _ = _serve(cfg, [prompt.numpy().astype(np.int32)], 3, seed=3)
    base = granite_hybrid.served_logits(params, cfg, prompt, served[0])
    other = dict(cfg, **{key: 2.0 * cfg[key]})
    moved = granite_hybrid.served_logits(params, other, prompt, served[0]) - base
    assert moved.abs().max() > 1e-6 * base.abs().max()


def test_hybrid_readers_on_synthetic_records():
    """``moe_drop_share.longdoc`` sums the counters over the window;
    ``decode_mamba_device_ms.longdoc`` takes the device time under
    model.decode_step's layer.mamba spans a decode step;
    ``decode_step_ms.longdoc`` the window's decode walls."""
    run = Run("granite4h.longdoc", _config(), {}, setup_s=1.0, t0=0.0, t1=0.1)
    run.counters = [("moe.assignments", 10 * MS, 400), ("moe.dropped", 10 * MS, torch.tensor(6)),
                    ("serve.kv_used", 10 * MS, 5),
                    ("moe.assignments", 50 * MS, 100), ("moe.dropped", 50 * MS, torch.tensor(0)),
                    ("moe.assignments", 200 * MS, 900), ("moe.dropped", 200 * MS, 900)]
    assert reader("moe_drop_share.longdoc")(run) == pytest.approx(100 * 6 / 500)
    run.counters = run.counters[2:3]
    assert reader("moe_drop_share.longdoc")(run) is None
    assert reader("decode_mamba_device_ms.longdoc")(run) is None           # not traced
    run.trace = {"attribution": {"no_launch": 0, "stray_kernels": 0, "decode_steps": 2,
                                 "device_by_path": {
                                     "serve.step/model.decode_step/layer.mamba": 0.010,
                                     "serve.step/model.decode_step/layer.ffn": 0.030,
                                     "serve.step/model.decode_step/layer.attn": 0.002,
                                     "serve.step/serve.admit/model.prefill/layer.mamba": 0.5}}}
    assert reader("decode_mamba_device_ms.longdoc")(run) == pytest.approx(5.0)
    run.decodes = [(0.01, 0.02, [3]), (0.03, 0.034, [4]), (0.09, 0.2, [5])]
    assert reader("decode_step_ms.longdoc")(run) == pytest.approx(7.0)


@pytest.fixture
def traced(monkeypatch):
    monkeypatch.syspath_prepend(str(BENCH))
    import traced

    return traced


def test_tiny_cell_with_the_spans_on(traced):
    """The cell at the tiny size through ``harness.run_cell`` with the
    port's spans on: correct, no failed request, the counters of the MoE
    and of the recurrent state read, K3's and K4's plain paths taken."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        over = {"config": TINY, "traffic": TRAFFIC}
        res, run = traced.run_with_spans(bench(), "granite4h.longdoc", 2**32 + 5, 2.0, False,
                                         True, device=torch.device("cpu"),
                                         t_process=time.perf_counter(), overrides=over,
                                         log=lambda *a: None)
    finally:
        torch.set_num_threads(before)
    assert res["correct"] and not res["failed"] and res["attempted"]
    assert {"ttft_ms_p95", "setup_s"} <= set(res["metrics"])
    names = {n for n, *_ in run.counters}
    assert {"moe.assignments", "moe.dropped", "serve.state_bytes", "serve.kv_used"} <= names
    cfg = port_arch(dict(_config(), **TINY))
    per_slot = 9 * 4 * (cfg.n_ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
                        + (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state))
    held = [v for n, _, v in run.counters if n == "serve.state_bytes"]
    assert held and all(v % per_slot == 0 and 0 < v <= 4 * per_slot for v in held)
    assert 0 <= reader("moe_drop_share.longdoc")(run) < 100
    assert reader("decode_step_ms.longdoc")(run) > 0
