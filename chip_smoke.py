#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which fails loudly (the script exits non-zero on any
failed check and then prints no result):

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: every kernel of both paths (K3; K1a, K1b and K2 in one source)
   compiled from ``csrc/`` with nvcc for sm_90a, one nvcc per source started
   together, with the ``-Xptxas -v`` resource report;
3. kernel parity: K3 against its plain PyTorch version on the card
   (TF32 off), fp32 at 2e-5 and bf16 at 2e-2 (``tests/test_kernels.py``'s
   tolerances), and each bf16 case also against the plain version in fp32
   on the same inputs at one bf16 rounding (``BF16_VS_FP32``), at every
   shape the main path gives a kernel (``main_path_cases``) and beyond;
4. main path (serving): llama2-7b at full width in bf16 with random weights
   from a seeded ``torch.Generator``, served through ``Engine.generate`` and
   a ``SlotServer``, with ``attn_impl="flash"``; K3's launch count is reset
   just before and read just after, and must equal the number of
   attention layers times prefill calls.  The outputs are checked: the bf16
   flash path against an fp32 copy of the weights on the plain grouped path
   (at most ``DRIFT_RATIO`` times as far off as the bf16 plain path),
   flash against the plain path on a 2-layer full-width model (within 5 %
   of the logit scale), and on a small fp32 model flash against plain at
   5e-5 and SlotServer against Engine token for token;
5. gp_parity: K1a, K1b and K2 against their plain versions in float64 on
   real GP states (cap 64 and 8192, n on a tile edge, just past one and
   6250, B = 1, 7 -> 8 and 512, isotropic and ARD; P = 512 with staircases
   of S = 2 and S = 129): w, g and the new rows of L and L⁻¹ (``gp_append``
   against the torch tier's dense append) within 1e-10 · max(1, max|ref|),
   EHVI within 1e-8; each kernel launched twice on the same inputs must
   give bitwise-equal outputs;
6. search_small: BayesOpt (ehvi, parego) and PAL with ``gp_mode="cuda"``
   make the same picks as ``gp_mode="incremental"`` (numpy, on the host) on
   ``tpu_pod_space(n_chips=256)`` fed 1,000 observations and 30 ask/tell
   cycles;
7. search_main (the GP path): BayesOpt(ehvi, pool 512, inducing threshold
   5000) fed synthetic observations in 512-row blocks to 10⁴ and 10⁵, the
   size of the reference's ``bign_ask_curve``, for ``gp_mode="cuda"`` and
   then ``"torch"`` on the identical feed; the GP kernels' launch counts are
   reset just before the cuda run and read just after, and must equal the
   GP's ``cuda_appends``/``cuda_scores``; every timed ask's EHVI scores,
   and the posterior means of each checkpoint's last timed pool, agree
   between the tiers within 1e-8; tell+ask ms, active set, capacity,
   device memory and where a cycle's time goes are printed;
8. times: CUDA-event times of each kernel, its plain version and the
   library call that computes the same function (where one does), as a loop
   of launches, as one launch between synchronisations and as the
   profiler's device time, beside the least time the card could take (bytes
   over 3.35 TB/s or operations over the dtype's peak, whichever is larger),
   and the serving times.

Standard output ends with a ``kernels`` JSON line, the nvidia-smi line and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

HBM_BYTES_PER_S = 3.35e12                        # H100 SXM data sheet
# dense peaks from NVIDIA's H100 SXM data sheet: fp32 off the tensor cores,
# fp64 on them (DMMA; 34 TFLOP/s on the CUDA cores)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "float64": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# A bf16 kernel output against the plain version run in fp32 on the same
# (bf16-valued) inputs: one bf16 rounding of the output (at most 2**-8 of
# its magnitude) plus fp32 summation noise.
BF16_VS_FP32 = {"atol": 1e-4, "rtol": 2 ** -8}
N_LAYERS = 32                                    # llama2-7b's full depth
SEED = 0
ARCH = "llama2-7b"
# The main path's traffic: one Engine batch, and the SlotServer's requests
# (each prefilled alone, so K3 sees B=1 at each prompt length).
ENGINE_BATCH, ENGINE_PROMPT, ENGINE_NEW = 4, 64, 32
SLOT_PROMPTS = (64, 17, 40, 33)
SLOT_NEW = (8, 12, 6, 10)
# bf16 flash prefill logits over 32 layers may sit at most this many times
# as far from the fp32 reference as the bf16 plain grouped path does.
DRIFT_RATIO = 1.25


def emit(tag, **fields):
    print(json.dumps({"phase": tag, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def single_ms(fn, reps=10):
    """Median CUDA-event time of one call of ``fn`` between synchronisations:
    no queue of launches behind it, so host work between launches cannot
    hide in it or add to it."""
    import statistics

    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attended_pairs(s, window):
    """(query, key) pairs a causal (windowed) attention over s positions needs."""
    if not window:
        return s * (s + 1) // 2
    return sum(min(window, i + 1) for i in range(s))


def flash_bound(b, s, h, hkv, d, window, dtype):
    """(bound_ms, bound_by) of one attention call: q, k, v read once, o written once."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = elt * b * s * d * (2 * h + 2 * hkv)
    flops = 4 * b * h * d * attended_pairs(s, window)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def qkv(b, s, h, hkv, d, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    return [torch.randn(shape, generator=g, device="cuda").to(dt)
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]


def main_path_cases():
    """(name, B, S, H, Hkv, d, window, dtype) of every K3 call the main path
    makes: the Engine prefill and each SlotServer prefill, at llama2-7b's
    heads in bf16."""
    from repro_torch.configs import get_arch

    cfg = get_arch(ARCH)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return ([("engine_prefill", ENGINE_BATCH, ENGINE_PROMPT, h, hkv, d, 0, "bfloat16")]
            + [(f"slot_prefill_s{n}", 1, n, h, hkv, d, 0, "bfloat16") for n in SLOT_PROMPTS])


# Beyond the main path: (name, B, S, H, Hkv, d, window, dtype)
EXTRA_CASES = [
    ("long_prompt", 1, 2048, 32, 32, 128, 0, "bfloat16"),
    ("gqa_d64", 2, 256, 32, 4, 64, 0, "bfloat16"),
    ("ragged", 2, 200, 8, 8, 128, 0, "bfloat16"),
    ("window", 2, 300, 8, 2, 64, 96, "bfloat16"),
    ("d32_window", 2, 130, 4, 4, 32, 24, "bfloat16"),
    ("main_path_fp32", 1, 64, 32, 32, 128, 0, "float32"),
    ("long_prompt_fp32", 1, 2048, 32, 32, 128, 0, "float32"),
    ("gqa_d64_fp32", 2, 256, 32, 4, 64, 0, "float32"),
    ("ragged_window_fp32", 2, 200, 8, 2, 128, 48, "float32"),
    ("d16_fp32", 2, 100, 4, 2, 16, 0, "float32"),
]


def phase_parity():
    """K3 against its plain version on every case: at TOL (the plain version
    forms bf16 logits as the reference oracle does), and for bf16 also
    against the plain version in fp32 on the same inputs at BF16_VS_FP32."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    errs = {}
    for i, (name, b, s, h, hkv, d, window, dtype) in enumerate(main_path_cases() + EXTRA_CASES):
        q, k, v = qkv(b, s, h, hkv, d, dtype, seed=100 + i)
        got = fa.flash_attention(q, k, v, causal=True, window=window).float()
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, causal=True, window=window).float()
        err = (got - want).abs().max().item()
        tol = TOL[dtype]
        ok = bool(torch.allclose(got, want, atol=tol, rtol=tol))
        extra = {}
        if dtype == "bfloat16":
            want32 = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                              causal=True, window=window)
            ok32 = bool(torch.allclose(got, want32, **BF16_VS_FP32))
            extra = dict(max_abs_err_vs_fp32=(got - want32).abs().max().item(),
                         tol_vs_fp32=BF16_VS_FP32, ok_vs_fp32=ok32)
            ok = ok and ok32
        emit("parity", kernel="flash_attention", case=name, shape=[b, s, h, hkv, d],
             window=window, dtype=dtype, max_abs_err=err, tol=tol, ok=ok, **extra)
        if not ok:
            raise AssertionError(f"flash_attention disagrees with its plain version on {name}")
        errs[name] = err
    return errs


def same_weights(model, flags, cast=None):
    """A second Model over the same weights with other build flags: the same
    tensors, or copies cast to ``cast``."""
    from repro_torch.models import Model

    twin = Model(model.cfg, flags, device="meta", seed=None)
    sd = model.state_dict()
    if cast is not None:
        sd = {k: v.to(cast) for k, v in sd.items()}
    twin.load_state_dict(sd, assign=True)
    return twin


def phase_two_layer_gap(seed):
    """flash vs the plain grouped path on a 2-layer llama2-7b at full width in
    bf16: max |dlogit| at most 5 % of max |logit|."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import BuildFlags, Model

    cfg = dataclasses.replace(get_arch(ARCH), n_layers=2)
    flags = BuildFlags(dtype="bfloat16", attn_impl="flash")
    model = Model(cfg, flags, device="cuda", seed=seed)
    xla = same_weights(model, dataclasses.replace(flags, attn_impl="xla"))
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (4, 64))
    with torch.inference_mode():
        gap = logits_gap(model.prefill({"tokens": tokens})[0],
                         xla.prefill({"tokens": tokens})[0])
    emit("outputs", n_layers=2, flash_vs_xla=gap)
    if not gap["finite"] or gap["max_abs_diff"] > 0.05 * gap["max_abs_logit"]:
        raise AssertionError(f"2-layer flash and xla prefill logits differ: {gap}")


def logits_gap(a, b):
    import torch

    a, b = a.float(), b.float()
    return {"max_abs_diff": (a - b).abs().max().item(),
            "max_abs_logit": b.abs().max().item(),
            "argmax_agree": (a.argmax(-1) == b.argmax(-1)).float().mean().item(),
            "finite": bool(torch.isfinite(a).all() and torch.isfinite(b).all())}


def phase_main_path(n_layers, seed):
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import BuildFlags, Model
    from repro_torch.serve import Engine, SlotServer
    from repro_torch.serve.engine import pad_caches

    cfg = dataclasses.replace(get_arch(ARCH), n_layers=n_layers)
    flags = BuildFlags(dtype="bfloat16", attn_impl="flash")
    t0 = time.perf_counter()
    model = Model(cfg, flags, device="cuda", seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    emit("init", arch=cfg.name, n_layers=n_layers, d_model=cfg.d_model,
         params=n_params, weight_bytes=n_params * 2,
         seconds=time.perf_counter() - t0)

    rng = np.random.default_rng(seed)
    batch, prompt, n_gen = ENGINE_BATCH, ENGINE_PROMPT, ENGINE_NEW
    tokens = rng.integers(0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    slot_prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in SLOT_PROMPTS]
    slot_new = list(SLOT_NEW)
    engine = Engine(model, max_len=prompt + n_gen + 1)
    n_attn = sum(1 for s in cfg.layer_specs() if s.mixer in ("attn", "attn_local"))

    # ---- the main path, with every kernel's launch count set to 0 just before
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    res = engine.generate({"tokens": tokens}, n_gen)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    srv = SlotServer(model, n_slots=2, max_len=128)
    for i, (p, n) in enumerate(zip(slot_prompts, slot_new)):
        srv.submit(i, p, n)
    t0 = time.perf_counter()
    finished = srv.run()
    torch.cuda.synchronize()
    slot_s = time.perf_counter() - t0
    launches = {"flash_attention": fa.flash_attention.launches}
    # ---- end of the main path
    peak = torch.cuda.max_memory_allocated()

    want = n_attn * (1 + len(slot_prompts))
    emit("main_path", engine_seconds=gen_s, slot_server_seconds=slot_s,
         launches=launches, expected_flash_launches=want,
         max_memory_allocated=peak)
    if launches["flash_attention"] != want:
        raise AssertionError(f"flash_attention launched {launches['flash_attention']} "
                             f"times on the main path, expected {want}")
    if res.tokens.shape != (batch, n_gen) or not (
            (res.tokens >= 0).all() and (res.tokens < cfg.vocab_size).all()):
        raise AssertionError(f"Engine tokens wrong: shape {res.tokens.shape}")
    if sorted(r.rid for r in finished) != list(range(len(slot_prompts))) or any(
            len(r.out) != slot_new[r.rid] for r in finished):
        raise AssertionError("SlotServer did not finish every request at its length")

    # ---- outputs: the bf16 flash path against the bf16 plain grouped path and
    # against an fp32 copy of the same weights on the plain path.  Over 32
    # bf16 layers both bf16 paths drift from fp32; the flash path must not
    # drift further than DRIFT_RATIO times as far as the plain one.
    xla = same_weights(model, dataclasses.replace(flags, attn_impl="xla"))
    with torch.inference_mode():
        lf, _ = model.prefill({"tokens": tokens})
        lx, _ = xla.prefill({"tokens": tokens})
        ref = same_weights(model, dataclasses.replace(flags, attn_impl="xla", dtype="float32"),
                           cast=torch.float32)
        lr, _ = ref.prefill({"tokens": tokens})
        del ref
    gaps = {"flash_vs_xla": logits_gap(lf, lx), "flash_vs_fp32": logits_gap(lf, lr),
            "xla_vs_fp32": logits_gap(lx, lr)}
    emit("outputs", n_layers=n_layers, **gaps)
    if not (gaps["flash_vs_xla"]["finite"] and gaps["xla_vs_fp32"]["finite"]) or (
            gaps["flash_vs_fp32"]["max_abs_diff"]
            > DRIFT_RATIO * gaps["xla_vs_fp32"]["max_abs_diff"]):
        raise AssertionError(f"bf16 flash prefill is off the fp32 reference: {gaps}")

    # ---- serving times (after the counted run, so they count no launches)
    with torch.inference_mode():
        prefill_ms = cuda_ms(lambda: model.prefill({"tokens": tokens}), iters=5, warmup=1)
        _, caches = model.prefill({"tokens": tokens})
        caches = pad_caches(caches, prompt, prompt + n_gen + 1)
        tok = torch.zeros((batch, 1), dtype=torch.long, device="cuda")
        steps = iter(range(prompt, prompt + n_gen))
        decode_ms = cuda_ms(lambda: model.decode_step(tok, caches, next(steps)),
                            iters=n_gen - 4, warmup=2)
        prof_prefill = profile(lambda: model.prefill({"tokens": tokens}))
        prof_decode = profile(lambda: model.decode_step(tok, caches, prompt + 1))
    # busy share: device kernel time over the unprofiled CUDA-event time
    emit("profile", step="prefill", batch=batch, prompt=prompt,
         device_busy_share=prof_prefill["device_busy_ms"] / prefill_ms, **prof_prefill)
    emit("profile", step="decode", batch=batch,
         device_busy_share=prof_decode["device_busy_ms"] / decode_ms, **prof_decode)
    emit("serve", batch=batch, prompt=prompt, n_gen=n_gen,
         prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
         generate_tokens_per_s=batch * n_gen / gen_s,
         slot_server_tokens_per_s=sum(slot_new) / slot_s,
         max_memory_allocated=peak)
    del xla, model, caches
    torch.cuda.empty_cache()
    return launches


def profile(fn, calls=1, top=6):
    """Device kernel time per call of ``fn`` over ``calls`` calls, summed and
    by kernel name.

    Only the device-side kernel events are summed (the CPU-side operator
    events also carry the device time of the kernels they launch)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += e.device_time_total / 1e3 / calls
            by_name[e.name][1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    return {"device_busy_ms": sum(ms for ms, _ in by_name.values()),
            "n_kernels": sum(n for _, n in by_name.values()) / calls,
            "top": [{"name": name[:72], "ms": ms, "calls": n / calls}
                    for name, (ms, n) in ranked[:top]]}


def device_times(**fns):
    """``{key}_device_ms`` (profiler kernel time per call, over 10 calls) and
    ``{key}_kernels_per_call`` (kernel events recorded per call) for each
    function: a wrapper launches one kernel per call, so a count below 1
    says the trace dropped launches and the time per call reads low."""
    out = {}
    for key, fn in fns.items():
        p = profile(fn, calls=10)
        out[f"{key}_device_ms"] = p["device_busy_ms"]
        out[f"{key}_kernels_per_call"] = p["n_kernels"]
    return out


def phase_small_reference():
    """On a small fp32 model: SlotServer equals Engine token for token, and the
    flash and plain grouped prefill logits agree at 5e-5."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import BuildFlags, Model
    from repro_torch.serve import Engine, SlotServer

    cfg = reduced(get_arch("llama2-7b"))
    flags = BuildFlags(dtype="float32", attn_impl="flash")
    model = Model(cfg, flags, device="cuda", seed=0)
    xla = same_weights(model, dataclasses.replace(flags, attn_impl="xla"))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    with torch.inference_mode():
        lf, _ = model.prefill({"tokens": toks})
        lx, _ = xla.prefill({"tokens": toks})
    diff = (lf - lx).abs().max().item()
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 9, 7)]
    new = [6, 4, 8]
    srv = SlotServer(model, n_slots=2, max_len=48)
    for i, (p, n) in enumerate(zip(prompts, new)):
        srv.submit(i, p, n)
    got = {r.rid: r.out for r in srv.run()}
    same = all(got[i] == Engine(model, max_len=48).generate({"tokens": p[None]}, n)
               .tokens[0].tolist() for i, (p, n) in enumerate(zip(prompts, new)))
    emit("small_reference", flash_vs_xla_max_abs_diff=diff, slot_server_equals_engine=same)
    if diff > 5e-5 or not same:
        raise AssertionError("small fp32 model: flash/xla or SlotServer/Engine disagree")


def phase_times(errs, launches):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    rows = {}
    timed = ("slot_prefill_s64", "engine_prefill", "long_prompt")
    for name, b, s, h, hkv, d, window, dtype in main_path_cases() + EXTRA_CASES:
        if name not in timed:
            continue
        q, k, v = qkv(b, s, h, hkv, d, dtype, seed=7)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        iters = 200 if s <= 256 else 20
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, window=window), iters)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, window=window), iters)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), iters)
        bound_ms, bound_by = flash_bound(b, s, h, hkv, d, window, dtype)
        # Device time of one call from the profiler: at small shapes the
        # event-timed loops above are bound by the host's launch rate.
        device = device_times(
            kernel=lambda: fa.flash_attention(q, k, v, window=window),
            plain=lambda: fa.flash_attention_plain(q, k, v, window=window),
            library=lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          kernel_single_ms=single_ms(lambda: fa.flash_attention(q, k, v, window=window)),
                          **device)
        emit("time", kernel="flash_attention", case=name, shape=[b, s, h, hkv, d],
             dtype=dtype, grid=[-(-s // fa.TILE_Q), b * h], **rows[name])
    emit("k3_tiles", block_q=fa.TILE_Q, block_kv=fa.TILE_KV, threads=128,
         smem_bytes_d128=fa.smem_bytes(128), smem_bytes_d64=fa.smem_bytes(64))
    main = rows["slot_prefill_s64"]
    return [{"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:31",
             "launches": launches["flash_attention"],
             "max_abs_err": max(errs[c[0]] for c in main_path_cases()),
             "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
             "bound_by": main["bound_by"], "library_ms": main["library_ms"]}]

# ---------------------------------------------------------------------------
# The GP path (the searcher's surrogate): K1a, K1b, K2
# ---------------------------------------------------------------------------

GP_DEVICE = "cuda"
GP_SEED = 3
GP_NOISE = 1e-3               # the GP's default observation noise
GP_REL_TOL = 1e-10            # w, g, new L / L⁻¹ rows: over max(1, max|ref|)
EHVI_TOL = 1e-8               # absolute, as tests/test_gp_pallas.py
SEARCH_D = 14                 # tpu_pod_space(n_chips=256) has 14 knobs
SEARCH_CAP, SEARCH_N = 8192, 6250   # pow2 capacity and largest active set
# (name, cap, n, m, d, ard) of the append cases: n on a tile edge, just past
# one and at the search path's active set; B = 1, 7 -> 8 and 512
GP_APPEND_CASES = [
    ("cap64_first", 64, 0, 7, SEARCH_D, False),
    ("cap64_edge", 64, 48, 7, SEARCH_D, False),
    ("cap64_past_edge_ard", 64, 17, 16, SEARCH_D, True),
    ("edge_b512", SEARCH_CAP, 6144, 512, SEARCH_D, False),
    ("past_edge_b8_ard", SEARCH_CAP, 6145, 7, SEARCH_D, True),
    ("active_b1", SEARCH_CAP, SEARCH_N, 1, SEARCH_D, False),
    ("active_b512_ard", SEARCH_CAP, SEARCH_N, 512, SEARCH_D, True),
]
# (name, cap, n, P, d, front points, ard) of the EHVI cases: S = pow2 + 1
GP_EHVI_CASES = [
    ("cap64_s2", 64, 40, 512, SEARCH_D, 1, False),
    ("search_s2", SEARCH_CAP, SEARCH_N, 512, SEARCH_D, 1, False),
    ("search_s17", SEARCH_CAP, SEARCH_N, 512, SEARCH_D, 12, False),
    ("search_s129_ard", SEARCH_CAP, SEARCH_N, 512, SEARCH_D, 100, True),
]
SMALL_FEED, SMALL_BLOCK, SMALL_CYCLES = 1000, 64, 30
MAIN_CHECKPOINTS = (10_000, 100_000)
FOLD_BLOCK = 512
TIMED_CYCLES = 20
PROFILE_CYCLES = 5


def toy_objectives(space, knobs):
    """The deterministic objectives of ``tests/test_gp_pallas.py``."""
    import numpy as np

    x = space.encode(knobs)
    time_ = 2.0 - 1.2 * x[0] + 0.4 * x[1] + 0.1 * np.sin(7 * x.sum())
    power = 0.5 + 1.5 * x[0] ** 2 + 0.2 * x[2]
    return np.array([time_, power])


def f64(a):
    import numpy as np
    import torch

    return torch.as_tensor(np.asarray(a, float), dtype=torch.float64, device=GP_DEVICE)


def gp_state(cap, n, m, d, ard, seed):
    """A real GP state: n random rows factored by the torch tier's masked
    refactor, and an m-row block padded to its pow2 height.  Returns
    (ls, xb, lb, lib, xnew, ls2, ils, xs, xq): the last four are what K1a
    sees (the new rows written into X, and both pre-scaled under ARD)."""
    import numpy as np

    from repro_torch.core.search import gp_torch

    rng = np.random.default_rng(seed)
    ls = rng.uniform(0.5, 1.5, d) if ard else 0.3
    xrows = np.zeros((cap, d))
    xrows[:n] = rng.random((n, d))
    xb = f64(xrows)
    lb, lib = gp_torch._refactor(xb, n, ls, GP_NOISE, 1.0)
    xpad = np.zeros((1 << max(m - 1, 0).bit_length(), d))
    xpad[:m] = rng.random((m, d))
    xnew = f64(xpad)
    xs = xb.clone()
    xs[n:n + len(xpad)] = xnew
    if ard:
        ils = f64(1.0 / ls)
        return ls, xb, lb, lib, xnew, 1.0, ils, xs * ils, xnew * ils
    return ls, xb, lb, lib, xnew, ls * ls, None, xs, xnew


def ehvi_case(cap, n, P, d, n_front, ard, seed):
    """K2's inputs: random rows and weights, a random front on x + y = 1
    padded to pow2 with zero-width segments, its staircase and the means."""
    import numpy as np

    rng = np.random.default_rng(seed)
    xb = np.zeros((cap, d))
    xb[:n] = rng.random((n, d))
    alpha = np.zeros((cap, 2))
    alpha[:n] = rng.standard_normal((n, 2)) * 0.05
    front = np.sort(rng.random(n_front))
    F = 1 << max(n_front - 1, 0).bit_length()
    fpad = np.stack([np.concatenate([front, np.full(F - n_front, 1.2)]),
                     np.concatenate([1.0 - front, np.full(F - n_front, 1.0 - front[-1])])], 1)
    ref = np.array([1.2, 1.1])
    stair = np.stack([np.concatenate([[-np.inf], fpad[:, 0]]),
                      np.concatenate([fpad[:, 0], ref[:1]]),
                      np.concatenate([ref[1:], fpad[:, 1]])])
    ymd = np.array([[0.2, 0.3], [0.2, 0.3]])
    ls = rng.uniform(0.5, 1.5, d) if ard else 0.3
    ils = f64(1.0 / ls) if ard else None
    xq = f64(rng.random((P, d)))
    xs = f64(xb)
    return dict(ls=ls, ls2=1.0 if ard else ls * ls, xb=xs, alpha=f64(alpha),
                xq=xq, xqs=xq if ils is None else xq * ils,
                xs=xs if ils is None else xs * ils, stair=f64(stair), ymd=f64(ymd),
                fpad=f64(fpad), ref=f64(ref), S=stair.shape[1])


def abs_rel(got, want):
    err = (got - want).abs().max().item()
    return err, err / max(1.0, want.abs().max().item())


def phase_gp_parity():
    """K1a, K1b and K2 against their plain versions on the card, float64;
    each launched twice on the same inputs must repeat bitwise."""
    import torch

    from repro_torch.core.search import gp_torch
    from repro_torch.kernels import gp_ops

    errs = {"gp_w": 0.0, "gp_g": 0.0, "gp_ehvi": 0.0}
    for i, (name, cap, n, m, d, ard) in enumerate(GP_APPEND_CASES):
        ls, xb, lb, lib, xnew, ls2, ils, xs, xq = gp_state(cap, n, m, d, ard, GP_SEED + i)
        w = gp_ops.gp_w(lib, xs, xq, n, m, ls2=ls2, signal=1.0)
        w2 = gp_ops.gp_w(lib, xs, xq, n, m, ls2=ls2, signal=1.0)
        g = gp_ops.gp_g(w, lib, n)
        g2 = gp_ops.gp_g(w, lib, n)
        torch.cuda.synchronize()
        err_w = abs_rel(w, gp_ops.gp_w_plain(lib, xs, xq, n, m, ls2=ls2, signal=1.0))
        err_g = abs_rel(g, gp_ops.gp_g_plain(w, lib, n))
        # the whole append against the torch tier's dense one on copies
        bufs = [xb.clone(), lb.clone(), lib.clone()]
        ok = gp_ops.gp_append(*bufs, n, m, xnew, ils, GP_NOISE, ls2=ls2, signal=1.0)
        dense = [xb.clone(), lb.clone(), lib.clone()]
        ok_dense = bool(gp_torch._append(*dense, n, m, xnew, ls, GP_NOISE, 1.0))
        B = xnew.shape[0]
        err_l = abs_rel(bufs[1][n:n + B], dense[1][n:n + B])
        err_li = abs_rel(bufs[2][n:n + B], dense[2][n:n + B])
        zero = all(not t[n + m:].any() and not t[:, n + m:].any() for t in bufs[1:])
        repeat = bool(torch.equal(w, w2) and torch.equal(g, g2))
        rel = max(err_w[1], err_g[1], err_l[1], err_li[1])
        passed = ok and ok_dense and zero and repeat and rel <= GP_REL_TOL
        emit("gp_parity", kernel="gp_append", case=name, cap=cap, n=n, m=m, B=B, d=d,
             ard=ard, grid_w=[-(-cap // 64), -(-B // 64)], w_err=err_w, g_err=err_g,
             l_rows_err=err_l, lib_rows_err=err_li, tol_rel=GP_REL_TOL, ok_flag=ok,
             ok_flag_dense=ok_dense, zero_invariant=zero, bitwise_repeat=repeat, ok=passed)
        if not passed:
            raise AssertionError(f"gp_append case {name} disagrees with its plain version")
        errs["gp_w"] = max(errs["gp_w"], err_w[0])
        errs["gp_g"] = max(errs["gp_g"], err_g[0])
        del xb, lb, lib, bufs, dense
        torch.cuda.empty_cache()
    for i, (name, cap, n, P, d, n_front, ard) in enumerate(GP_EHVI_CASES):
        c = ehvi_case(cap, n, P, d, n_front, ard, GP_SEED + 100 + i)
        args = (c["xqs"], c["xs"], c["alpha"], n, c["stair"], c["ymd"])
        got = gp_ops.gp_ehvi(*args, ls2=c["ls2"], signal=1.0)
        got2 = gp_ops.gp_ehvi(*args, ls2=c["ls2"], signal=1.0)
        torch.cuda.synchronize()
        want = gp_ops.gp_ehvi_plain(*args, ls2=c["ls2"], signal=1.0)
        err = (got - want).abs().max().item()
        repeat = bool(torch.equal(got, got2))
        positive = int((want > 0).sum().item())
        passed = repeat and err <= EHVI_TOL and positive > 0
        emit("gp_parity", kernel="gp_ehvi", case=name, cap=cap, n=n, P=P, d=d, S=c["S"],
             ard=ard, max_abs_err=err, tol=EHVI_TOL, positive_scores=positive,
             max_score=want.max().item(), bitwise_repeat=repeat, ok=passed)
        if not passed:
            raise AssertionError(f"gp_ehvi case {name} disagrees with its plain version")
        errs["gp_ehvi"] = max(errs["gp_ehvi"], err)
    return errs


def run_small(cls, kw, mode, space):
    """One searcher fed SMALL_FEED toy observations in SMALL_BLOCK-row blocks
    (one ask per block folds it in), then SMALL_CYCLES ask/tell cycles."""
    import numpy as np

    extra = {} if mode == "incremental" else {"device": GP_DEVICE}
    algo = cls(space, seed=GP_SEED, pool_size=512, inducing_threshold=None,
               gp_mode=mode, **kw, **extra)
    rng = np.random.default_rng(GP_SEED)
    picks, n = [], 0
    t0 = time.perf_counter()
    while n < SMALL_FEED:
        for _ in range(min(SMALL_BLOCK, SMALL_FEED - n)):
            c = space.sample(rng)
            algo.tell(c, toy_objectives(space, c))
            n += 1
        picks.append(algo.ask(1)[0])
    for _ in range(SMALL_CYCLES):
        c = algo.ask(1)[0]
        algo.tell(c, toy_objectives(space, c))
        picks.append(c)
    return picks, algo._gp.stats() if mode != "incremental" else {}, time.perf_counter() - t0


def phase_search_small():
    """BayesOpt (ehvi, parego) and PAL: the cuda tier's picks equal the
    numpy incremental tier's on the host, at n = 1,000+."""
    from repro_torch.core import BayesOpt, PAL, tpu_pod_space

    space = tpu_pod_space(n_chips=256)
    for name, cls, kw in (("bayesopt_ehvi", BayesOpt, {"strategy": "ehvi"}),
                          ("bayesopt_parego", BayesOpt, {"strategy": "parego"}),
                          ("pal", PAL, {})):
        want, _, host_s = run_small(cls, kw, "incremental", space)
        got, stats, cuda_s = run_small(cls, kw, "cuda", space)
        same = got == want
        emit("search_small", searcher=name, picks=len(got),
             identical=sum(a == b for a, b in zip(got, want)), equal=same,
             incremental_seconds=host_s, cuda_seconds=cuda_s, gp=stats)
        if not same:
            raise AssertionError(f"{name}: cuda picks differ from incremental")


def run_search_tier(mode, follow=None):
    """BayesOpt(ehvi) on tpu_pod_space(n_chips=256), pool 512, default
    inducing threshold (5000), fed ``rng.random(2) + 0.5`` observations in
    FOLD_BLOCK-row blocks to each checkpoint, then a thin, one warm cycle
    and TIMED_CYCLES timed tell+ask cycles (``benchmarks/common.py::
    bign_ask_curve``).  With ``follow`` (the cuda run's picks) every ask
    tells and records the followed pick, so both tiers see one feed."""
    import collections
    import statistics

    import numpy as np
    import torch

    from repro_torch.core import BayesOpt, tpu_pod_space

    space = tpu_pod_space(n_chips=256)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    algo = BayesOpt(space, seed=SEED, n_init=8, pool_size=512, strategy="ehvi",
                    gp_mode=mode, device=GP_DEVICE)
    gp = algo._gp
    rng = np.random.default_rng(SEED)
    spent = collections.defaultdict(float)   # host seconds by step, timed cycles
    timing, scores, picks = [False], [], []

    def timed(obj, name, record=False):
        inner = getattr(obj, name)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            if timing[0]:
                spent[name] += time.perf_counter() - t0
                if record:
                    scores.append((np.array(args[0]), out))
            return out
        setattr(obj, name, wrapper)

    for obj, name in ((algo, "_fresh_pool"), (algo, "observed_values"),
                      (algo, "_update_front"), (gp, "observe"), (gp, "fit_y_multi")):
        timed(obj, name)
    timed(gp, "score_ehvi", record=True)

    def ask():
        c = algo.ask(1)[0]
        picks.append(c)
        if follow is None:
            return c
        want = follow[len(picks) - 1]
        if c != want:          # keep the dedup set on the followed feed
            algo._seen.discard(algo._flat_key(c))
            algo._seen.add(algo._flat_key(want))
        return want

    def cycle():
        c = ask()
        algo.tell(c, rng.random(2) + 0.5)

    out, n = {}, 0
    for ck in MAIN_CHECKPOINTS:
        t0 = time.perf_counter()
        while n < ck:
            for _ in range(min(FOLD_BLOCK, ck - n)):
                algo.tell(space.sample(rng), rng.random(2) + 0.5)
                n += 1
            ask()              # folds the pending block into the GP
        feed_s = time.perf_counter() - t0
        if gp.n_total > int(gp.inducing_threshold * gp.inducing_overflow):
            gp._thin()         # a deterministic active set for the timed cycles
        cycle()                # warm: the first 1-row append at this capacity
        ask()
        spent.clear()
        timing[0] = True
        cycles = []
        for _ in range(TIMED_CYCLES):
            t0 = time.perf_counter()
            cycle()
            cycles.append(time.perf_counter() - t0)
        timing[0] = False
        n += TIMED_CYCLES + 1
        total = sum(cycles)
        # the last timed ask's posterior means (its fit, its pool), outside
        # the timed window: they test the factor state even where every
        # EHVI score is 0
        means = gp.predict_mean_multi(scores[-1][0])
        out[ck] = {"tell_ask_ms": statistics.median(cycles) * 1e3,
                   "tell_ask_ms_min": min(cycles) * 1e3, "tell_ask_ms_max": max(cycles) * 1e3,
                   "n_active": len(gp), "n_total": gp.n_total, "capacity": gp._cap,
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "feed_seconds": feed_s,
                   "host_share": {k: v / total for k, v in spent.items()},
                   "means": means}
    prof = profile(cycle, calls=PROFILE_CYCLES)
    prof["device_busy_share"] = prof["device_busy_ms"] / out[MAIN_CHECKPOINTS[-1]]["tell_ask_ms"]
    return out, prof, gp.stats(), picks, scores


def phase_search_main():
    """The GP path at the size of bign_ask_curve, cuda then torch on one feed.
    K1a/K1b/K2 launch counts: set to 0 just before the cuda run, read just
    after, and held against the GP's own counters."""
    import numpy as np

    from repro_torch.kernels import gp_ops

    kernels = (gp_ops.gp_w, gp_ops.gp_g, gp_ops.gp_ehvi)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    cuda_out, cuda_prof, cuda_stats, cuda_picks, cuda_scores = run_search_tier("cuda")
    cuda_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    # ---- end of the GP path's counted run
    want = {"gp_w": cuda_stats["cuda_appends"], "gp_g": cuda_stats["cuda_appends"],
            "gp_ehvi": cuda_stats["cuda_scores"]}
    t0 = time.perf_counter()
    torch_out, torch_prof, torch_stats, torch_picks, torch_scores = run_search_tier(
        "torch", follow=cuda_picks)
    torch_s = time.perf_counter() - t0
    after = {k.__name__: k.launches for k in kernels}
    if len(cuda_scores) != len(torch_scores) or not all(
            np.array_equal(a[0], b[0]) for a, b in zip(cuda_scores, torch_scores)):
        raise AssertionError("search_main: the two tiers scored different pools")
    score_err = max(float(np.max(np.abs(a[1] - b[1]))) for a, b in zip(cuda_scores, torch_scores))
    positive = sum(int((a[1] > 0).sum()) for a in cuda_scores)
    mean_err = max(float(np.max(np.abs(cuda_out[ck].pop("means") - torch_out[ck].pop("means"))))
                   for ck in MAIN_CHECKPOINTS)
    same = sum(a == b for a, b in zip(cuda_picks, torch_picks)) / len(cuda_picks)
    for ck in MAIN_CHECKPOINTS:
        for mode, out in (("cuda", cuda_out), ("torch", torch_out)):
            emit("search_main", checkpoint=ck, gp_mode=mode, **out[ck])
    emit("search_main_profile", checkpoint=MAIN_CHECKPOINTS[-1], cycles=PROFILE_CYCLES,
         cuda=cuda_prof, torch=torch_prof)
    emit("search_main", launches=launches, expected=want, launches_after_torch_run=after,
         cuda_stats=cuda_stats, torch_stats=torch_stats, timed_asks=len(cuda_scores),
         max_ehvi_diff=score_err, positive_scores=positive, max_mean_diff=mean_err,
         ehvi_tol=EHVI_TOL, identical_pick_share=same,
         asks=len(cuda_picks), cuda_seconds=cuda_s, torch_seconds=torch_s)
    if launches != want or after != launches:
        raise AssertionError(f"GP kernel launches {launches} (after the torch run "
                             f"{after}) do not match the GP's counters {want}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a GP kernel was not launched on the search path: {launches}")
    if score_err > EHVI_TOL or mean_err > EHVI_TOL:
        raise AssertionError(f"cuda and torch EHVI scores differ by {score_err}, "
                             f"posterior means by {mean_err}")
    return launches


def gp_bound(kernel, cap, n, width, d, S=0):
    """(bound_ms, bound_by): K1a/K1b read the active lower triangle of L⁻¹
    and do 2 flop per (row, active column, B column) of it; K2 reads the
    pool, the active rows and weights and the staircase, and does
    P·n·(2d + 9) flop for the kernel row and the means (exp counted as one)
    and 5 per (candidate, segment).  Bytes over 3.35 TB/s, operations over
    the float64 peak."""
    tri = n * (n + 1) // 2
    if kernel == "gp_w":
        nbytes, flops = 8 * (tri + n * d + width * d + cap * width), 2 * tri * width + n * width * (2 * d + 9)
    elif kernel == "gp_g":
        nbytes, flops = 8 * (tri + n * width + width * cap), 2 * tri * width
    else:
        nbytes = 8 * (width * d + n * d + 2 * n + 3 * S + 4 + width)
        flops = width * n * (2 * d + 9) + 5 * width * S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float64"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_gp_times(errs, launches):
    """Times of K1a, K1b and K2 at the search path's shapes (cap 8192,
    n = 6250, d = 14; B = 512 for a fold and 1 for a timed tell; P = 512),
    beside their plain versions, K1b's library product, and the torch
    tier's whole append and scoring."""
    import torch

    from repro_torch.core.search import gp_torch
    from repro_torch.kernels import gp_ops

    cap, n, d = SEARCH_CAP, SEARCH_N, SEARCH_D
    rows = {}
    for m in (512, 1):
        ls, xb, lb, lib, xnew, ls2, _, xs, xq = gp_state(cap, n, m, d, False, GP_SEED)
        w = gp_ops.gp_w(lib, xs, xq, n, m, ls2=ls2, signal=1.0)
        iters = 20 if m > 1 else 100
        fns = {
            "gp_w": (lambda: gp_ops.gp_w(lib, xs, xq, n, m, ls2=ls2, signal=1.0),
                     lambda: gp_ops.gp_w_plain(lib, xs, xq, n, m, ls2=ls2, signal=1.0), None),
            "gp_g": (lambda: gp_ops.gp_g(w, lib, n), lambda: gp_ops.gp_g_plain(w, lib, n),
                     lambda: torch.matmul(w.T, lib)),
        }
        for name, (kernel, plain, library) in fns.items():
            bound_ms, bound_by = gp_bound(name, cap, n, m, d)
            row = dict(ms=cuda_ms(kernel, iters), plain_ms=cuda_ms(plain, iters),
                       library_ms=None if library is None else cuda_ms(library, iters),
                       bound_ms=bound_ms, bound_by=bound_by,
                       kernel_single_ms=single_ms(kernel), plain_single_ms=single_ms(plain),
                       **device_times(kernel=kernel, plain=plain))
            rows[(name, m)] = row
            emit("time", kernel=name, cap=cap, n=n, B=xnew.shape[0], d=d,
                 grid=[-(-cap // 64), -(-xnew.shape[0] // 64)], **row)
        # whole appends, each tier on its own copy of the state; rows >= n
        # are zeroed after every call so each call appends to the same state
        tiers = {}
        for tier in ("cuda", "torch"):
            bufs = [xb.clone(), lb.clone(), lib.clone()]

            def append(bufs=bufs, tier=tier):
                if tier == "cuda":
                    gp_ops.gp_append(*bufs, n, m, xnew, None, GP_NOISE, ls2=ls2, signal=1.0)
                else:
                    gp_torch._append(*bufs, n, m, xnew, ls, GP_NOISE, 1.0)
                bufs[1][n:] = 0.0
                bufs[2][n:] = 0.0
            tiers[f"{tier}_append_ms"] = cuda_ms(append, 10)
            del bufs
        emit("time", step="append", cap=cap, n=n, B=xnew.shape[0], d=d, **tiers)
        rows[("append", m)] = tiers
        del xb, lb, lib, w
        torch.cuda.empty_cache()

    c = ehvi_case(cap, n, 512, d, 12, False, GP_SEED)
    args = (c["xqs"], c["xs"], c["alpha"], n, c["stair"], c["ymd"])
    ym, ysd = c["ymd"][0], c["ymd"][1]

    def kernel():
        return gp_ops.gp_ehvi(*args, ls2=c["ls2"], signal=1.0)

    def plain():
        return gp_ops.gp_ehvi_plain(*args, ls2=c["ls2"], signal=1.0)

    def torch_tier():
        return gp_torch._ehvi(c["xb"], c["alpha"], n, c["xq"], c["fpad"], c["ref"],
                              ym, ysd, c["ls"], 1.0)
    if (torch_tier() - kernel()).abs().max().item() > EHVI_TOL:
        raise AssertionError("K2 and the torch tier's EHVI disagree on the timing inputs")
    bound_ms, bound_by = gp_bound("gp_ehvi", cap, n, 512, d, c["S"])
    rows[("gp_ehvi", 512)] = dict(
        ms=cuda_ms(kernel, 200), plain_ms=cuda_ms(plain, 200), library_ms=None,
        bound_ms=bound_ms, bound_by=bound_by, torch_tier_ms=cuda_ms(torch_tier, 200),
        kernel_single_ms=single_ms(kernel), plain_single_ms=single_ms(plain),
        **device_times(kernel=kernel, plain=plain, torch_tier=torch_tier))
    emit("time", kernel="gp_ehvi", cap=cap, n=n, P=512, d=d, S=c["S"],
         grid=[512 // 4], **rows[("gp_ehvi", 512)])

    emit("gp_tiles", tile=[64, 64], contraction_step=16, threads=256,
         ehvi_warps_per_block=4, smem_bytes_d14={k: gp_ops.smem_bytes(k, d)
                                                 for k in ("gp_w", "gp_g", "gp_ehvi")})
    out = []
    for name, line, width in (("gp_w", 76, 512), ("gp_g", 111, 512), ("gp_ehvi", 224, 512)):
        r = rows[(name, width)]
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/gp_ops.cu",
                    "replaces": f"src/repro/kernels/gp_ops.py:{line}",
                    "launches": launches[name], "max_abs_err": errs[name],
                    "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    emit("device", nvidia_smi=smi, torch_name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())

    t0 = time.perf_counter()
    infos = build.build_all(["flash_attention", "gp_ops"], force=True)
    emit("build", wall_seconds=time.perf_counter() - t0,
         kernels={n: {"seconds": i.seconds, "library": str(i.path.relative_to(REPO))}
                  for n, i in infos.items()})
    for name, info in infos.items():
        print(f"[build] {name} -Xptxas -v:\n{info.log.strip()}", flush=True)

    errs = phase_parity()
    launches = phase_main_path(N_LAYERS, SEED)
    phase_two_layer_gap(SEED)
    phase_small_reference()
    gp_errs = phase_gp_parity()
    phase_search_small()
    gp_launches = phase_search_main()
    kernels = phase_times(errs, launches) + phase_gp_times(gp_errs, gp_launches)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
