#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which fails loudly (the script exits non-zero on any
failed check and then prints no result):

1. device: the card's name and power limit (nvidia-smi) and torch's name;
2. build: every kernel of the serving path compiled from ``csrc/`` with
   nvcc for sm_90a, with the ``-Xptxas -v`` resource report;
3. kernel parity: each kernel against its plain PyTorch version on the card
   (TF32 off), fp32 at 2e-5 and bf16 at 2e-2 (``tests/test_kernels.py``'s
   tolerances), and each bf16 case also against the plain version in fp32
   on the same inputs at one bf16 rounding (``BF16_VS_FP32``), at every
   shape the main path gives a kernel (``main_path_cases``) and beyond;
4. main path: llama2-7b at full width in bf16 with random weights from a
   seeded ``torch.Generator``, served through ``Engine.generate`` and a
   ``SlotServer``, with ``attn_impl="flash"``; the kernels' launch counts
   are reset just before and read just after, and must equal the number of
   attention layers times prefill calls.  The outputs are checked: the bf16
   flash path against an fp32 copy of the weights on the plain grouped path
   (at most ``DRIFT_RATIO`` times as far off as the bf16 plain path),
   flash against the plain path on a 2-layer full-width model (within 5 %
   of the logit scale), and on a small fp32 model flash against plain at
   5e-5 and SlotServer against Engine token for token;
5. times: CUDA-event times of each kernel, its plain version and the
   library call that computes the same function, beside the least time the
   card could take (bytes over 3.35 TB/s or operations over the dtype's
   peak, whichever is larger), and the serving times.

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
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; fp32 off the tensor cores
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
        device = {f"{key}_device_ms": profile(fn, calls=10)["device_busy_ms"] for key, fn in (
            ("kernel", lambda: fa.flash_attention(q, k, v, window=window)),
            ("plain", lambda: fa.flash_attention_plain(q, k, v, window=window)),
            ("library", lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)))}
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by, **device)
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
    infos = build.build_all(["flash_attention"], force=True)
    emit("build", wall_seconds=time.perf_counter() - t0,
         kernels={n: {"seconds": i.seconds, "library": str(i.path.relative_to(REPO))}
                  for n, i in infos.items()})
    for name, info in infos.items():
        print(f"[build] {name} -Xptxas -v:\n{info.log.strip()}", flush=True)

    errs = phase_parity()
    launches = phase_main_path(N_LAYERS, SEED)
    phase_two_layer_gap(SEED)
    phase_small_reference()
    kernels = phase_times(errs, launches)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
