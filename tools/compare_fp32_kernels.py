#!/usr/bin/env python3
"""K3's and K4's fp32 kernels against an earlier commit's, on one CUDA card.

    git archive <commit> | tar -x -C build/parent
    python3 tools/compare_fp32_kernels.py --parent build/parent

Builds the earlier checkout's ``csrc/flash_attention.cu`` and
``csrc/ssd_scan.cu`` beside this tree's (same nvcc flags; the C entry
points are the same) and, in one process:

1. times both at ``chip_smoke.py``'s ``FP32_K3_TIMED`` and ``FP32_K4_TIMED``
   in turns (earlier, this, this, earlier): a loop of launches, one launch,
   the profiler's device time and, for K4, the time inside a CUDA graph;
2. serves llama2-7b's prefill in fp32 (batch 4, prompt 64, random weights
   from seed 0; 2, 8 and 32 layers) with each K3, with attention computed
   in float64 and rounded to fp32 (``exact``), and on the plain path, and
   prints every pair's max |Δlogit| over max |logit|: the floor that fp32
   rounding sets for ``serve_fp32``'s gate;
3. holds each K3 and the plain version against float64 attention on
   random q, k, v whose scores have standard deviation 3, 10 and 30.

Prints one JSON line per measurement and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
sys.path.insert(0, HERE)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--parent", required=True, help="root of the earlier checkout")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("compare_fp32_kernels: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.models import BuildFlags, Model, attention

    typed = {"flash_attention": fa._lib(), "ssd_scan": k4._lib()}
    libs = {}
    for name, lib in typed.items():
        src = os.path.join(args.parent, "src", "repro_torch", "kernels", "csrc", f"{name}.cu")
        out = build.BUILD_DIR / f"parent_{name}.so"
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out), src],
                       check=True, capture_output=True)
        old = ctypes.CDLL(str(out))
        for fn in (n for n in dir(lib) if n.startswith(name.split("_")[0] + "_")):
            entry = getattr(lib, fn)
            if hasattr(entry, "argtypes"):
                getattr(old, fn).argtypes, getattr(old, fn).restype = entry.argtypes, entry.restype
        old._typed = True
        libs[name] = {"earlier": old, "this": lib}

    def use(which):
        for name in libs:
            build._LIBS[name] = libs[name][which]
        fa._FITS.clear()
        k4._FITS.clear()

    def emit(**fields):
        print(json.dumps(fields), flush=True)

    # 1. times, in turns
    for kind, case in ([("k3", c) for c in cs.FP32_K3_TIMED]
                       + [("k4", c) for c in cs.FP32_K4_TIMED]):
        if kind == "k3":
            name, b, s, h, hkv, d, window = case
            q, k, v = cs.qkv(b, s, h, hkv, d, "float32", seed=7)

            def kernel():
                return fa.flash_attention(q, k, v, window=window)
        else:
            name, b, s = case
            xs = cs.ssd_inputs(b, s, 48, 64, 128, "float32", seed=7)

            def kernel():
                return k4.ssd_scan(*xs, chunk=256)
        runs = {"earlier": [], "this": []}
        for which in ("earlier", "this", "this", "earlier"):
            use(which)
            r = {"loop_ms": cs.cuda_ms(kernel, 20), "one_ms": cs.single_ms(kernel),
                 "device_ms": cs.profile(kernel, calls=10)["device_busy_ms"]}
            if kind == "k4":
                r["graph_ms"] = cs.graph_ms(kernel)
            runs[which].append(r)
        emit(measure="time", kernel=kind, case=name, turns="earlier, this, this, earlier", **runs)
    use("this")

    # 2. the logits floor
    real = attention.flash_attention

    def exact(q, k, v, **kw):
        return fa.flash_attention_plain(q.double(), k.double(), v.double(),
                                        causal=kw["causal"], window=kw["window"]).float()

    def rel(a, b):
        return (a - b).abs().max().item() / b.abs().max().item()

    for layers in (2, 8, 32):
        cfg = dataclasses.replace(get_arch("llama2-7b"), n_layers=layers)
        flags = BuildFlags(dtype="float32", attn_impl="flash")
        model = Model(cfg, flags, device="cuda", seed=0)
        plain = cs.same_weights(model, dataclasses.replace(flags, attn_impl="xla"))
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
        logits = {}
        with torch.inference_mode():
            for which in ("this", "earlier"):
                use(which)
                logits[which] = model.prefill({"tokens": tokens})[0].float()
            use("this")
            attention.flash_attention = exact
            try:
                logits["exact"] = model.prefill({"tokens": tokens})[0].float()
            finally:
                attention.flash_attention = real
            logits["plain"] = plain.prefill({"tokens": tokens})[0].float()
        names = list(logits)
        emit(measure="logits_gap_over_max_logit", arch=cfg.name, n_layers=layers,
             **{f"{a}_vs_{b}": rel(logits[a], logits[b])
                for i, a in enumerate(names) for b in names[i + 1:]})
        del model, plain, logits
        torch.cuda.empty_cache()

    # 3. one call against float64, by score scale
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn((4, 64, 32, 128), generator=g, device="cuda") for _ in range(3))
    for scale in (3.0, 10.0, 30.0):
        qs, ks = q * scale / 128 ** 0.25, k * scale / 128 ** 0.25
        want = fa.flash_attention_plain(qs.double(), ks.double(), v.double())
        err = {}
        for which in ("this", "earlier"):
            use(which)
            err[which] = (fa.flash_attention(qs, ks, v).double() - want).abs().max().item()
        use("this")
        err["plain"] = (fa.flash_attention_plain(qs, ks, v).double() - want).abs().max().item()
        emit(measure="max_abs_err_vs_float64", shape=[4, 64, 32, 32, 128], score_std=scale, **err)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
