#!/usr/bin/env python3
"""K3, K5 and K6 at deepseek-moe-16b's settings against an earlier commit's,
bitwise, on one CUDA card.

    git archive <commit> | tar -x -C build/parent
    python3 tools/compare_parent_kernels.py --parent build/parent

Runs each checkout in a process of its own (``--side ROOT --save FILE``:
the port imported from ROOT/src, its kernels built into ROOT/build), on
the same seeded inputs:

* K3 (bf16) at dsmoe16b's prefills, 16/16 heads of 128, d ** -0.5;
* K5 at E 64, k 6, at a decode step's and a prefill's rows, ties included;
* K6 (bf16, rope on, d ** -0.5) at dsmoe16b's chat and longdoc decode
  shapes with per-slot positions: the output and both caches;
* a reduced deepseek-moe-16b (bf16, K3 and K5) served whole: its prefill
  logits and three decode steps' logits, at a (B,) position tensor.

Every tensor must be bitwise equal between the two.  Prints one JSON line
a case and the card's name and power limit; exits 1 if any differs.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def outputs() -> dict:
    """The cases' outputs with the port on ``sys.path``, as CPU tensors."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import decode_attention as k6
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import topk_gating as k5
    from repro_torch.models import BuildFlags, Model

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}

    def randn(shape, seed, dtype=torch.float32):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    for s in (512, 3000):
        q, k, v = (randn((1, s, 16, 128), s + i, torch.bfloat16) for i in range(3))
        out[f"k3_s{s}"] = fa.flash_attention(q, k, v, causal=True)
    for t in (24, 32, 3000):
        for ties in (False, True):
            logits = randn((t, 64), t)
            if ties:
                logits = torch.round(logits * 2) / 2
            p, ids = k5.topk_gating(logits, 6)
            out[f"k5_t{t}_ties{int(ties)}"] = torch.cat([p, ids.float()], dim=1)
    for name, b, s_max, lo, hi in (("chat", 32, 2560, 64, 1724), ("longdoc", 24, 4096, 2048, 4000)):
        q = randn((b, 1, 16, 128), 1, torch.bfloat16)
        k_new, v_new = (randn((b, 1, 16, 128), 2 + i, torch.bfloat16) for i in range(2))
        ck, cv = (randn((b, s_max, 16, 128), 4 + i, torch.bfloat16) for i in range(2))
        pos = torch.tensor(np.random.default_rng(b).integers(lo, hi, b), dtype=torch.int32,
                           device="cuda")
        out[f"k6_{name}"] = k6.decode_attention(q, k_new, v_new, ck, cv, pos, 10000.0)
        out[f"k6_{name}_cache_k"], out[f"k6_{name}_cache_v"] = ck, cv

    cfg = reduced(get_arch("deepseek-moe-16b"))
    model = Model(cfg, BuildFlags(dtype="bfloat16", attn_impl="flash"), device="cuda", seed=0)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 300)),
                             device="cuda")
    with torch.inference_mode():
        logits, caches = model.prefill({"tokens": tokens})
        out["model_prefill"] = logits
        full = model.empty_caches(2, 304)
        for c, f in zip(caches, full):
            for key in c:
                f[key][:, :c[key].shape[1]] = c[key]
        nxt = logits.argmax(-1, keepdim=True)
        pos = torch.full((2,), 300, dtype=torch.int32, device="cuda")
        for i in range(3):
            logits, full = model.decode_step(nxt, full, pos + i)
            out[f"model_decode{i}"] = logits.clone()    # the graph's buffer, rewritten next step
            nxt = logits.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def side(root: str, save: str) -> int:
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    torch.save(outputs(), save)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of the earlier checkout")
    ap.add_argument("--side", help=argparse.SUPPRESS)
    ap.add_argument("--save", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.side:
        return side(args.side, args.save)
    import torch

    if not torch.cuda.is_available():
        print("compare_parent_kernels: PyTorch sees no CUDA device", file=sys.stderr)
        return 1
    got = {}
    with tempfile.TemporaryDirectory(prefix="parent_kernels") as tmp:
        for label, root in (("parent", os.path.abspath(args.parent)), ("change", HERE)):
            path = os.path.join(tmp, f"{label}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--side", root,
                            "--save", path], check=True, cwd=root)
            got[label] = torch.load(path)
    bad = 0
    for key, want in got["parent"].items():
        have = got["change"][key]
        same = have.shape == want.shape and torch.equal(have, want)
        bad += not same
        print(json.dumps({"case": key, "shape": list(want.shape), "bitwise_equal": same,
                          "max_abs_diff": None if same or have.shape != want.shape
                          else (have.float() - want.float()).abs().max().item()}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"cases": len(got["parent"]), "differ": bad, "card": smi}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
