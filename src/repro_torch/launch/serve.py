"""End-to-end serving entry point: batched greedy generation (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama2-7b --batch 4 --prompt-len 64 --gen 32 --dtype bfloat16

Runs on the CUDA card unless ``--device`` names another (``--device cpu``
runs the plain PyTorch path); it raises when no card is visible.  The
attention path defaults to ``flash`` (the CUDA kernel K3); ``--attn-impl
xla`` selects the plain grouped path, the reference's default.  The Mamba-2
scan defaults to ``cuda`` (the CUDA kernel K4); ``--ssd-impl jnp`` selects
the plain chunked path, the reference's default.  On the card the two plain
choices serve the same weights without K3 or K4, so an operator whose output
looks wrong can tell a kernel fault from a model fault by comparing the
tokens.  MoE routing always goes through the gating kernel K5 on the card.

Inputs are made as the reference makes them: a vision arch gets
``n_frontend_tokens`` random image embeddings and ``max(prompt_len − F, 1)``
text tokens; an audio arch gets ``prompt_len`` random frame embeddings and
no tokens, which ``Engine.generate`` refuses, as the reference's fails.
"""
from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="tinyllama-1.1b")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--attn-impl", choices=("xla", "flash"), default="flash",
                   help="xla: the plain grouped path, without the kernel K3")
    p.add_argument("--ssd-impl", choices=("jnp", "cuda"), default="cuda",
                   help="jnp: the plain chunked scan, without the kernel K4")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import BuildFlags, Model
    from repro_torch.serve import Engine

    arch = get_arch(args.arch)
    if args.reduced:
        arch = reduced(arch)
    flags = BuildFlags(dtype=args.dtype, attn_impl=args.attn_impl, ssd_impl=args.ssd_impl)
    model = Model(arch, flags, device=args.device, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    batch = {}
    ptoks = args.prompt_len
    if arch.frontend == "vision":
        f = arch.n_frontend_tokens
        batch["image_embeds"] = rng.standard_normal((args.batch, f, arch.d_model),
                                                    dtype=np.float32)
        ptoks = max(args.prompt_len - f, 1)
    if arch.frontend == "audio":
        batch["frame_embeds"] = rng.standard_normal((args.batch, ptoks, arch.d_model),
                                                    dtype=np.float32)
    else:
        batch["tokens"] = rng.integers(0, arch.vocab_size, (args.batch, ptoks)).astype(np.int32)

    eng = Engine(model, max_len=args.prompt_len + args.gen + 1)
    t0 = time.time()
    res = eng.generate(batch, args.gen)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.time() - t0
    print(f"[serve] arch={arch.name} device={model.device} attn={args.attn_impl} "
          f"ssd={args.ssd_impl} batch={args.batch} prompt={res.n_prompt} "
          f"generated={res.n_generated} "
          f"in {dt:.2f}s ({args.batch*args.gen/dt:.1f} tok/s)")
    print("[serve] first sequence:", res.tokens[0][:16].tolist())
    return res


if __name__ == "__main__":
    main()
