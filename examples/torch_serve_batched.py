"""Batched greedy serving across architectures (incl. the SSM family), on the
port: the counterpart of ``examples/serve_batched.py``.

    python examples/torch_serve_batched.py                 # on the CUDA card
    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu

Reduced tinyllama-1.1b, mamba2-780m and deepseek-moe-16b in fp32 with the
reference's flags, ``Engine(max_len=64)``, a batch of 4 prompts of 12
tokens from ``numpy.random.default_rng(0)``, 24 new tokens each.  The
weights are drawn from seed 0 on the device (``weights`` replaces them, as
the tests do with the reference's).  On the card deepseek-moe-16b's routing
launches K5 (``kernels.topk_gating``).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.device import resolve_device
from repro_torch.models import BuildFlags, Model
from repro_torch.serve import Engine

ARCHS = ("tinyllama-1.1b", "mamba2-780m", "deepseek-moe-16b")
BATCH, PROMPT, GEN, MAX_LEN = 4, 12, 24, 64


def serve(name: str, device, weights=None):
    """Greedy generation for one reduced arch -> (tokens (4, 24) int32, seconds)."""
    arch = reduced(get_arch(name))
    model = Model(arch, BuildFlags(dtype="float32", remat="none", sp=False),
                  device=device, seed=0 if weights is None else None)
    if weights is not None:
        model.load_state_dict(weights)
    eng = Engine(model, max_len=MAX_LEN)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, arch.vocab_size, (BATCH, PROMPT)),
                                       dtype=torch.int32, device=model.device)}
    t0 = time.time()
    res = eng.generate(batch, GEN)
    return res.tokens, time.time() - t0


def main(argv=None, weights=None):
    """Serve each arch and print the reference's line; returns
    {arch: (tokens, seconds)}.  ``weights``: {arch: state dict}, optional."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {}
    for name in ARCHS:
        tokens, dt = serve(name, device, (weights or {}).get(name))
        out[name] = (tokens, dt)
        print(f"{name:<22s} batch={BATCH} prompt={PROMPT} gen={GEN}  {dt:5.2f}s "
              f"({BATCH * GEN / dt:6.1f} tok/s)  first: {tokens[0][:8].tolist()}")
    return out


if __name__ == "__main__":
    main()
