"""End-to-end training driver on the port: a ~100M-param llama-family model,
a few hundred steps, with checkpointing.  The counterpart of
``examples/train_100m.py``.

    python examples/torch_train_100m.py [--steps 200] [--tiny]        # on the CUDA card
    PYTHONPATH=src python examples/torch_train_100m.py --device cpu --tiny --steps 20

``--tiny`` shrinks the model (``llama-6m``) for a quick run on the CPU; the
default config is ``llama-100m``.  Both are the reference's
``dataclasses.replace`` of tinyllama-1.1b.  fp32, selective remat, AdamW on
the cosine schedule, one microbatch; a checkpoint every 50 steps and at
the end, the two newest kept.  A rerun with the
same ``--ckpt`` resumes from its latest step.  The weights are drawn from seed 0 on the device
(``weights``, a state dict, replaces them, as the tests do with the
reference's).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, SyntheticLM, to_device
from repro_torch.device import resolve_device
from repro_torch.models import BuildFlags, Model
from repro_torch.train import (CheckpointManager, TrainStepConfig, adamw, cosine_schedule,
                               init_train_state, load_train_state, make_train_step)


def arch_for(tiny: bool):
    base = get_arch("tinyllama-1.1b")
    if tiny:
        return dataclasses.replace(base, name="llama-6m", n_layers=4, d_model=128,
                                   n_heads=4, n_kv_heads=2, head_dim=32, d_ff=512,
                                   vocab_size=4096)
    return dataclasses.replace(base, name="llama-100m", n_layers=10, d_model=640,
                               n_heads=10, n_kv_heads=2, head_dim=64, d_ff=1792,
                               vocab_size=32000)


def main(argv=None, weights=None):
    """Train and checkpoint; returns the loss of every step this run took."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_100m_ckpt"))
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    arch = arch_for(args.tiny)
    model = Model(arch, BuildFlags(dtype="float32", remat="selective", sp=False),
                  device=device, seed=0 if weights is None else None)
    if weights is not None:
        model.load_state_dict(weights)
    print(f"model: {arch.name}  params ≈ {arch.param_count()/1e6:.1f}M")

    opt = adamw(cosine_schedule(3e-4, args.steps // 10, args.steps))
    tsc = TrainStepConfig(microbatch=1)
    state = init_train_state(model, opt, tsc)
    step_fn = make_train_step(model, opt, tsc)

    ck = CheckpointManager(args.ckpt, keep=2)
    start = ck.latest_step() or 0
    if start:
        load_train_state(state, ck.restore(start, state))
        print(f"resumed from step {start}")

    data = SyntheticLM(arch, DataConfig(args.batch, args.seq, seed=0))
    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        state, m = step_fn(state, to_device(data.batch(step), device))
        losses.append(float(m["loss"]))
        if (step + 1) % 10 == 0:
            dt = (time.time() - t0) / (step - start + 1)
            tok_s = args.batch * args.seq / dt
            print(f"step {step+1:4d}  loss {losses[-1]:.4f}  "
                  f"{dt*1e3:6.0f} ms/step  {tok_s:7.0f} tok/s", flush=True)
        if (step + 1) % 50 == 0:
            ck.save(step + 1, state)
    ck.save(args.steps, state, block=True)
    print("done; final checkpoint at", args.ckpt)
    return losses


if __name__ == "__main__":
    main()
