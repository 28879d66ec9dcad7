"""End-to-end training launcher with checkpoint/restart fault tolerance
(port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch tinyllama-1.1b --reduced --steps 50 --batch 8 --seq 128 \
        --checkpoint-dir /tmp/ckpt --save-every 10 --device cpu

Runs on the CUDA card unless ``--device`` names another; it raises when no
card is visible.  Restart semantics: on startup the latest checkpoint in
``--checkpoint-dir`` is restored (one the reference wrote is converted) and
the data pipeline is fast-forwarded to the restored step, so a killed run
resumes bit-exactly: the data pipeline is a pure function of (seed, step),
and the launcher turns on ``torch.use_deterministic_algorithms`` (with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``, which cuBLAS then needs) for its run,
because on the card the backward passes of the embedding gather and of the
MoE's combine gather accumulate with atomics otherwise.  ``--fault-at N``
injects a crash at step N (exit code 42) after draining the checkpoint
writer.  Every logged step prints its loss also as ``float.hex``, so two
runs can be compared bit for bit.
"""
from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="tinyllama-1.1b")
    p.add_argument("--reduced", action="store_true",
                   help="reduced same-family config (CPU-sized)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"])
    p.add_argument("--microbatch", type=int, default=1)
    p.add_argument("--remat", default="selective")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--grad-compress", action="store_true")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--save-every", type=int, default=20)
    p.add_argument("--keep", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fault-at", type=int, default=-1,
                   help="inject a crash at this step (fault-tolerance demo)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None):
    """Train; returns {step: loss} of the logged steps."""
    args = parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return _train(args)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)


def _train(args):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.models import BuildFlags, Model
    from repro_torch.train import (CheckpointManager, TrainStepConfig, adafactor, adamw,
                                   cosine_schedule, init_train_state, load_train_state,
                                   make_train_step)

    arch = get_arch(args.arch)
    if args.reduced:
        arch = reduced(arch)
    flags = BuildFlags(dtype=args.dtype, remat=args.remat, sp=False)
    model = Model(arch, flags, device=args.device, seed=args.seed)
    sched = cosine_schedule(args.lr, max(args.steps // 20, 1), args.steps)
    opt = adafactor(sched) if args.optimizer == "adafactor" else adamw(sched)
    tsc = TrainStepConfig(microbatch=args.microbatch, grad_compress=args.grad_compress)
    step_fn = make_train_step(model, opt, tsc)

    state = init_train_state(model, opt, tsc)
    start = 0
    ck = None
    if args.checkpoint_dir:
        ck = CheckpointManager(args.checkpoint_dir, keep=args.keep)
        latest = ck.latest_step()
        if latest is not None:
            load_train_state(state, ck.restore(latest, state, cfg=arch))
            start = latest
            print(f"[train] resumed from step {start}", flush=True)

    data = SyntheticLM(arch, DataConfig(args.batch, args.seq, args.seed))
    losses = {}
    t0 = time.time()
    for step in range(start, args.steps):
        if step == args.fault_at:
            if ck:
                # crash at a step boundary with in-flight checkpoint IO
                # drained; mid-write crashes are separately survivable via
                # the tmp+rename atomic publish (restore ignores .tmp dirs)
                ck.wait()
            print(f"[train] injected fault at step {step}", flush=True)
            raise SystemExit(42)
        batch = to_device(data.batch(step), model.device)
        state, metrics = step_fn(state, batch)
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            loss = float(metrics["loss"])
            losses[step + 1] = loss
            print(f"[train] step {step+1:5d} loss {loss:.4f} ({loss.hex()}) "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0)/(step-start+1)*1e3:.0f} ms/step)", flush=True)
        if ck and (step + 1) % args.save_every == 0:
            ck.save(step + 1, state)
    if ck:
        if args.steps % args.save_every or start == args.steps:
            ck.save(args.steps, state, block=True)
        ck.wait()       # a save at the last step is already in flight: not written twice
    print("[train] done", flush=True)
    return losses


if __name__ == "__main__":
    main()
