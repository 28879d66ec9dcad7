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

Under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment) every process
joins the process group (gloo with ``--device cpu``, NCCL on the card,
each rank on ``cuda:LOCAL_RANK``) and, as the reference does
(``repro/launch/train.py:59-60``), the model is sharded by
``ShardingPolicy(make_host_mesh(), sp=False)``: the batch over the ranks,
the parameters and optimizer slots FSDP-sharded.  Rank 0 alone logs and
writes checkpoints (``train.checkpoint``); a crash at ``--fault-at`` waits
for rank 0's writer at a barrier.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu --reduced \
        --batch 4 --seq 32 --steps 8 --save-every 3 --checkpoint-dir /tmp/ck
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


def _world(args):
    """(rank, world, device): from ``torchrun``'s environment, with the
    process group started when the world is larger than one."""
    import torch
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return 0, 1, args.device
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    device = args.device
    if not cpu:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
        torch.cuda.set_device(device)
    dist.init_process_group("gloo" if cpu else "nccl")
    return dist.get_rank(), world, device


def _train(args):
    rank, world, device = _world(args)
    try:
        return _train_on(args, rank, world, device)
    finally:
        if world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train_on(args, rank, world, device):
    import torch.distributed as dist

    from repro_torch.configs import get_arch, reduced
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.models import BuildFlags, Model
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import ShardingPolicy
    from repro_torch.train import (CheckpointManager, TrainStepConfig, adafactor, adamw,
                                   cosine_schedule, init_train_state, load_train_state,
                                   make_train_step)

    say = print if rank == 0 else (lambda *a, **kw: None)
    arch = get_arch(args.arch)
    if args.reduced:
        arch = reduced(arch)
    policy = None
    if world > 1:
        mesh = make_host_mesh()
        policy = ShardingPolicy(mesh, sp=False)
        say(f"[train] world {world}: ShardingPolicy over {policy.axis_names} "
            f"{world}", flush=True)
    flags = BuildFlags(dtype=args.dtype, remat=args.remat, sp=False)
    model = Model(arch, flags, device=device, seed=args.seed, policy=policy)
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
            say(f"[train] resumed from step {start}", flush=True)

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
            if world > 1:
                dist.barrier()          # rank 0's writer is drained
            say(f"[train] injected fault at step {step}", flush=True)
            raise SystemExit(42)
        batch = to_device(data.batch(step), model.device, policy)
        state, metrics = step_fn(state, batch)
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            loss = float(metrics["loss"])
            losses[step + 1] = loss
            say(f"[train] step {step+1:5d} loss {loss:.4f} ({loss.hex()}) "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0)/(step-start+1)*1e3:.0f} ms/step)", flush=True)
        if ck and (step + 1) % args.save_every == 0:
            ck.save(step + 1, state)
    if ck:
        if args.steps % args.save_every or start == args.steps:
            ck.save(args.steps, state, block=True)
        ck.wait()       # a save at the last step is already in flight: not written twice
    say("[train] done", flush=True)
    return losses


if __name__ == "__main__":
    main()
