"""Multi-process bodies of the port's sharded tests (no JAX here).

``spawn(fn, jobs, world)`` starts ``world`` Python processes on the local machine,
each of which joins one gloo process group (``tcp://localhost``, a free
port), runs ``torch.set_num_threads(1)`` and calls ``fn(rank, jobs)``; rank
0's return value comes back to the caller.  ``jobs`` and the result travel
through files (``torch.save``).  The reference's side of each comparison is
computed by the calling test and passed in ``jobs``.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_STEPS = 4
MOE_BATCH = 4
MOE_TRAIN_STEPS = 3
SSM_PROMPT = 16           # the SSM decode check: a 16-position prefill, then 3 steps
SSM_STEPS = 3


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(fn, jobs, world: int = 4, timeout: int = 600):
    with tempfile.TemporaryDirectory() as d:
        job, out = os.path.join(d, "job.pt"), os.path.join(d, "out.pt")
        torch.save({"fn": f"{fn.__module__}:{fn.__name__}", "jobs": jobs}, job)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), REPO]),
                   WORLD=str(world), PORT=str(free_port()), JOB=job, OUT=out)
        procs = [subprocess.Popen([sys.executable, "-m", "tests._torch_dist_ranks"],
                                  env=dict(env, RANK=str(r)), cwd=REPO,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
        bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
        assert not bad, f"ranks failed {bad}:\n" + "\n".join(
            f"--- rank {r}\n{logs[r][-4000:]}" for r, _ in bad)
        return torch.load(out, weights_only=False)


def _main():
    import importlib

    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
    torch.set_num_threads(1)
    spec = torch.load(os.environ["JOB"], weights_only=False)
    mod, name = spec["fn"].split(":")
    fn = getattr(importlib.import_module(mod), name)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{os.environ['PORT']}",
                            rank=rank, world_size=world)
    try:
        res = fn(rank, spec["jobs"])
        if rank == 0:
            torch.save(res, os.environ["OUT"])
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# tests/test_torch_sharding.py
# ---------------------------------------------------------------------------


def _model(name, params, policy=None, **flag_kw):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import BuildFlags, Model
    from repro_torch.models.convert import params_from_jax

    cfg = flag_kw.pop("cfg", None) or reduced(get_arch(name))
    model = Model(cfg, BuildFlags(dtype="float32", **flag_kw), device="cpu", seed=None)
    model.load_state_dict(params_from_jax(params, cfg))
    if policy is not None:
        policy.param_shardings(model)
    return model


def _train_run(job, opt_name, grad_rs, policy, steps=TRAIN_STEPS):
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.train import init_train_state, make_train_step, optimizer

    model = _model("tinyllama-1.1b", job["params"], policy, remat="none", sp=True,
                   grad_rs=grad_rs)
    opt = optimizer.OPTIMIZERS[opt_name](optimizer.cosine_schedule(1e-3, 2, 20))
    state = init_train_state(model, opt)
    step = make_train_step(model, opt)
    data = SyntheticLM(model.cfg, DataConfig(4, 32, 1))
    return model, state, step, data, lambda i: to_device(data.batch(i), "cpu", policy)


def sharding_checks(rank, jobs):
    import torch.distributed as dist

    from repro_torch.configs import get_arch, reduced
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.launch.mesh import make_mesh_dp_tp
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import ShardingPolicy
    from repro_torch.train import CheckpointManager, load_train_state

    mesh = make_mesh_dp_tp(2, 2)
    out = {"train": {}}

    # ---- sharded train steps against the reference's single device
    for variant, opt_name, grad_rs in (("adamw", "adamw", False),
                                       ("adafactor_grad_rs", "adafactor", True)):
        job = jobs["train"][opt_name]
        policy = ShardingPolicy(mesh)
        model, state, step, _, batch = _train_run(job, opt_name, grad_rs, policy)
        losses, gnorms = [], []
        for i in range(TRAIN_STEPS):
            state, met = step(state, batch(i))
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
        specs = policy.param_specs(model)
        placed = {n: (tuple(p.placements), policy.placements(specs[n]))
                  for n, p in model.named_parameters()}
        out["train"][variant] = {
            "losses": losses, "grad_norms": gnorms, "steps": int(state["step"]),
            "params": {n: p.detach().full_tensor() for n, p in model.named_parameters()},
            "placements_ok": all(a == b for a, b in placed.values())
            and any(s for s in specs.values()),
            "placements": {n: str(a) for n, (a, _) in list(placed.items())[:6]}}

    # ---- grouped MoE: g = 2 (one group per data rank) against g = 1 and the reference
    cfg = reduced(get_arch("deepseek-moe-16b"))
    cfg4 = dataclasses.replace(cfg, capacity_factor=4.0)
    batch = SyntheticLM(cfg, DataConfig(MOE_BATCH, 16, 2)).batch(0)
    rows, drops = [], []
    real = moe.topk_gating

    def recording(logits, k):
        p, ids = real(logits, k)
        rows.append(logits.shape[0])
        c = moe.expert_capacity(logits.shape[0], cfg)
        counts = torch.bincount(ids.long().reshape(-1), minlength=cfg.n_experts)
        drops.append(int((counts - c).clamp(min=0).sum()))
        return p, ids
    res = {}
    for label, c in (("", cfg), ("_cf4", cfg4)):
        policy = ShardingPolicy(mesh, sp=False, fsdp=False)
        with torch.no_grad():
            plain = _model(None, jobs["moe_params"], cfg=c, remat="none", sp=False)
            res["loss_g1" + label] = float(plain.loss_fn(to_device(batch, "cpu"))[0])
            sharded = _model(None, jobs["moe_params"], policy, cfg=c, remat="none", sp=False,
                             fsdp=False)
            moe.topk_gating = recording
            try:
                loss = sharded.loss_fn(to_device(batch, "cpu", policy))[0]
            finally:
                moe.topk_gating = real
            res["loss_g2" + label] = float(loss.full_tensor())
            if not label:
                res["gating_rows"], res["dropped"] = list(rows), sum(drops)
    res["groups"] = policy.moe_groups(MOE_BATCH)
    out["moe"] = res
    out["moe_train"] = _grouped_moe_train(jobs, mesh, cfg, batch)
    out["mamba_grads"] = _mamba_grads(jobs, mesh)
    out["flash"] = _sharded_flash(jobs, mesh)
    out["ssm_decode"] = _sharded_ssm_decode(jobs, mesh)
    out["whole_heads"] = _whole_heads_mamba(jobs)

    # ---- decode steps with the caches sharded by sequence
    out["decode"] = {}
    for b in (4, 1):
        tokens = torch.from_numpy(np.random.default_rng(b).integers(0, 256, (b, 6)))
        got = {}
        for label in ("plain", "sharded"):
            policy = ShardingPolicy(mesh) if label == "sharded" else None
            model = _model("glm4-9b", jobs["glm_params"], policy)
            caches = model.empty_caches(b, 16)
            if policy is not None:
                caches = policy.cache_shardings(model, caches)
                placements = [str(t.placements) for t in caches[0].values()]
            steps = []
            with torch.no_grad():
                for pos in range(tokens.shape[1]):
                    logits, caches = model.decode_step(tokens[:, pos:pos + 1], caches, pos)
                    steps.append((logits.full_tensor() if policy else logits).numpy())
            got[label] = np.stack(steps)
        out["decode"][b] = {**got, "cache_placements": placements,
                            "seq_sharded": all("Shard(dim=1)" in p for p in placements)}

    # ---- checkpoints: sharded vs single device at equal weights, then a resume
    tmp = jobs["tmp"]
    job = jobs["train"]["adamw"]
    for label, policy in (("plain", None), ("sharded", ShardingPolicy(mesh))):
        model, state, *_ = _train_run(job, "adamw", False, policy)
        CheckpointManager(os.path.join(tmp, label), async_save=False).save(0, state)
    dist.barrier()
    files_equal, n_files = True, 0
    for name in sorted(os.listdir(os.path.join(tmp, "plain", "step_00000000"))):
        a, b = (open(os.path.join(tmp, d, "step_00000000", name), "rb").read()
                for d in ("plain", "sharded"))
        files_equal &= a == b
        n_files += 1
    policy = ShardingPolicy(mesh)
    model, state, step, _, batch = _train_run(job, "adamw", False, policy)
    state, _ = step(state, batch(0))
    ck = CheckpointManager(os.path.join(tmp, "resume"), async_save=False)
    ck.save(1, state)
    dist.barrier()
    _, next_met = step(state, batch(1))
    model2, state2, step2, _, _ = _train_run(job, "adamw", False, ShardingPolicy(mesh))
    with torch.no_grad():
        for p in model2.parameters():
            p.zero_()
    load_train_state(state2, ck.restore(1, state2))
    _, resumed = step2(state2, batch(1))
    out["checkpoint"] = {"files_equal": files_equal, "n_files": n_files,
                         "next_loss": float(next_met["loss"]),
                         "resumed_loss": float(resumed["loss"])}
    return out


def _grouped_moe_train(jobs, mesh, cfg, batch):
    """Reduced deepseek-moe-16b at dp = 2 (g = 2, experts over model, FSDP
    on): the gradients of one loss, then MOE_TRAIN_STEPS AdamW steps."""
    from repro_torch.data import to_device
    from repro_torch.parallel.sharding import ShardingPolicy
    from repro_torch.train import init_train_state, make_train_step, optimizer

    policy = ShardingPolicy(mesh, sp=False)
    model = _model(None, jobs["moe_params"], policy, cfg=cfg, remat="none", sp=False)
    placed = to_device(batch, "cpu", policy)
    opt = optimizer.adamw(optimizer.cosine_schedule(1e-3, 2, 20))
    state = init_train_state(model, opt)          # turns the weights' gradients on
    step = make_train_step(model, opt)
    names = [n for n, _ in model.named_parameters()]
    with policy.context():
        loss = model.loss_fn(placed)[0]
        grads = torch.autograd.grad(loss, list(model.parameters()))
    losses, gnorms = [], []
    for _ in range(MOE_TRAIN_STEPS):
        state, met = step(state, placed)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
    return {"loss": float(loss.detach().full_tensor()),
            "grads": {n: g.full_tensor() for n, g in zip(names, grads)},
            "expert_placements": str(model.stack.layers[-1].ffn.experts.wi_gate.placements),
            "losses": losses, "grad_norms": gnorms,
            "params": {n: p.detach().full_tensor() for n, p in model.named_parameters()}}


def _mamba_grads(jobs, mesh):
    """Reduced mamba2-780m on the (2, 2) mesh (SP, FSDP; the mixer on each
    data rank's rows and each model rank's heads): the loss and every
    gradient of one batch, the head count each scan saw and the shapes of
    the weights each rank computed with."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.models import mamba2
    from repro_torch.parallel.sharding import ShardingPolicy
    from repro_torch.train import init_train_state, optimizer

    import torch.distributed as dist

    cfg = reduced(get_arch("mamba2-780m"))
    policy = ShardingPolicy(mesh)
    model = _model(None, jobs["mamba_params"], policy, cfg=cfg, remat="none")
    init_train_state(model, optimizer.adamw(optimizer.cosine_schedule(1e-3, 2, 20)))
    batch = to_device(SyntheticLM(cfg, DataConfig(4, 32, 3)).batch(0), "cpu", policy)
    heads, shares = [], []
    real_scan, real_shares = mamba2.ssd_chunked, policy.head_shares

    def scan(x, *a, **kw):
        heads.append(x.shape[2])
        return real_scan(x, *a, **kw)

    def recording_shares(*a, **kw):
        ns = real_shares(*a, **kw)
        shares.append({n: tuple(getattr(ns, n).shape) for n in ("wz", "wx", "out_proj")})
        return ns
    mamba2.ssd_chunked, policy.head_shares = scan, recording_shares
    try:
        with policy.context():
            loss = model.loss_fn(batch)[0]
            grads = torch.autograd.grad(loss, list(model.parameters()))
    finally:
        mamba2.ssd_chunked = real_scan
        del policy.head_shares
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, (heads, shares))
    return {"loss": float(loss.detach().full_tensor()),
            "grads": {n: g.full_tensor() for (n, _), g in zip(model.named_parameters(), grads)},
            "scan_heads": [h for h, _ in seen], "shares": [sh for _, sh in seen]}


def _sharded_ssm_decode(jobs, mesh):
    """Reduced mamba2-780m and jamba-v0.1-52b under the policy on the (2, 2)
    mesh: a prefill of ``jobs["ssm_tokens"]``'s first SSM_PROMPT positions,
    its caches placed as ``cache_spec`` says, then one decode step for each
    further position; the logits of every step, the caches' placements
    against the specs, and what ``place_caches`` says to a cache one
    position shorter than the prompt."""
    from repro_torch.models.convert import layer_prefixes
    from repro_torch.parallel.sharding import ShardingPolicy

    tokens = torch.from_numpy(jobs["ssm_tokens"])
    b, total = tokens.shape
    out = {}
    for name, params in jobs["ssm_params"].items():
        policy = ShardingPolicy(mesh)
        model = _model(None, params, policy, cfg=jobs["ssm_cfgs"][name])
        steps = []
        with torch.no_grad():
            logits, caches = model.prefill(policy.batch_shardings(
                {"tokens": tokens[:, :SSM_PROMPT]}))
            try:
                policy.place_caches(model, caches, SSM_PROMPT - 1)
                short = None
            except ValueError as e:
                short = str(e)
            caches = policy.place_caches(model, caches, total)
            steps.append(logits.full_tensor().numpy())
            for pos in range(SSM_PROMPT, total):
                tok = policy.batch_shardings({"t": tokens[:, pos:pos + 1]})["t"]
                logits, caches = model.decode_step(tok, caches, pos)
                steps.append(logits.full_tensor().numpy())
        placed = [(tuple(t.placements), policy.placements(
                   policy.cache_spec(f"{prefix}/{key}", tuple(t.shape))))
                  for prefix, cache in zip(layer_prefixes(model.cfg), caches)
                  for key, t in cache.items()]
        out[name] = {"logits": np.stack(steps), "short_cache_error": short,
                     "placements_ok": all(a == w for a, w in placed),
                     "placements": sorted({str(a) for a, _ in placed})}
    return out


def _whole_heads_mamba(jobs):
    """Reduced mamba2-780m widened to 6 heads of 32 (d_inner 192) on a
    (1, 4) mesh with SP: the model axis divides d_inner, so ``wx`` is split
    through a head, but not H, so every rank runs all heads.  The loss and
    every gradient of one batch, then a prefill and a decode step at each
    further position of ``jobs["ssm_tokens"]``."""
    from repro_torch.data import DataConfig, SyntheticLM, to_device
    from repro_torch.launch.mesh import make_mesh_dp_tp
    from repro_torch.parallel.sharding import ShardingPolicy
    from repro_torch.train import init_train_state, optimizer

    cfg = jobs["whole_cfg"]
    policy = ShardingPolicy(make_mesh_dp_tp(1, 4))
    model = _model(None, jobs["whole_params"], policy, cfg=cfg, remat="none")
    init_train_state(model, optimizer.adamw(optimizer.cosine_schedule(1e-3, 2, 20)))
    batch = to_device(SyntheticLM(cfg, DataConfig(4, 32, 3)).batch(0), "cpu", policy)
    with policy.context():
        loss = model.loss_fn(batch)[0]
        grads = torch.autograd.grad(loss, list(model.parameters()))
    tokens = torch.from_numpy(jobs["ssm_tokens"])
    steps = []
    with torch.no_grad():
        logits, caches = model.prefill(policy.batch_shardings({"tokens": tokens[:, :SSM_PROMPT]}))
        caches = policy.place_caches(model, caches, tokens.shape[1])
        steps.append(logits.full_tensor().numpy())
        for pos in range(SSM_PROMPT, tokens.shape[1]):
            tok = policy.batch_shardings({"t": tokens[:, pos:pos + 1]})["t"]
            steps.append(model.decode_step(tok, caches, pos)[0].full_tensor().numpy())
    return {"loss": float(loss.detach().full_tensor()),
            "grads": {n: g.full_tensor() for (n, _), g in zip(model.named_parameters(), grads)},
            "wx_placements": str(model.stack.layers[0].mixer.wx.placements),
            "heads": policy.head_split(cfg.n_ssm_heads), "logits": np.stack(steps)}


def _sharded_flash(jobs, mesh):
    """K3's path under the reference's placements: reduced tinyllama-1.1b's
    flash prefill on the (2, 2) mesh with SP off (batch over data, heads
    over model) and with SP on (q's sequence split over model, gathered
    for K3), and reduced glm4-9b's on a (1, 4) mesh (its 4 q heads split
    beside its 2 kv heads whole); the logits and K3's (q, k) shapes on
    each path."""
    from repro_torch.launch.mesh import make_mesh_dp_tp
    from repro_torch.models import attention
    from repro_torch.parallel.sharding import ShardingPolicy

    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (4, 16)))
    calls, real = [], attention.flash_attention

    def recording(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), type(q).__name__))
        return real(q, k, v, **kw)

    out = {}
    runs = (("sp_off", mesh, "tinyllama-1.1b", jobs["train"]["adamw"]["params"], False),
            ("sp", mesh, "tinyllama-1.1b", jobs["train"]["adamw"]["params"], True),
            ("glm_1x4", make_mesh_dp_tp(1, 4), "glm4-9b", jobs["glm_params"], False))
    attention.flash_attention = recording
    try:
        with torch.no_grad():
            for label, m, name, params, sp in runs:
                policy = ShardingPolicy(m, sp=sp)
                model = _model(name, params, policy, attn_impl="flash", sp=sp)
                logits = model.prefill(policy.batch_shardings({"tokens": tokens}))[0]
                out[label] = {"logits": logits.full_tensor().numpy(), "calls": list(calls)}
                calls.clear()
    finally:
        attention.flash_attention = real
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_pipeline.py
# ---------------------------------------------------------------------------


def collective_checks(rank, inputs):
    """The pipeline over a 4-stage ``pipe`` mesh and ``psum_int8`` over the
    host mesh's ``data`` axis; every rank's outputs, gathered on rank 0."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.compress import psum_int8
    from repro_torch.parallel.pipeline import pipeline_apply

    pipe = init_device_mesh("cpu", (dist.get_world_size(),), mesh_dim_names=("pipe",))
    out = pipeline_apply(pipe, "pipe", lambda w, x: torch.tanh(x @ w),
                         torch.from_numpy(inputs["ws"]), torch.from_numpy(inputs["xs"]))
    q = psum_int8(torch.from_numpy(inputs["shards"][rank]), (make_host_mesh(), "data"))
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (out.numpy(), q.numpy()))
    return {"pipeline": [g[0] for g in got], "psum_int8": [g[1] for g in got]}


if __name__ == "__main__":
    _main()
