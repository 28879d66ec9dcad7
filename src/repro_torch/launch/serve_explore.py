"""Multi-tenant exploration service over one loopback fleet.

Port of ``repro/launch/serve_explore.py``.  Where ``launch.explore`` runs
ONE sweep and exits, this entrypoint stands up the long-lived
``ExploreService`` daemon: one fleet of boards, one shared scheduler, K
tenant sweeps multiplexed over it by the fair-share layer (deficit-weighted
round robin with per-tenant weight / priority / max_inflight; see
``repro_torch.core.scheduler``).  The fleet's artifact caches stay
fleet-global, so tenants whose spaces share a ``JConfig.identity()`` warm
each other's builds for free.

    PYTHONPATH=src python -m repro_torch.launch.serve_explore \
        --workload llama2-7b --clients 2 --fleet-cache serve \
        --tenants tenants.json --checkpoint-root results/tenants

``--tenants`` names a JSON file with a list of tenant specs:

    [{"name": "team-a", "algorithm": "random", "samples": 100, "seed": 0,
      "weight": 2.0, "priority": 0, "max_inflight": null,
      "out": "results/team_a.csv",
      "checkpoint_dir": null, "resume": false},
     {"name": "team-b", "algorithm": "bayesopt", "samples": 50,
      "gp": "cuda"}]

Unset fields default to the command-line flags (``--samples``, ``--seed``,
``--gp``, ``--device``, the other gp options).  Every tenant explores the
fleet's one workload space (the boards are built once); what varies per
tenant is the search algorithm and its fair-share contract.

``--gp`` defaults to ``cuda``, as ``launch.explore``'s does: BayesOpt/PAL
tenants run their GP on the card with the hand-written kernels.  The
service needs the card unless ``--device cpu`` or a host tier
(``--gp incremental|refit``) is named; without one it raises and never
falls back to the CPU.

Control plane (``--serve``)
---------------------------
With ``--serve`` the service keeps running after the initial tenants
finish and takes JSON control lines on stdin — one verb per line, the same
``CONTROL_SUBMIT``/``CONTROL_STATUS``/``CONTROL_CANCEL`` messages clients
may push over the wire (``repro_torch.core.transport``):

    {"cmd": "control_submit", "tenant": "team-c",
     "spec": {"algorithm": "random", "samples": 20}}
    {"cmd": "control_status"}
    {"cmd": "control_status", "tenant": "team-a"}
    {"cmd": "control_cancel", "tenant": "team-b"}

Each line gets a one-line JSON reply on stdout.  EOF (or ``{"cmd":
"stop"}``) stops the service once the loop notices.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time
from typing import Any, List, Optional

from repro_torch.launch.explore import (fleet_mode, generation_space,
                                        make_build_fn, start_fleet)

DEVICE_TIERS = ("torch", "cuda")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="llama2-7b", help="arch id")
    p.add_argument("--shape", default="generate",
                   help="'generate' (paper workload) or a SHAPES name")
    p.add_argument("--reduced", action="store_true",
                   help="shrink the arch (repro_torch.configs.reduced)")
    p.add_argument("--clients", type=int, default=2)
    p.add_argument("--chips", type=int, default=8, help="chips per board")
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen-tokens", type=int, default=150)
    p.add_argument("--tenants", default=None, metavar="SPEC.json",
                   help="initial tenant sweeps (JSON list; see module "
                        "docstring for the spec format)")
    p.add_argument("--serve", action="store_true",
                   help="daemon mode: keep the service alive after the "
                        "initial tenants finish and take control verbs on "
                        "stdin (one JSON object per line)")
    p.add_argument("--samples", type=int, default=100,
                   help="default n_samples for tenant specs that omit it")
    p.add_argument("--seed", type=int, default=0,
                   help="default seed for tenant specs that omit it")
    p.add_argument("--out-dir", default="results",
                   help="tenants without an explicit 'out' stream their CSV "
                        "to <out-dir>/<tenant>.csv")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--dispatch", default="eager",
                   choices=["eager", "pipelined"])
    p.add_argument("--chunk-budget-ms", type=float, default=None)
    p.add_argument("--codec", default="json", choices=["json", "binary"])
    p.add_argument("--affinity", default="off",
                   choices=["off", "prefer", "strict"])
    p.add_argument("--pipeline-depth", type=int, default=None)
    p.add_argument("--speculate-at", type=float, default=None, metavar="FRAC")
    p.add_argument("--speculate-slow-mult", type=float, default=None,
                   metavar="MULT")
    p.add_argument("--cache-dir", default=None,
                   help="persistent artifact cache root (per-client "
                        "subtrees, shared by every tenant)")
    p.add_argument("--fleet-cache", default="off",
                   choices=["off", "serve", "relay"])
    p.add_argument("--gp", default="cuda",
                   choices=["incremental", "refit", "torch", "cuda"],
                   help="default surrogate tier of bayesopt/pal tenants "
                        "(launch.explore's docstring)")
    p.add_argument("--device", default=None,
                   help="torch device of --gp torch|cuda (default: the card)")
    p.add_argument("--gp-inducing", type=int, default=5000)
    p.add_argument("--gp-refresh", type=int, default=None, metavar="K")
    p.add_argument("--checkpoint-root", default=None,
                   help="durable tenants: per-tenant snapshot+WAL dirs are "
                        "namespaced under this root "
                        "(durable.tenant_checkpoint_dir)")
    p.add_argument("--checkpoint-every", type=int, default=25)
    return p.parse_args(argv)


def make_sweep_factory(args, space, jc, need_fp):
    """spec dict -> ``ExploreService.submit_sweep`` kwargs.

    Used both for the ``--tenants`` file entries and for wire/stdin
    ``CONTROL_SUBMIT`` specs, so the two paths cannot drift apart."""
    from repro_torch.core import ALGORITHMS, SearchDriver

    knob_names = [k.name for k in space]

    def factory(spec):
        name = spec.get("name", "?")
        algo_name = spec.get("algorithm", "random")
        if algo_name not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {algo_name!r}; choose "
                             f"from {sorted(ALGORITHMS)}")
        algo_kw = {}
        if algo_name in ("bayesopt", "pal"):
            algo_kw = {"gp_mode": spec.get("gp", args.gp),
                       "hyper_refresh_every": spec.get("gp_refresh",
                                                       args.gp_refresh),
                       "inducing_threshold": spec.get("gp_inducing",
                                                      args.gp_inducing),
                       "device": spec.get("device", args.device)}
        algo = ALGORITHMS[algo_name](space, seed=int(spec.get("seed",
                                                              args.seed)),
                                     **algo_kw)
        search = algo
        if spec.get("async_search"):
            search = SearchDriver(algo, mode="async",
                                  max_stale_tells=spec.get("max_stale_tells"),
                                  name=name)
        out = spec.get("out")
        if out is None and args.out_dir:
            out = os.path.join(args.out_dir, f"{name}.csv")
        mi = spec.get("max_inflight")
        return dict(
            search=search, arch=args.workload, shape=args.shape,
            n_samples=int(spec.get("samples", args.samples)),
            csv_path=out, knob_names=knob_names,
            weight=float(spec.get("weight", 1.0)),
            priority=int(spec.get("priority", 0)),
            max_inflight=None if mi is None else int(mi),
            fingerprint_fn=jc.cache_key if need_fp else None,
            checkpoint_dir=spec.get("checkpoint_dir"),
            resume=bool(spec.get("resume", False)))

    return factory


def control_stdin(svc, lines=None):
    """Drain JSON control lines (stdin by default), print JSON replies."""
    src = lines if lines is not None else sys.stdin
    for line in src:
        line = line.strip()
        if not line:
            continue
        try:
            msg = json.loads(line)
        except ValueError as e:
            print(json.dumps({"ok": False, "error": f"bad JSON: {e}"}),
                  flush=True)
            continue
        if msg.get("cmd") == "stop":
            svc.stop()
            print(json.dumps({"ok": True, "stopping": True}), flush=True)
            return
        # SUBMIT specs name the tenant either at top level or in the spec
        if msg.get("tenant") is None and isinstance(msg.get("spec"), dict):
            msg["tenant"] = msg["spec"].get("name")
        if isinstance(msg.get("spec"), dict):
            msg["spec"].setdefault("name", msg.get("tenant"))
        print(json.dumps(svc.handle_control(msg)), flush=True)
    svc.stop()                       # EOF: wind the daemon down


@dataclasses.dataclass
class Served:
    """What one service run leaves: the service (its tenants' sweeps in
    ``service._sweeps``), the clients, the wall seconds of ``run`` and the
    fleet store's ``stats()`` (None with ``--fleet-cache off``)."""
    service: Any
    clients: List[Any]
    wall_s: float
    fleet_stats: Optional[dict]


def main(argv=None) -> Served:
    args = parse_args(argv)
    from repro_torch.configs import SHAPES, get_arch, reduced
    from repro_torch.core import (ExploreService, FleetArtifactStore, JConfig,
                                  hypervolume, tpu_pod_space)
    from repro_torch.device import resolve_device

    if args.gp in DEVICE_TIERS:
        resolve_device(args.device)      # no card and no CPU request: raise
    arch = get_arch(args.workload)
    if args.reduced:
        arch = reduced(arch)
    if args.shape == "generate":
        space = generation_space(arch, args.chips)
    else:
        space = tpu_pod_space(arch, SHAPES[args.shape], n_chips=args.chips)
    jc = JConfig(space, n_chips=args.chips)
    print(f"[serve] space size = {space.size()} ({len(space.knobs)} knobs); "
          f"workload={args.workload}/{args.shape}; {args.clients} boards")

    specs = []
    if args.tenants is not None:
        with open(args.tenants) as f:
            specs = json.load(f)
        if not isinstance(specs, list):
            raise SystemExit(f"--tenants must be a JSON list, "
                             f"got {type(specs).__name__}")
    if not specs and not args.serve:
        raise SystemExit("no tenants: pass --tenants SPEC.json "
                         "(or --serve for stdin control)")

    mode = fleet_mode(args)
    fleet_store = None if mode is None else FleetArtifactStore(mode=mode)
    pair, clients, threads = start_fleet(args, jc, make_build_fn(args, jc))
    need_fp = (args.affinity != "off" or args.speculate_at is not None
               or args.speculate_slow_mult is not None
               or fleet_store is not None)
    svc = ExploreService(
        pair.host(), timeout_s=args.timeout, poll_s=0.05,
        batch_size=args.batch_size, dispatch=args.dispatch,
        chunk_budget_ms=args.chunk_budget_ms, affinity=args.affinity,
        speculate_frac=args.speculate_at,
        speculate_slow_mult=args.speculate_slow_mult,
        pipeline_depth=args.pipeline_depth, fleet_store=fleet_store,
        checkpoint_root=args.checkpoint_root,
        checkpoint_every=args.checkpoint_every, progress=True)
    svc.sweep_factory = make_sweep_factory(args, space, jc, need_fp)

    t0 = time.perf_counter()
    try:
        for spec in specs:
            name = spec.get("name")
            if not name:
                raise SystemExit(f"tenant spec missing 'name': {spec!r}")
            svc.submit_sweep(name, **svc.sweep_factory(spec))
            print(f"[serve] tenant {name!r}: {svc.status(name)}")
        if args.serve:
            ctl = threading.Thread(target=control_stdin, args=(svc,),
                                   daemon=True)
            ctl.start()
            svc.run(stop_when_idle=False)
        else:
            svc.run(stop_when_idle=True)
    finally:
        dt = time.perf_counter() - t0
        for sweep in svc._sweeps.values():
            if hasattr(sweep.search, "poll_ask"):
                sweep.search.close()         # an async SearchDriver's worker
            sweep.store.close()
        svc.stop_clients()
        for t in threads:
            t.join(timeout=5.0)

    done = 0
    for name, sweep in sorted(svc._sweeps.items()):
        st = sweep.store
        ok = st.ok_records()
        done += len(ok)
        line = (f"[serve] tenant {name}: {sweep.state}, "
                f"{sweep.completed}/{sweep.n_samples} done")
        if ok:
            pts = st.objective_matrix(["time_s", "power_w"])
            ref = pts.max(0) * 1.1
            line += (f", pareto {len(st.pareto_front(['time_s', 'power_w']))}"
                     f", hv {hypervolume(pts, ref):.4g}")
        print(line)
    print(f"[serve] {done} evaluations across {len(svc._sweeps)} tenants "
          f"in {dt:.1f}s ({done / max(dt, 1e-9):.1f} evals/s fleet-wide; "
          f"{sum(c.n_compiled for c in clients)} builds)")
    fleet_stats = None if fleet_store is None else fleet_store.stats()
    if args.cache_dir is not None or fleet_store is not None:
        from repro_torch.launch.report import cache_effectiveness

        line, _ = cache_effectiveness([c.cache_info() for c in clients],
                                      fleet_stats)
        print(f"[serve] {line}")
    return Served(svc, clients, dt, fleet_stats)


if __name__ == "__main__":
    main()
