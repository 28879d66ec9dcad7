"""The JExplore driver: JHost + search algorithm + a real model workload.

Port of ``repro/launch/explore.py``; the paper's experiment:

    PYTHONPATH=src python -m repro_torch.launch.explore \
        --workload llama2-7b --shape generate --algorithm bayesopt --gp cuda

Each "board" is the reference's modeled inference slice (``--chips``, tp
= chips / dp); the workload is the paper's generation task (prompt prefill
plus ``--gen-tokens`` greedy decode tokens).  Hardware-ladder knobs
(clock/HBM/ICI) re-evaluate the analytic JMeasure model against the cached
build; sw knobs rebuild (JClient caches by fingerprint).  A build is
``launch.build``'s count of the port's model on the ``meta`` device, so the
clients run on the host; the card runs the searcher's GP.

GP surrogate modes (``--gp``, bayesopt/pal only):
``cuda``         (the default) the device-resident incremental GP with the
  hand-written kernels: K1a/K1b for each rank-append, K2 for each EHVI pool
  sweep (``BayesOpt(strategy="ehvi")``; ParEGO, BayesOpt's default
  strategy, scores the pool with the GP's predict instead);
``torch``        the same layout in plain PyTorch on the device;
``incremental``  the numpy rank-append GP on the host (the reference's
  default and the numerical reference);
``refit``        the full O(n³) refactor per ask.
``cuda`` and ``torch`` run on the card unless ``--device`` names another,
and raise when no card is visible.

Durable sweeps (``--checkpoint-dir``, ``--resume``): the searcher's state
is snapshotted every ``--checkpoint-every`` results and every ask and tell
goes to a write-ahead log first, so a killed host resumes with zero
duplicate evaluations and, for a sync searcher, the uninterrupted sweep's
picks bit for bit.  ``--chaos-*`` inject seeded faults on the host's wire
(``core.chaos``); ``--chaos-crash-at N`` ends the process with exit code 42
at the N-th result.  ``--fleet-cache serve|relay`` shares builds between the
clients through the host (``core.fleet``): N clients × F fingerprints cost
exactly F builds.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import threading
import time
from typing import Any, List, Optional


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="llama2-7b", help="arch id")
    p.add_argument("--shape", default="generate",
                   help="'generate' (paper workload) or a SHAPES name")
    p.add_argument("--samples", type=int, default=200)
    p.add_argument("--reduced", action="store_true",
                   help="shrink the arch (repro_torch.configs.reduced)")
    p.add_argument("--algorithm", default="random",
                   choices=["random", "grid", "nsga2", "bayesopt", "pal"])
    p.add_argument("--clients", type=int, default=2)
    p.add_argument("--chips", type=int, default=8, help="chips per board")
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen-tokens", type=int, default=150)
    p.add_argument("--out", default="results/explore.csv")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--batch-size", type=int, default=None,
                   help="configs per dispatched chunk (batched fast path); "
                        "default: scalar one-config-per-message dispatch")
    p.add_argument("--dispatch", default="eager",
                   choices=["eager", "pipelined"],
                   help="eager: a client gets its next chunk only after "
                        "answering its current one; pipelined: keep every "
                        "client's queue 2 chunks deep (double-buffering)")
    p.add_argument("--chunk-budget-ms", type=float, default=None,
                   help="adaptive chunk sizing: target this wall-time budget "
                        "per chunk from an EWMA of per-config wall time")
    p.add_argument("--codec", default="json", choices=["json", "binary"],
                   help="wire codec: binary packs columnar frames' numeric "
                        "columns as typed arrays")
    p.add_argument("--affinity", default="off",
                   choices=["off", "prefer", "strict"],
                   help="compile-affinity placement: route chunks to the "
                        "client already holding their sw fingerprint built")
    p.add_argument("--pipeline-depth", type=int, default=None,
                   help="queued chunks per client under --dispatch "
                        "pipelined (default 2)")
    p.add_argument("--speculate-at", type=float, default=None, metavar="FRAC",
                   help="mirror a running chunk to a second client once it "
                        "has burned this fraction of its deadline")
    p.add_argument("--speculate-slow-mult", type=float, default=None,
                   metavar="MULT",
                   help="mirror queued chunks of a client whose per-config "
                        "EWMA exceeds this multiple of the others' median")
    p.add_argument("--cache-dir", default=None,
                   help="persistent artifact cache root: builds are pickled "
                        "content-addressed under <cache-dir>/client<i>/ so "
                        "repeated sweeps skip the build")
    p.add_argument("--fleet-cache", default="off",
                   choices=["off", "serve", "relay"],
                   help="fleet-wide artifact store: clients missing both "
                        "local cache tiers fetch peers' builds through the "
                        "host instead of rebuilding (serve: the host keeps "
                        "a blob cache; relay: it forwards fetches to the "
                        "resident peer), so N clients x F fingerprints "
                        "cost exactly F builds")
    p.add_argument("--max-stale-tells", type=int, default=None,
                   help="with --async-search: discard precomputed asks "
                        "lagging the model by more than this many tells")
    p.add_argument("--async-search", action="store_true",
                   help="precompute asks in a background worker and fold "
                        "tells in at ask boundaries (SearchDriver)")
    p.add_argument("--gp", default="cuda",
                   choices=["incremental", "refit", "torch", "cuda"],
                   help="bayesopt/pal surrogate update (module docstring)")
    p.add_argument("--device", default=None,
                   help="torch device of --gp torch|cuda (default: the card)")
    p.add_argument("--gp-inducing", type=int, default=5000,
                   help="--gp torch|cuda: inducing-point threshold")
    p.add_argument("--gp-refresh", type=int, default=None, metavar="K",
                   help="re-tune the GP lengthscale every K tells")
    p.add_argument("--checkpoint-dir", default=None,
                   help="durable sweeps: snapshot the searcher here and "
                        "write-ahead-log every ask and tell, so a killed "
                        "host can continue with --resume")
    p.add_argument("--checkpoint-every", type=int, default=25,
                   help="completed evaluations between snapshots (the log "
                        "covers the gap)")
    p.add_argument("--resume", action="store_true",
                   help="continue a sweep from --checkpoint-dir and --out: "
                        "re-adopt the CSV, replay the event log, re-submit "
                        "in-flight configs under their original ids")
    p.add_argument("--chaos-crash-at", type=int, default=None, metavar="N",
                   help="fault injection: end the process (os._exit(42), no "
                        "flush or close) when the N-th result frame arrives")
    p.add_argument("--chaos-drop", type=float, default=0.0, metavar="P",
                   help="fault injection: drop outbound config frames with "
                        "probability P")
    p.add_argument("--chaos-dup", type=float, default=0.0, metavar="P",
                   help="fault injection: duplicate outbound config frames "
                        "with probability P")
    p.add_argument("--chaos-seed", type=int, default=0,
                   help="RNG seed of the fault injection")
    return p.parse_args(argv)


def make_build_fn(args, jc):
    """Workload adapter: TestConfig -> (Artifact, meta).  Injected into
    JClient — 'the workloads can be anything' (paper §III)."""
    from repro_torch.configs import SHAPES, ShapeConfig, get_arch, reduced
    from repro_torch.launch.build import build_cell, build_generation
    from repro_torch.roofline.traffic import analytic_hbm_bytes_per_device

    def build(tc):
        arch = get_arch(tc.arch)
        if args.reduced:
            arch = reduced(arch)
        flags = jc.build_flags(tc.knobs)
        dp, tp = jc.mesh_factors(tc.knobs)
        n_dev = dp * tp
        if tc.shape == "generate":
            max_len = args.prompt_len + args.gen_tokens + 1
            pre_cell, dec_cell = build_generation(
                arch, dp, tp, flags, batch=1, prompt_len=args.prompt_len,
                max_len=max_len)
            pre, dec = pre_cell.artifact, dec_cell.artifact
            pre.hbm_est_per_device = analytic_hbm_bytes_per_device(
                arch, ShapeConfig("p", "prefill", args.prompt_len, 1),
                flags, n_dev, dp, tp)
            dec.hbm_est_per_device = analytic_hbm_bytes_per_device(
                arch, ShapeConfig("d", "decode", max_len, 1),
                flags, n_dev, dp, tp)
            return pre, {"decode_artifact": dec,
                         "n_decode_tokens": args.gen_tokens}
        shape = SHAPES[tc.shape]
        cell = build_cell(arch, shape, dp, tp, flags)
        art = cell.artifact
        art.hbm_est_per_device = analytic_hbm_bytes_per_device(
            arch, shape, flags, n_dev, dp, tp,
            optimizer=cell.meta.get("optimizer", "adamw"))
        return art, {}

    return build


class _Timed:
    """Wall seconds and calls of a function, summed over threads."""

    def __init__(self, fn):
        self.fn = fn
        self.seconds = 0.0
        self.calls = 0
        self._lock = threading.Lock()

    def __call__(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return self.fn(*a, **kw)
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.seconds += dt
                self.calls += 1


class _TimedSearch:
    """The searcher seen by JHost, with its ask, tell and (an async
    ``SearchDriver``'s) ``poll_ask`` timed.  Every other attribute
    (``note_demand``, ``state_dict``, the residency hooks) is the
    searcher's own, so JHost finds the same hooks as on the bare one."""

    def __init__(self, search):
        self._search = search
        self.ask = _Timed(search.ask)
        self.tell = _Timed(search.tell)
        if hasattr(search, "poll_ask"):
            self.poll_ask = _Timed(search.poll_ask)

    def __getattr__(self, name):
        return getattr(self._search, name)


def fleet_mode(args) -> Optional[str]:
    """``--fleet-cache`` as ``JClient``'s and the store's mode (None: off)."""
    return None if args.fleet_cache == "off" else args.fleet_cache


def start_fleet(args, jc, build_fn):
    """Stand up the loopback fleet: one JClient serve-thread per board,
    each with its own persistent-cache subtree.  Shared by
    ``launch.explore`` (one sweep) and ``launch.serve_explore``
    (multi-tenant service)."""
    from repro_torch.core import JClient, transport

    pair = transport.LoopbackPair(args.clients, codec=args.codec)
    clients = [JClient(jc, build_fn, transport=pair.client(i), client_id=i,
                       cache_dir=(None if args.cache_dir is None else
                                  os.path.join(args.cache_dir, f"client{i}")),
                       fleet_mode=fleet_mode(args))
               for i in range(args.clients)]
    threads = [threading.Thread(target=c.serve,
                                kwargs=dict(poll_s=0.1, idle_limit_s=None),
                                daemon=True)
               for c in clients]
    for t in threads:
        t.start()
    return pair, clients, threads


def generation_space(arch, chips):
    """Knob space for the paper's generation workload (batch=1 ⇒ dp=1)."""
    from repro_torch.core.space import DesignSpace, Knob, KIND_HW, KIND_SW
    from repro_torch.roofline import hw as hwmod

    knobs = [
        Knob("clock_scale", hwmod.CLOCK_LADDER, KIND_HW),
        Knob("hbm_scale", hwmod.HBM_LADDER, KIND_HW),
        Knob("ici_scale", hwmod.ICI_LADDER, KIND_HW),
        Knob("dp_degree", (1,), KIND_SW),
        Knob("dtype", ("bfloat16",), KIND_SW),
    ]
    if arch.n_heads:
        knobs += [Knob("attn_block_q", (128, 256, 512), KIND_SW),
                  Knob("attn_block_kv", (128, 256, 512), KIND_SW)]
    if arch.ssm_state:
        knobs += [Knob("ssd_chunk", (128, 256, 512), KIND_SW)]
    return DesignSpace(knobs)


@dataclasses.dataclass
class Explored:
    """What one sweep leaves: the results, the searcher, the clients,
    where the wall time went (``timings``), the resume's replay stats
    (``restore_sweep``'s, None without ``--resume``), the fleet store's
    ``stats()`` and the fault injection's (None when off)."""
    store: Any
    out: str
    algo: Any
    clients: List[Any]
    timings: dict
    resume: Optional[dict] = None
    fleet_stats: Optional[dict] = None
    chaos_stats: Optional[dict] = None


def run(argv=None) -> Explored:
    """One sweep from the command line ``argv``; ``main`` prints its
    summary.  ``timings``: ``wall_s``; ``build_s`` and ``builds`` (summed
    over the clients' threads); ``ask_s``/``asks`` and ``tell_s``/``tells``
    (the searcher, on the host loop); ``poll_s``/``polls``, the host loop's
    calls of an async driver's ``poll_ask`` (``--async-search``: the
    driver's worker thread asks beside the loop, untimed); ``dispatch_s``,
    the host
    loop's wall time outside the searcher (scheduling, transport, waiting
    for results)."""
    args = parse_args(argv)
    from repro_torch.configs import SHAPES, get_arch, reduced
    from repro_torch.core import (ALGORITHMS, ChaosTransport,
                                  FleetArtifactStore, JConfig, JHost,
                                  ResultStore, SearchDriver, tpu_pod_space)

    arch = get_arch(args.workload)
    if args.reduced:
        arch = reduced(arch)
    if args.shape == "generate":
        space = generation_space(arch, args.chips)
    else:
        space = tpu_pod_space(arch, SHAPES[args.shape], n_chips=args.chips)
    jc = JConfig(space, n_chips=args.chips)
    print(f"[explore] space size = {space.size()} "
          f"({len(space.knobs)} knobs); workload={args.workload}/{args.shape}")

    algo_kw = {}
    if args.algorithm in ("bayesopt", "pal"):
        algo_kw = {"gp_mode": args.gp, "hyper_refresh_every": args.gp_refresh,
                   "inducing_threshold": args.gp_inducing,
                   "device": args.device}
    # the searcher first: a device tier without a card raises before any
    # client thread starts
    algo = ALGORITHMS[args.algorithm](space, seed=args.seed, **algo_kw)
    build_fn = _Timed(make_build_fn(args, jc))
    pair, clients, threads = start_fleet(args, jc, build_fn)

    # pre-seed the CSV schema so a leading timeout/failure can't narrow it
    store = ResultStore(csv_path=args.out,
                        knob_names=[k.name for k in space],
                        metric_names=("time_s", "power_w"))
    host_transport = pair.host()
    chaos = None
    if (args.chaos_crash_at is not None or args.chaos_drop
            or args.chaos_dup):
        chaos = ChaosTransport(host_transport, seed=args.chaos_seed,
                               drop_p=args.chaos_drop, dup_p=args.chaos_dup,
                               crash_at_results=args.chaos_crash_at)
        host_transport = chaos
    host = JHost(host_transport, store, timeout_s=args.timeout, poll_s=0.05)
    mode = fleet_mode(args)
    fleet_store = None if mode is None else FleetArtifactStore(mode=mode)
    search = algo
    if args.async_search:
        search = SearchDriver(algo, mode="async",
                              max_stale_tells=args.max_stale_tells)
    timed = _TimedSearch(search)
    t0 = time.perf_counter()
    try:
        host.explore(timed, args.workload, args.shape, args.samples,
                     objectives=("time_s", "power_w"), progress=True,
                     batch_size=args.batch_size, dispatch=args.dispatch,
                     chunk_budget_ms=args.chunk_budget_ms,
                     affinity=args.affinity,
                     fingerprint_fn=(jc.cache_key if args.affinity != "off"
                                     or args.speculate_at is not None
                                     or args.speculate_slow_mult is not None
                                     or fleet_store is not None
                                     else None),
                     speculate_frac=args.speculate_at,
                     speculate_slow_mult=args.speculate_slow_mult,
                     pipeline_depth=args.pipeline_depth,
                     fleet_store=fleet_store,
                     checkpoint_dir=args.checkpoint_dir,
                     checkpoint_every=args.checkpoint_every,
                     resume=args.resume)
    finally:
        if search is not algo:
            print(f"[explore] search driver: {search.stats()}")
            search.close()
        if chaos is not None:
            print(f"[explore] chaos: {chaos.stats()}")
        host.stop_clients()
        for t in threads:
            t.join(timeout=5.0)
        store.close()
    wall = time.perf_counter() - t0
    poll = getattr(timed, "poll_ask", None)
    poll_s, polls = (0.0, 0) if poll is None else (poll.seconds, poll.calls)
    timings = {"wall_s": wall, "build_s": build_fn.seconds,
               "builds": build_fn.calls, "ask_s": timed.ask.seconds,
               "asks": timed.ask.calls, "tell_s": timed.tell.seconds,
               "tells": timed.tell.calls, "poll_s": poll_s, "polls": polls,
               "dispatch_s": wall - timed.ask.seconds - timed.tell.seconds - poll_s}
    return Explored(store, args.out, algo, clients, timings, host.resume_info,
                    None if fleet_store is None else fleet_store.stats(),
                    None if chaos is None else chaos.stats())


def main(argv=None):
    """Run one sweep, print its summary, and return its ``ResultStore``."""
    from repro_torch.core import hypervolume
    from repro_torch.launch.report import cache_effectiveness

    res = run(argv)
    store, t = res.store, res.timings
    ok = store.ok_records()
    pts = store.objective_matrix(["time_s", "power_w"])
    front = store.pareto_front(["time_s", "power_w"])
    ref = pts.max(0) * 1.1
    compiles = sum(c.n_compiled for c in res.clients)
    dt = t["wall_s"]
    print(f"[explore] {len(ok)} configs in {dt:.1f}s "
          f"({len(ok) / max(dt, 1e-9):.1f} evals/s; {compiles} compiles, "
          f"{len(ok)-compiles} cache hits)")
    print(f"[explore] build {t['build_s']:.2f}s over {t['builds']} builds, "
          f"search {t['ask_s'] + t['tell_s'] + t['poll_s']:.2f}s over "
          f"{t['asks'] + t['polls']} asks, "
          f"dispatch {t['dispatch_s']:.2f}s")
    if any(c.cache_dir is not None for c in res.clients) or res.fleet_stats:
        line, _ = cache_effectiveness([c.cache_info() for c in res.clients],
                                      res.fleet_stats)
        print(f"[explore] {line}")
    print(f"[explore] pareto front size = {len(front)}, "
          f"hypervolume = {hypervolume(pts, ref):.4g}")
    print(f"[explore] time range  [{pts[:,0].min():.3f}, {pts[:,0].max():.3f}] s")
    print(f"[explore] power range [{pts[:,1].min():.1f}, {pts[:,1].max():.1f}] W")
    print(f"[explore] results -> {res.out}")
    return store


if __name__ == "__main__":
    main()
