"""The port's DSE loop parts against the JAX package's, on the same inputs.

Made with numpy from a seed and fed to both packages:
* ``core/results.py``: the same records give byte-identical CSV text and
  equal ``objective_matrix`` and ``pareto_front``;
* ``core/codec.py`` + ``core/transport.py`` framing: the same frames
  encode to identical bytes, json and binary, and each package decodes the
  other's;
* ``core/scheduler.py``: the same scripted submits, results, duplicates,
  clock steps, timeouts and client losses give the same dispatch decisions,
  expiries and ``stats()`` at every step (``tests/test_scheduler.py``'s
  fake clock);
* the searchers (random, grid, nsga2, BayesOpt parego/ehvi, PAL; the GP
  ``incremental`` in both, the port also ``torch`` on the CPU) and the sync
  ``SearchDriver``: identical picks for the same seed and tells, and a
  ``state_dict`` round trip (the port's own, and the reference's state
  loaded into the port) that continues with identical picks.
"""
import pickle

import numpy as np
import pytest

from repro.core import codec as ref_codec
from repro.core import results as ref_results
from repro.core import scheduler as ref_scheduler
from repro.core import transport as ref_transport
from repro.core.jconfig import TestConfig as RefTestConfig
from repro.core.search import ALGORITHMS as REF_ALGORITHMS
from repro.core.search import SearchDriver as RefDriver
from repro.core.space import tpu_pod_space as ref_pod_space
from repro_torch.core import codec, results, scheduler, transport
from repro_torch.core.jconfig import TestConfig
from repro_torch.core.search import ALGORITHMS, SearchDriver
from repro_torch.core.space import tpu_pod_space

PORT = {"codec": codec, "results": results, "scheduler": scheduler,
        "transport": transport, "TestConfig": TestConfig}
REF = {"codec": ref_codec, "results": ref_results, "scheduler": ref_scheduler,
       "transport": ref_transport, "TestConfig": RefTestConfig}


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------


def _records(mod, seed, n=40):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        status = "ok" if rng.random() < 0.85 else str(rng.choice(["timeout", "failed"]))
        knobs = {"clock_scale": float(rng.choice([0.5, 0.75, 1.0])),
                 "dtype": "bfloat16", "attn_block_q": int(rng.choice([128, 256]))}
        if rng.random() < 0.2:
            knobs["late_knob"] = bool(rng.integers(2))
        metrics = {}
        if status == "ok":
            metrics = {"time_s": float(rng.random() * 10.0 ** int(rng.integers(-4, 2))),
                       "power_w": float(75 + 100 * rng.random()),
                       "bottleneck": str(rng.choice(["compute_s", "memory_s"]))}
            if rng.random() < 0.3:
                metrics["mem_bytes"] = float(rng.integers(1, 2 ** 40))
        recs.append(mod.ResultRecord(config_id=int(i), arch="llama2-7b", shape="generate",
                                     knobs=knobs, metrics=metrics, status=status,
                                     client_id=int(rng.integers(2)),
                                     cached=bool(rng.integers(2)),
                                     wall_s=float(rng.random())))
    return recs


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("preseed", [False, True])
def test_result_store_csv_and_front(seed, preseed, tmp_path):
    out = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        kw = ({"knob_names": ["clock_scale"], "metric_names": ("time_s", "power_w")}
              if preseed else {})
        store = pkg["results"].ResultStore(csv_path=str(tmp_path / f"{name}.csv"), **kw)
        for r in _records(pkg["results"], seed):
            store.add(r)
        store.close()
        store.to_csv(str(tmp_path / f"{name}_full.csv"))
        out[name] = store
    for suffix in (".csv", "_full.csv"):
        assert ((tmp_path / f"port{suffix}").read_bytes()
                == (tmp_path / f"ref{suffix}").read_bytes())
    keys = ["time_s", "power_w"]
    np.testing.assert_array_equal(out["port"].objective_matrix(keys),
                                  out["ref"].objective_matrix(keys))
    assert ([r.to_wire() for r in out["port"].pareto_front(keys)]
            == [r.to_wire() for r in out["ref"].pareto_front(keys)])
    assert ([r.to_wire() for r in out["port"].ok_records()]
            == [r.to_wire() for r in out["ref"].ok_records()])
    rt = results.ResultRecord.from_wire(ref_results.ResultRecord(
        1, "a", "s", {"x": 1}, {"time_s": 2.0}).to_wire())
    assert rt.to_wire() == ref_results.ResultRecord(1, "a", "s", {"x": 1},
                                                    {"time_s": 2.0}).to_wire()


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------


def _frames(seed):
    """Row and columnar frames of result-like messages, and a config chunk."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 12))
    uniform = rng.random() < 0.6
    msgs = []
    for i in range(n):
        m = {"config_id": int(i), "status": "ok", "client_id": int(rng.integers(3)),
             "cached": bool(rng.integers(2)), "wall_s": float(rng.random()),
             "metrics": {"time_s": float(rng.standard_normal() * 1e-3),
                         "power_w": float(rng.random() * 400),
                         "bottleneck": str(rng.choice(["compute_s", "memory_s"]))}}
        if not uniform and rng.random() < 0.5:
            m["extra"] = int(rng.integers(-10 ** 12, 10 ** 12))
        msgs.append(m)
    configs = [{"config_id": int(i), "arch": "llama2-7b", "shape": "generate",
                "knobs": {"clock_scale": float(rng.choice([0.5, 1.0])),
                          "attn_block_q": int(rng.choice([128, 512])), "dtype": "bfloat16"}}
               for i in range(n)]
    return msgs, configs


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("codec_name", ["json", "binary"])
def test_codec_same_bytes_both_ways(seed, codec_name):
    msgs, configs = _frames(seed)
    ours_c = codec.resolve_codec(codec_name)
    ref_c = ref_codec.resolve_codec(codec_name)
    for batch in (msgs, configs):
        frame = transport.frame_batch(batch)
        ref_frame = ref_transport.frame_batch(batch)
        assert frame == ref_frame
        for m in [frame] + batch:
            ours_b, ref_b = ours_c.encode(m), ref_c.encode(m)
            assert ours_b == ref_b
            assert codec.decode_wire(ref_b) == ref_codec.decode_wire(ours_b) == m
            # a row message that packs nothing goes out as json in both
            assert codec.sniff_codec(ref_b) == ref_codec.sniff_codec(ours_b)
        assert transport.unframe_batch(ref_codec.decode_wire(ours_c.encode(frame))) == batch
        assert ref_transport.unframe_batch(codec.decode_wire(ref_c.encode(frame))) == batch


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _scripted(pkg, seed, tenants=None, cancel_at=None, fleet=False, **kw):
    """Drive a DispatchScheduler through a seeded script; return the trace
    of everything it answered.  The script's choices depend only on the
    seed and on earlier answers, so equal packages give equal traces.

    ``tenants`` (name -> ``add_tenant`` keywords) registers tenants and
    submits each one's fresh configs up to ``want_for`` it; ``cancel_at``
    (step, name) cancels a tenant mid-script; ``fleet`` installs a
    ``fleet_resident_fn`` that calls one fingerprint in three resident."""
    rng = np.random.default_rng(seed)
    clk = FakeClock()
    fp = None
    if kw.get("affinity", "off") != "off" or kw.get("speculate_slow_mult"):
        fp = lambda tc: (tc.arch, tc.shape, (("k", tc.knobs["x"] % 3),))  # noqa: E731
    if fleet:
        kw["fleet_resident_fn"] = lambda f: f[2][0][1] == 1  # noqa: E731
    sched = pkg["scheduler"].DispatchScheduler(
        [0, 1, 2], timeout_s=10.0, max_retries=1, fingerprint_fn=fp, clock=clk, **kw)
    for name, opts in (tenants or {}).items():
        sched.add_tenant(name, **opts)
    trace, queues, answered = [], {0: [], 1: [], 2: []}, []
    next_id = 0
    for step in range(70):
        want = sched.want(lookahead=int(step % 2))
        trace.append(("want", want, sched.busy()))
        if tenants:
            for name in tenants:
                share = sched.want_for(name, lookahead=int(step % 2))
                trace.append(("want_for", name, share))
                for _ in range(min(share, int(rng.integers(0, 4)))):
                    sched.submit(pkg["TestConfig"](next_id, "a", "s", {"x": next_id}),
                                 tenant=name)
                    next_id += 1
        else:
            for _ in range(min(want, int(rng.integers(0, 7)))):
                sched.submit(pkg["TestConfig"](next_id, "a", "s", {"x": next_id}))
                next_id += 1
        if cancel_at is not None and step == cancel_at[0]:
            trace.append(("cancel", sched.cancel_tenant(cancel_at[1])))
        disp = [(c, [t.config_id for t in tcs]) for c, tcs in sched.next_dispatches()]
        trace.append(("dispatch", disp, [sched.tenant_of(ids[0]) for _, ids in disp]))
        for c, ids in disp:
            queues.setdefault(c, []).append(ids)
        clk.t += float(rng.uniform(0.0, 3.0))
        live = sorted(c for c, q in queues.items() if q)
        ev = rng.random()
        if live and ev < 0.7:
            c = int(rng.choice(live))
            ids = queues[c].pop(0)
            sched.note_results()
            for cid in ids:
                msg = {"config_id": cid, "status": "ok", "client_id": c,
                       "metrics": {"time_s": 1.0}, "cached": bool(rng.integers(2)),
                       "wall_s": float(rng.uniform(0.01, 2.0))}
                if rng.random() < 0.3:
                    msg["cache_info"] = {"currsize": int(rng.integers(0, 4)), "maxsize": 64}
                tc = sched.on_result(msg)
                trace.append(("result", cid, None if tc is None else tc.config_id))
                answered.append((cid, c))
        elif answered and ev < 0.78:               # a duplicate answer
            cid, c = answered[int(rng.integers(len(answered)))]
            tc = sched.on_result({"config_id": cid, "status": "ok", "client_id": c,
                                  "metrics": {"time_s": 1.0}, "cached": False,
                                  "wall_s": 0.1})
            trace.append(("dup", cid, None if tc is None else tc.config_id))
        elif ev < 0.83:                            # a client leaves, then returns
            c = int(rng.integers(3))
            if c in sched.slots:
                drain = bool(rng.integers(2))
                sched.remove_client(c, drain=drain)
                if not drain:
                    queues[c] = []
            else:
                sched.add_client(c)
            trace.append(("membership", c))
        elif ev < 0.9:                             # a long stall: deadlines pass
            clk.t += 12.0
        trace.append(("expire", [(t.config_id, c) for t, c in sched.expire()]))
        trace.append(("stats", sched.stats(), sched.stuck(),
                      sorted(map(repr, sched.resident_fingerprints()))))
    return trace


SCHED_CASES = {
    "scalar-eager": dict(policy="eager"),
    "batch3-eager": dict(policy="eager", batch_size=3),
    "batch2-pipelined": dict(policy="pipelined", batch_size=2),
    "pipelined-depth3": dict(policy="pipelined", batch_size=2, pipeline_depth=3),
    "budget": dict(policy="pipelined", chunk_budget_s=1.5),
    "affinity-prefer": dict(policy="eager", batch_size=2, affinity="prefer"),
    "affinity-strict": dict(policy="pipelined", batch_size=2, affinity="strict"),
    "speculate": dict(policy="eager", batch_size=2, speculate_frac=0.5),
    "speculate-slow": dict(policy="pipelined", batch_size=2, speculate_slow_mult=2.0),
    # multi-tenant fair share: unequal weights, a priority class, an
    # in-flight cap, a cancel mid-run; and the fleet store's consult
    "tenants-weights": dict(policy="eager", batch_size=2,
                            tenants={"a": {"weight": 1.0}, "b": {"weight": 3.0}}),
    "tenants-priority": dict(policy="pipelined", batch_size=2,
                             tenants={"lo": {}, "hi": {"priority": 2}}),
    "tenants-cap": dict(policy="eager", batch_size=3,
                        tenants={"capped": {"max_inflight": 2}, "free": {"weight": 0.5}}),
    "tenants-cancel": dict(policy="pipelined", batch_size=2, affinity="prefer",
                           tenants={"a": {}, "b": {"weight": 2.0}, "c": {}},
                           cancel_at=(30, "b")),
    "fleet-resident": dict(policy="pipelined", batch_size=3, affinity="strict", fleet=True),
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", sorted(SCHED_CASES))
def test_scheduler_same_decisions(case, seed):
    ours = _scripted(PORT, seed, **SCHED_CASES[case])
    ref = _scripted(REF, seed, **SCHED_CASES[case])
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a == b


def _tenant_entry(pkg, entry):
    """One slice-6 entry point driven in package ``pkg``: ``add_tenant``
    then dispatches; a ``submit`` to a tenant; a ``JClient`` in fleet mode
    that asks the store, is told to build, builds and announces the blob."""
    if entry == "jclient_fleet_mode":
        return _fleet_client_trace(pkg)
    sched = pkg["scheduler"].DispatchScheduler([0, 1], batch_size=2)
    if entry == "add_tenant":
        sched.add_tenant("b", weight=2.0, priority=1, max_inflight=3)
    for i in range(8):
        tenant = "b" if i % 2 else "default"
        sched.submit(pkg["TestConfig"](i, "a", "s", {"x": i}), tenant=tenant)
    disp = [(c, [t.config_id for t in tcs]) for c, tcs in sched.next_dispatches()]
    return (disp, [sched.tenant_of(i) for i in range(8)], sched.want_for("b"),
            sched.stats(), len(sched.pending))


def _fleet_client_trace(pkg):
    from importlib import import_module

    core = import_module(pkg["scheduler"].__name__.rsplit(".", 1)[0])
    space = core.tpu_pod_space(n_chips=256)
    jc = core.JConfig(space, n_chips=256)
    pair = pkg["transport"].LoopbackPair(1)
    built = []
    client = core.JClient(jc, lambda tc: built.append(tc.config_id) or (None, {}),
                          transport=pair.client(0), client_id=0, fleet_mode="serve",
                          fleet_timeout_s=2.0)
    tc = pkg["TestConfig"](0, "a", "s", space.sample(np.random.default_rng(0)))
    key = jc.cache_key(tc)
    pair.host().push(0, {"cmd": pkg["transport"].ARTIFACT_MISS, "addr": client._addr(key)})
    client._artifact(key, tc)
    frames = []
    while not pair.to_host.empty():
        msg = pkg["transport"].decode_wire(pair.to_host.get())
        frames.append({k: (len(v) > 0 if k == "blob" else v) for k, v in msg.items()})
    return frames, built, client.cache_info()


@pytest.mark.parametrize("entry", ["add_tenant", "submit_to_a_tenant", "jclient_fleet_mode"])
def test_slice_6_entry_points_match_the_reference(entry):
    """Multi-tenant fair share and the fleet artifact tier run as the
    reference's do."""
    ours, ref = _tenant_entry(PORT, entry), _tenant_entry(REF, entry)
    assert ours == ref
    if entry == "jclient_fleet_mode":
        frames, built, info = ours
        assert [f["cmd"] for f in frames] == ["artifact_query", "artifact_put"]
        assert built == [0] and info["fleet_misses"] == 1
    else:
        assert "b" in ours[1] and ours[0]


def test_client_hello_and_goodbye_reach_the_scheduler(tmp_path):
    """A client joining mid-run announces the fingerprints it holds (after a
    restart, those of its disk tier); JHost's membership handler gives it a
    slot whose shadow holds them, and a hard goodbye retires it."""
    from repro_torch.core import JClient, JConfig
    from repro_torch.core.jhost import handle_membership

    space = tpu_pod_space(n_chips=256)
    jc = JConfig(space, n_chips=256)
    pair = transport.LoopbackPair(1)
    pair.add_client(1)
    host = pair.host()
    sched = scheduler.DispatchScheduler([0], fingerprint_fn=jc.cache_key)
    tc = TestConfig(0, "a", "s", space.sample(np.random.default_rng(0)))
    sched.submit(tc)
    joiner = JClient(jc, lambda tc: (None, {}), transport=pair.client(1), client_id=1,
                     cache_dir=str(tmp_path))
    joiner.evaluate(tc)
    joiner.hello()
    (msg,) = host.pull_many(1.0)
    assert msg["resident_fps"] == [repr(jc.cache_key(tc))]
    handle_membership(msg, sched, host)
    assert sorted(sched.slots) == [0, 1] and jc.cache_key(tc) in sched.slots[1].shadow
    restarted = JClient(jc, lambda tc: (None, {}), transport=pair.client(1), client_id=1,
                        cache_dir=str(tmp_path))
    restarted.hello()
    assert host.pull_many(1.0)[0]["resident_fps"] == msg["resident_fps"]
    restarted.goodbye(drain=False)
    handle_membership(host.pull_many(1.0)[0], sched, host)
    assert sorted(sched.slots) == [0] and sched.stats()["clients_left"] == 1


@pytest.mark.parametrize("seed", range(3))
def test_cache_effectiveness_matches_the_reference(seed):
    from repro.launch.report import cache_effectiveness as ref_cache_effectiveness
    from repro_torch.launch.report import cache_effectiveness

    rng = np.random.default_rng(seed)
    infos = []
    for _ in range(int(rng.integers(1, 4))):
        ci = {k: int(rng.integers(0, 50)) for k in ("hits", "misses", "evictions", "currsize")}
        ci["maxsize"] = 64
        if seed:
            ci.update({k: int(rng.integers(0, 20))
                       for k in ("disk_hits", "disk_misses", "disk_stores")})
        infos.append(ci)
    assert cache_effectiveness(infos) == ref_cache_effectiveness(infos)


# ---------------------------------------------------------------------------
# searchers
# ---------------------------------------------------------------------------


def _objectives(space, knobs):
    x = space.encode(knobs)
    return np.array([2.0 - 1.2 * x[0] + 0.4 * x[1] + 0.1 * np.sin(7 * x.sum()),
                     0.5 + 1.5 * x[0] ** 2 + 0.2 * x[2]])


SEARCH_CASES = {
    "random": ("random", {}),
    "grid": ("grid", {}),
    "nsga2": ("nsga2", {"pop_size": 8}),
    "bayesopt-parego": ("bayesopt", {"n_init": 6, "pool_size": 64}),
    "bayesopt-ehvi": ("bayesopt", {"n_init": 6, "pool_size": 64, "strategy": "ehvi"}),
    "pal": ("pal", {"n_init": 6, "pool_size": 64}),
}


def _run(algo, space, rng, rounds):
    picks = []
    for _ in range(rounds):
        cfgs = algo.ask(int(rng.integers(1, 4)))
        picks.extend(cfgs)
        for c in cfgs:
            algo.tell(c, _objectives(space, c))
    return picks


@pytest.mark.parametrize("case,tier", [
    (case, tier) for case in sorted(SEARCH_CASES) for tier in ("incremental", "torch")
    if tier == "incremental" or SEARCH_CASES[case][0] in ("bayesopt", "pal")])
@pytest.mark.parametrize("driver", [False, True])
def test_searcher_picks_and_state_round_trip(case, tier, driver):
    name, kw = SEARCH_CASES[case]
    gp_kw = {"gp_mode": "incremental"} if name in ("bayesopt", "pal") else {}
    port_kw = ({"gp_mode": tier, "device": "cpu"} if tier == "torch"
               else gp_kw)
    space, ref_space = tpu_pod_space(n_chips=256), ref_pod_space(n_chips=256)
    ours = ALGORITHMS[name](space, seed=5, **kw, **port_kw)
    ref = REF_ALGORITHMS[name](ref_space, seed=5, **kw, **gp_kw)
    if driver:
        ours, ref = SearchDriver(ours, mode="sync"), RefDriver(ref, mode="sync")
    a = _run(ours, space, np.random.default_rng(1), 12)
    b = _run(ref, ref_space, np.random.default_rng(1), 12)
    assert a == b
    # the port's own state, and the reference's, each pickled as a
    # checkpoint does and restored into a fresh port searcher, continue
    # exactly as the reference does
    ref_state = pickle.dumps(ref.state_dict())
    for state in (pickle.dumps(ours.state_dict()), ref_state):
        fresh = ALGORITHMS[name](space, seed=99, **kw, **port_kw)
        if driver:
            fresh = SearchDriver(fresh, mode="sync")
        fresh.load_state(pickle.loads(state))
        rng_a, rng_b = np.random.default_rng(2), np.random.default_rng(2)
        ref2 = REF_ALGORITHMS[name](ref_space, seed=99, **kw, **gp_kw)
        if driver:
            ref2 = RefDriver(ref2, mode="sync")
        ref2.load_state(pickle.loads(ref_state))
        assert _run(fresh, space, rng_a, 6) == _run(ref2, ref_space, rng_b, 6)


def test_async_driver_gives_valid_unseen_picks():
    space = tpu_pod_space(n_chips=256)
    drv = SearchDriver(ALGORITHMS["bayesopt"](space, seed=0, n_init=4, pool_size=32),
                       mode="async", max_stale_tells=2)
    try:
        seen = set()
        for _ in range(10):
            for c in drv.poll_ask(2, need=True):
                key = tuple(sorted(c.items()))
                assert key not in seen and set(c) == set(space.names())
                seen.add(key)
                drv.tell(c, _objectives(space, c))
        assert drv.stats()["tells_folded"] > 0
    finally:
        drv.close()
