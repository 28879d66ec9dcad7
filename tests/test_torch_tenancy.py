"""Multi-tenant fair share and the explore service on the port against the
JAX package's.

``repro_torch.core.scheduler``'s tenant layer and ``core.tenancy``'s
``ExploreService`` held against ``repro.core``'s on the same seeded inputs,
with ``tests/test_tenancy.py``'s fake clock and stub builds: the DWRR
scenarios give the reference's pick order and books, the service gives
each tenant the rows a solo sweep gives and the reference's service gives,
checkpoints written under the service resume solo in either package, the
control verbs answer as the reference's, and ``launch.serve_explore`` writes
the reference's per-tenant CSVs.
"""
import csv
import os
import sys
import threading

import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as port_core
from repro.roofline.analysis import Artifact as RefArtifact
from repro_torch.roofline.analysis import Artifact as PortArtifact

PKGS = {"port": (port_core, PortArtifact), "ref": (ref_core, RefArtifact)}


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _ok(cid, client):
    return {"config_id": cid, "status": "ok", "client_id": client,
            "metrics": {"time_s": 1.0}, "cached": False, "wall_s": 0.0}


# ---------------------------------------------------------------------------
# DWRR scenarios: the reference's picks and books, step by step
# ---------------------------------------------------------------------------


def _deficit_costs(core, clk):
    s = core.DispatchScheduler([0], batch_size=1, clock=clk)
    s.add_tenant("slow")
    s.add_tenant("fast")
    cost = {"slow": 3.0, "fast": 1.0}
    for i in range(8):
        s.submit(core.TestConfig(i, "a", "s", {"x": i}), tenant="slow")
    for i in range(100, 108):
        s.submit(core.TestConfig(i, "a", "s", {"x": i}), tenant="fast")
    picks = []
    for _ in range(12):
        ((client, cfgs),) = s.next_dispatches()
        tenant = s.tenant_of(cfgs[0].config_id)
        picks.append(tenant)
        clk.advance(cost[tenant] * len(cfgs))
        for c in cfgs:
            s.on_result(_ok(c.config_id, client))
    assert picks[4:].count("fast") == 6 and picks[4:].count("slow") == 2
    return picks, s


def _weighted(core, clk):
    s = core.DispatchScheduler([0], batch_size=1, clock=clk)
    s.add_tenant("big", weight=3.0)
    s.add_tenant("small", weight=1.0)
    for i in range(12):
        s.submit(core.TestConfig(i, "a", "s", {"x": i}), tenant="big")
    for i in range(100, 112):
        s.submit(core.TestConfig(i, "a", "s", {"x": i}), tenant="small")
    picks = []
    for _ in range(8):
        ((client, cfgs),) = s.next_dispatches()
        picks.append(s.tenant_of(cfgs[0].config_id))
        clk.advance(1.0)
        for c in cfgs:
            s.on_result(_ok(c.config_id, client))
    assert picks.count("big") == 6
    return picks, s


def _priority(core, clk):
    s = core.DispatchScheduler([0], batch_size=2, clock=clk)
    s.add_tenant("lo")
    for i in range(6):
        s.submit(core.TestConfig(i, "a", "s", {"x": i}), tenant="lo")
    picks = []
    d = s.next_dispatches()
    s.add_tenant("hi", priority=5)
    for i in range(100, 102):
        s.submit(core.TestConfig(i, "a", "s", {"x": i}), tenant="hi")
    assert s.next_dispatches() == []          # in-flight work is never revoked
    for _ in range(3):
        for c in d[0][1]:
            s.on_result(_ok(c.config_id, 0))
        d = s.next_dispatches()
        picks.append(s.tenant_of(d[0][1][0].config_id))
    assert picks == ["hi", "lo", "lo"]
    return picks, s


def _capped(core, clk):
    s = core.DispatchScheduler([0, 1], batch_size=4, clock=clk)
    s.add_tenant("capped", max_inflight=3)
    for i in range(8):
        s.submit(core.TestConfig(i, "a", "s", {"x": i}), tenant="capped")
    d = s.next_dispatches()
    assert sum(len(cfgs) for _, cfgs in d) == 3
    for c in d[0][1]:
        s.on_result(_ok(c.config_id, d[0][0]))
    return [(c, [t.config_id for t in cfgs]) for c, cfgs in d + s.next_dispatches()], s


def _storm(core, clk):
    """A capped tenant whose configs hang quarantines only the client its
    cap lets it hold; the other tenant finishes on the other client."""
    s = core.DispatchScheduler([0, 1], batch_size=2, timeout_s=10.0, max_retries=1, clock=clk)
    s.add_tenant("storm", max_inflight=2)
    s.add_tenant("good")
    for i in range(8):
        s.submit(core.TestConfig(i, "a", "s", {"x": i}), tenant="storm")
    for i in range(100, 104):
        s.submit(core.TestConfig(i, "a", "s", {"x": i}), tenant="good")
    trace = []
    for _ in range(4):
        for client, cfgs in s.next_dispatches():
            trace.append((client, [c.config_id for c in cfgs]))
            if s.tenant_of(cfgs[0].config_id) == "good":
                for c in cfgs:
                    s.on_result(_ok(c.config_id, client))
    clk.advance(25.0)
    trace.append([(t.config_id, c) for t, c in s.expire()])
    assert len(s.quarantined) == 1 and not s.tenants["good"].queue
    return trace, s


def _clamp(core, clk):
    s = core.DispatchScheduler([0], batch_size=1, clock=clk)
    s.add_tenant("a")
    s.add_tenant("b")
    for i in range(4):
        s.submit(core.TestConfig(i, "a", "s", {"x": i}), tenant="a")
    for _ in range(4):
        ((client, cfgs),) = s.next_dispatches()
        clk.advance(1.0)
        s.on_result(_ok(cfgs[0].config_id, client))
    for i in range(100, 103):
        s.submit(core.TestConfig(i, "a", "s", {"x": i}), tenant="a")
    for i in range(200, 203):
        s.submit(core.TestConfig(i, "a", "s", {"x": i}), tenant="b")
    picks = []
    for _ in range(4):
        ((client, cfgs),) = s.next_dispatches()
        picks.append(s.tenant_of(cfgs[0].config_id))
        clk.advance(1.0)
        s.on_result(_ok(cfgs[0].config_id, client))
    assert picks == ["a", "b", "a", "b"]
    return picks, s


def _cancel(core, clk):
    s = core.DispatchScheduler([0], batch_size=2, clock=clk)
    s.add_tenant("t")
    for i in range(6):
        s.submit(core.TestConfig(i, "a", "s", {"x": i}), tenant="t")
    d = s.next_dispatches()
    out = s.cancel_tenant("t")
    late = [s.on_result(_ok(c.config_id, 0)) for c in d[0][1]]
    assert out == (4, 2) and late == [None, None] and not s.busy()
    return out, s


SCENARIOS = {"deficit-unequal-costs": _deficit_costs, "weighted-share": _weighted,
             "priority": _priority, "inflight-cap": _capped, "quarantine-storm": _storm,
             "reactivation-clamp": _clamp, "cancel": _cancel}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fair_share_matches_the_reference(scenario):
    out = {}
    for name, (core, _) in PKGS.items():
        trace, sched = SCENARIOS[scenario](core, FakeClock())
        out[name] = (trace, sched.stats(), {n: (t.deficit, t.cost_ewma, t.inflight, len(t.queue))
                                            for n, t in sched.tenants.items()})
    assert out["port"] == out["ref"]


def test_single_tenant_keeps_the_old_format():
    s = port_core.DispatchScheduler([0], batch_size=2, clock=FakeClock())
    for i in range(4):
        s.submit(port_core.TestConfig(i, "a", "s", {"x": i}))
    assert len(s.pending) == 4
    assert [(c, len(cfgs)) for c, cfgs in s.next_dispatches()] == [(0, 2)]
    assert all(ch.tenant == "default" for ch in s.chunks.values())
    assert "tenants" not in s.stats()


# ---------------------------------------------------------------------------
# ExploreService over a loopback fleet
# ---------------------------------------------------------------------------


def _small_space(core):
    return core.DesignSpace([core.Knob("clock_scale", (0.5, 1.0), core.KIND_HW),
                             core.Knob("blk", (0, 1, 2, 3), core.KIND_SW)])


def _toy(artifact_cls, f):
    return artifact_cls(flops_per_device=f, bytes_per_device=2e10, wire_bytes_per_device=1e8,
                        collectives={}, arg_bytes=10 ** 9, temp_bytes=10 ** 8,
                        output_bytes=10 ** 6, n_devices=8)


class Replay:
    """Deterministic ask/tell: hands out a fixed knob list in order."""

    def __init__(self, ks):
        self._k = list(ks)

    def ask(self, n):
        out, self._k = self._k[:n], self._k[n:]
        return out

    def tell(self, knobs, y):
        pass


def _knobs(seed, n):
    return _small_space(port_core).sample_batch(np.random.default_rng(seed), n)


def _result_key(store):
    return sorted((r.config_id,) + tuple(float(r.metrics[k]).hex() for k in ("time_s", "power_w"))
                  for r in store.records if r.status == "ok")


class Fleet:
    """n loopback JClients of package ``pkg`` serving stub builds."""

    def __init__(self, pkg, n):
        core, artifact_cls = PKGS[pkg]
        self.pair = core.transport.LoopbackPair(n)
        jc = core.JConfig(_small_space(core), n_chips=8)

        def build(tc):
            h = hash(jc.cache_key(tc)) % 7 + 1
            return _toy(artifact_cls, 5e12 * h), {"decode_artifact": _toy(artifact_cls, 1e11 * h),
                                                  "n_decode_tokens": 10}

        self.threads = []
        for i in range(n):
            c = core.JClient(jc, build, transport=self.pair.client(i), client_id=i)
            t = threading.Thread(target=c.serve, kwargs=dict(poll_s=0.005), daemon=True)
            t.start()
            self.threads.append(t)

    def stop(self):
        for i in range(len(self.threads)):
            self.pair.host().push(i, {"cmd": "stop"})
        for t in self.threads:
            t.join(timeout=10.0)


def _service(pkg, sweeps, **kw):
    fleet = Fleet(pkg, 2)
    core = PKGS[pkg][0]
    svc = core.ExploreService(fleet.pair.host(), timeout_s=60.0, poll_s=0.005, batch_size=3,
                              dispatch="pipelined", **kw)
    out = {name: svc.submit_sweep(name, Replay(ks), "tpu_v4", "8", len(ks), **skw)
           for name, ks, skw in sweeps}
    svc.run()
    fleet.stop()
    return svc, out


SWEEPS = [("a", _knobs(0, 12), {}), ("b", _knobs(1000, 9), {"weight": 2.0}),
          ("c", _knobs(7, 7), {"priority": 1, "max_inflight": 2})]


def test_service_results_match_solo_runs_and_the_reference():
    """Three interleaved sweeps on one fleet: each tenant's rows are a solo
    JHost run's, in tenant-local ids, and the reference service's."""
    solo = {}
    for name, ks, _ in SWEEPS:
        fleet = Fleet("port", 2)
        host = port_core.JHost(fleet.pair.host(), port_core.ResultStore(), timeout_s=60.0,
                               poll_s=0.005)
        solo[name] = _result_key(host.explore(Replay(ks), "tpu_v4", "8", len(ks),
                                              batch_size=3, dispatch="pipelined"))
        fleet.stop()
    _, ours = _service("port", SWEEPS)
    _, ref = _service("ref", SWEEPS)
    for name, ks, _ in SWEEPS:
        assert ours[name].state == "done"
        assert {r.config_id for r in ours[name].store.records} == set(range(len(ks)))
        assert _result_key(ours[name].store) == solo[name] == _result_key(ref[name].store)


def test_subscribe_streams_and_cancel_ends():
    knobs = _knobs(7, 20)
    fleet = Fleet("port", 1)
    svc = port_core.ExploreService(fleet.pair.host(), timeout_s=60.0, poll_s=0.005,
                                   batch_size=2)
    svc.submit_sweep("t", Replay(knobs), "tpu_v4", "8", len(knobs))
    seen = []
    sub = threading.Thread(target=lambda: seen.extend(svc.subscribe("t", timeout_s=30.0)),
                           daemon=True)
    sub.start()
    svc.run()
    sub.join(timeout=10.0)
    fleet.stop()
    assert not sub.is_alive() and len(seen) == len(knobs)
    assert [r.config_id for r in seen] == sorted(r.config_id for r in seen)
    svc2 = port_core.ExploreService(port_core.transport.LoopbackPair(1).host(), poll_s=0.005)
    svc2.submit_sweep("x", Replay(knobs), "tpu_v4", "8", len(knobs))
    assert svc2.cancel("x") == {"queued_dropped": 0, "inflight_orphaned": 0}
    assert svc2.status("x")["state"] == "cancelled"
    assert list(svc2.subscribe("x")) == []
    svc2.run()


@pytest.mark.parametrize("resumed_in", ["port", "ref"])
def test_service_checkpoints_resume_solo(resumed_in, tmp_path):
    """Durable tenants under one ``checkpoint_root`` (names sanitised per
    tenant): the port service's snapshot and WAL restore, solo, in either
    package, with nothing outstanding and the tenant's id counter."""
    from importlib import import_module

    root = str(tmp_path)
    svc, sweeps = _service("port", SWEEPS[:2], checkpoint_root=root, checkpoint_every=4)
    durable = import_module(PKGS[resumed_in][0].__name__ + ".durable")
    for name, ks, _ in SWEEPS[:2]:
        d = durable.tenant_checkpoint_dir(root, name)
        assert any(f.startswith("snap_") for f in os.listdir(d))
        ck = durable.ExplorationCheckpoint(d)
        assert sum(e["t"] == "tell" for e in ck.read_events(0)) == len(ks)
        store = PKGS[resumed_in][0].ResultStore()
        for rec in sweeps[name].store.records:
            store.add(rec)
        info = durable.restore_sweep(ck, Replay(ks), store, ("time_s", "power_w"))
        assert info["outstanding"] == {} and info["next_id"] == len(ks)


def _control(core):
    from importlib import import_module

    tr = import_module(core.__name__ + ".transport")
    svc = core.ExploreService(tr.LoopbackPair(1).host(), poll_s=0.005)
    knobs = _knobs(3, 4)
    replies = [svc.handle_control({"cmd": tr.CONTROL_SUBMIT, "tenant": "t", "spec": {"n": 4}})]
    svc.sweep_factory = lambda spec: dict(search=Replay(knobs), arch="tpu_v4", shape="8",
                                          n_samples=spec["n"])
    for msg in ({"cmd": tr.CONTROL_SUBMIT, "tenant": "t", "spec": {"n": 4}},
                {"cmd": tr.CONTROL_STATUS, "tenant": "t"}, {"cmd": tr.CONTROL_STATUS},
                {"cmd": tr.CONTROL_CANCEL, "tenant": "t"},
                {"cmd": tr.CONTROL_CANCEL, "tenant": "nope"}, {"cmd": "bogus"}):
        replies.append(svc.handle_control(msg))
    return replies, [tr.is_control_msg(m) for m in ({"cmd": tr.CONTROL_STATUS}, {"cmd": "batch"})]


def test_control_verbs_match_the_reference():
    ours = _control(port_core)
    assert ours == _control(ref_core)
    replies, kinds = ours
    assert replies[0]["ok"] is False and replies[1] == {"ok": True, "tenant": "t"}
    assert kinds == [True, False]


def test_wire_tenant_tag_is_tolerated():
    wire = dict(port_core.TestConfig(5, "a", "s", {"x": 5}).to_wire(), tenant="team-a")
    back = port_core.TestConfig.from_wire(wire)
    assert back.config_id == 5 and back.knobs == {"x": 5}


# ---------------------------------------------------------------------------
# launch.serve_explore against the reference's
# ---------------------------------------------------------------------------


def _csv_rows(path):
    with open(path) as f:
        return {int(r["config_id"]): {k: v for k, v in r.items()
                                      if k.startswith(("knob.", "metric."))}
                for r in csv.DictReader(f)}


TENANTS = [{"name": "bo", "algorithm": "bayesopt", "samples": 12, "weight": 2},
           {"name": "pal", "algorithm": "pal", "samples": 8},
           {"name": "rnd", "algorithm": "random", "samples": 8, "seed": 4}]


@pytest.fixture
def serve_pair(monkeypatch):
    """Both packages' serve_explore with explore_test's stub build."""
    from test_torch_explore import _stub_factory

    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import serve_explore as ref
    from repro_torch.launch import serve_explore as ours

    monkeypatch.setattr(ref, "make_build_fn", _stub_factory(RefArtifact))
    monkeypatch.setattr(ours, "make_build_fn", _stub_factory(PortArtifact))
    return ours, ref


def test_serve_explore_gives_the_reference_csvs(serve_pair, monkeypatch, tmp_path):
    """Three tenants at one client, checkpointed: the port's CLI under
    ``--gp incremental`` and ``--gp cuda`` (the kernels' plain versions on
    the CPU) and the reference's under ``--gp incremental`` write the same
    per-tenant rows."""
    import json

    ours, ref = serve_pair
    spec = str(tmp_path / "t.json")
    with open(spec, "w") as f:
        json.dump(TENANTS, f)
    argv = ["--workload", "llama2-7b", "--reduced", "--clients", "1", "--tenants", spec,
            "--timeout", "60"]
    rows = {}
    for run, gp in (("port", "incremental"), ("port", "cuda"), ("ref", "incremental")):
        out = str(tmp_path / f"{run}-{gp}")
        a = argv + ["--gp", gp, "--out-dir", out, "--checkpoint-root", out + "-ck"]
        if run == "port":
            served = ours.main(a + (["--device", "cpu"] if gp == "cuda" else []))
            assert {n: s.state for n, s in served.service._sweeps.items()} == dict.fromkeys(
                ("bo", "pal", "rnd"), "done")
        else:
            monkeypatch.setattr(sys, "argv", ["serve_explore"] + a)
            ref.main()
        rows[run, gp] = {t["name"]: _csv_rows(os.path.join(out, t["name"] + ".csv"))
                         for t in TENANTS}
    for t in TENANTS:
        assert sorted(rows["port", "cuda"][t["name"]]) == list(range(t["samples"]))
    assert rows["port", "incremental"] == rows["port", "cuda"] == rows["ref", "incremental"]


def test_serve_explore_fleet_builds_each_fingerprint_once(serve_pair, tmp_path):
    import json

    ours, _ = serve_pair
    spec = str(tmp_path / "t.json")
    with open(spec, "w") as f:
        json.dump(TENANTS, f)
    served = ours.main(["--workload", "llama2-7b", "--reduced", "--clients", "2",
                        "--fleet-cache", "serve", "--tenants", spec, "--gp", "incremental",
                        "--out-dir", str(tmp_path / "out"), "--timeout", "60"])
    fps = {repr(tuple(sorted((k, v) for k, v in r.knobs.items()
                             if k.startswith(("attn", "dtype", "dp")))))
           for s in served.service._sweeps.values() for r in s.store.records}
    assert sum(c.n_compiled for c in served.clients) == served.fleet_stats["fleet_misses"]
    assert sum(c.n_compiled for c in served.clients) == len(fps)


def test_serve_explore_needs_the_card_unless_told(monkeypatch):
    import torch

    from repro_torch.launch import serve_explore

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve_explore.parse_args([]).gp == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_explore.main(["--reduced", "--tenants", "unused.json"])
