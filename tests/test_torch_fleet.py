"""The fleet artifact store on the port against the JAX package's.

``repro_torch.core.fleet.FleetArtifactStore`` answers scripted frame
sequences (``tests/test_fleet_store.py``'s, and seeded random ones) with
the reference store's pushes and counters; JClient's fleet tier (fetch,
prefetch, the inline answer to a relayed fetch, the backlog, announce)
sends the reference client's frames; the scheduler's free-rider placement
matches; and end to end N clients × F fingerprints cost exactly F builds.
"""
import threading

import numpy as np
import pytest

import repro.core as ref_core
import repro_torch.core as port_core
from repro.roofline.analysis import Artifact as RefArtifact
from repro_torch.core.transport import (ARTIFACT_FETCH, ARTIFACT_MISS, ARTIFACT_PUT,
                                        ARTIFACT_QUERY, chunk_blob)
from repro_torch.roofline.analysis import Artifact as PortArtifact

PKGS = {"port": (port_core, PortArtifact), "ref": (ref_core, RefArtifact)}


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def put(addr, cid=0, blob=b"engine-bytes", **extra):
    return {"cmd": ARTIFACT_PUT, "addr": addr, "fp": f"fp-{addr}", "client_id": cid,
            "blob": blob, **extra}


def query(addr, cid, **extra):
    return {"cmd": ARTIFACT_QUERY, "addr": addr, "fp": f"fp-{addr}", "client_id": cid, **extra}


def announce(addr, cid):
    return {"cmd": ARTIFACT_PUT, "addr": addr, "fp": f"fp-{addr}", "client_id": cid}


def gone(addr, cid):
    return {"cmd": ARTIFACT_PUT, "addr": addr, "client_id": cid, "status": "gone"}


def _random_script(seed, n=120):
    """Queries (active and passive), PUTs with and without blobs, gone
    replies, chunked PUTs and clock steps over 6 addresses and 4 clients."""
    rng = np.random.default_rng(seed)
    script = []
    for _ in range(n):
        addr, cid = f"a{int(rng.integers(6))}", int(rng.integers(4))
        ev = rng.random()
        if ev < 0.45:
            script.append(query(addr, cid, **({"spec": True} if rng.random() < 0.3 else {})))
        elif ev < 0.6:
            script.append(put(addr, cid, blob=rng.bytes(int(rng.integers(1, 300)))))
        elif ev < 0.7:
            script.append(announce(addr, cid))
        elif ev < 0.75:
            script.append(gone(addr, cid))
        elif ev < 0.85:
            blob = rng.bytes(int(rng.integers(200, 700)))
            script.extend(chunk_blob({"addr": addr, "fp": f"fp-{addr}", "client_id": cid},
                                     blob, 256))
        else:
            script.append(("tick", float(rng.uniform(0.0, 60.0))))
    return script


SCRIPTS = {
    # the reference tests' sequences
    "compiler-then-waiters": ("serve", {}, [query("aa", 0), query("aa", 1), query("aa", 2),
                                            put("aa", 0)]),
    "serve-cached": ("serve", {}, [put("aa", 0), query("aa", 3), query("bb", 3)]),
    "compiler-requery": ("serve", {}, [query("aa", 0), query("aa", 0)]),
    "spec-no-duty": ("serve", {}, [query("aa", 0, spec=True), query("aa", 1)]),
    "spec-joins-waiters": ("serve", {}, [query("aa", 0), query("aa", 1, spec=True),
                                         put("aa", 0)]),
    "relay-round-trip": ("relay", {}, [announce("aa", 0), query("aa", 1), put("aa", 0)]),
    "relay-gone": ("relay", {}, [announce("aa", 0), query("aa", 1), gone("aa", 0)]),
    "tick-expires": ("serve", {"pending_timeout_s": 10.0},
                     [query("aa", 0), query("aa", 1), ("tick", 5.0), ("tick", 6.0)]),
    "lru-by-bytes": ("serve", {"max_bytes": 250},
                     [put(f"a{i}", 0, blob=bytes(100)) for i in range(4)]
                     + [query("a2", 1), put("a4", 0, blob=bytes(100))]),
    "chunked": ("serve", {"chunk_bytes": 1000},
                chunk_blob({"addr": "aa", "fp": "fp-aa", "client_id": 0},
                           np.random.default_rng(0).bytes(2500), 1000) + [query("aa", 2)]),
    # seeded random sequences, both modes
    **{f"random-{mode}-{seed}": (mode, {"pending_timeout_s": 30.0, "max_bytes": 1500,
                                        "chunk_bytes": 256}, _random_script(seed))
       for mode in ("serve", "relay") for seed in range(3)},
}


def _replay(core, mode, kw, script):
    clk = FakeClock()
    pushes = []
    store = core.FleetArtifactStore(mode, clock=clk, **kw)
    trace = []
    for ev in script:
        if isinstance(ev, tuple):
            clk.t += ev[1]
            store.tick(lambda c, m: pushes.append((c, m)))
        else:
            store.on_message(dict(ev), lambda c, m: pushes.append((c, m)))
        trace.append((len(pushes), sorted(store.resident_addrs()),
                      [store.resident_fp(f"fp-a{i}") for i in range(6)]
                      + [store.resident_fp("fp-aa")]))
    return pushes, trace, store.stats()


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_store_answers_as_the_reference(script):
    mode, kw, frames = SCRIPTS[script]
    ours = _replay(port_core, mode, kw, frames)
    assert ours == _replay(ref_core, mode, kw, frames)
    assert ours[0] or script == "lru-by-bytes"


def test_store_attributes_hits_to_tenants():
    out = {}
    for name, (core, _) in PKGS.items():
        store = core.FleetArtifactStore("serve")
        store.tenant_fn = {0: "a", 1: "b", 2: None}.get
        pushes = []
        for ev in (query("aa", 0), query("aa", 1), put("aa", 0), query("aa", 2),
                   query("bb", 1)):
            store.on_message(ev, lambda c, m: pushes.append((c, m)))
        out[name] = (pushes, store.stats())
    assert out["port"] == out["ref"]
    assert out["port"][1]["fleet_tenant_hits"] == {"b": 1}


def test_cache_effectiveness_with_fleet_stats_matches_the_reference():
    from repro.launch.report import cache_effectiveness as ref_ce
    from repro_torch.launch.report import cache_effectiveness

    infos = [{"hits": 3, "misses": 2, "evictions": 0, "currsize": 2, "maxsize": 64,
              "fleet_hits": 1, "fleet_misses": 1, "fleet_bytes_in": 1234},
             {"hits": 1, "misses": 4, "evictions": 1, "currsize": 3, "maxsize": 64,
              "fleet_hits": 3, "fleet_misses": 0, "fleet_bytes_in": 5678}]
    for stats in (None, _replay(port_core, *SCRIPTS["random-serve-0"])[2],
                  dict(_replay(port_core, *SCRIPTS["random-relay-1"])[2],
                       fleet_tenant_hits={"a": 2, "b": 1}, fleet_tenant_misses={"a": 1})):
        assert cache_effectiveness(infos, stats) == ref_ce(infos, stats)


# ---------------------------------------------------------------------------
# JClient's fleet tier: the reference client's frames
# ---------------------------------------------------------------------------


def _small_space(core, n_fps=4):
    return core.DesignSpace([core.Knob("clock_scale", (0.5, 1.0), core.KIND_HW),
                             core.Knob("blk", tuple(range(n_fps)), core.KIND_SW)])


def _toy(artifact_cls, f, n_dev=256):
    return artifact_cls(flops_per_device=f, bytes_per_device=2e10, wire_bytes_per_device=1e8,
                        collectives={}, arg_bytes=10 ** 9, temp_bytes=10 ** 8,
                        output_bytes=10 ** 6, n_devices=n_dev)


def _counting_build(artifact_cls, jc):
    calls = []

    def build(tc):
        calls.append(jc.cache_key(tc))
        h = hash(jc.cache_key(tc)) % 7 + 1
        return _toy(artifact_cls, 5e12 * h), {"decode_artifact": _toy(artifact_cls, 1e11 * h),
                                              "n_decode_tokens": 10}
    return build, calls


def _host_frames(core, pair):
    out = []
    while not pair.to_host.empty():
        msg = core.transport.decode_wire(pair.to_host.get())
        out.append({k: (type(v).__name__ if k == "blob" else v) for k, v in msg.items()})
    return out


def _client_case(pkg, case):
    """One of the reference's client scenarios; what the client sent up,
    what it built, holds and counts."""
    core, artifact_cls = PKGS[pkg]
    space = _small_space(core)
    jc = core.JConfig(space, n_chips=8)
    build, _ = _counting_build(artifact_cls, jc)
    pair = core.transport.LoopbackPair(2)
    mode = "relay" if case in ("fetch-serves-inline", "serve-fetch-gone") else "serve"
    me = core.JClient(jc, build, transport=pair.client(0), client_id=0, fleet_mode=mode,
                      fleet_timeout_s=2.0)
    tc = core.TestConfig(0, "a", "s", space.sample(np.random.default_rng(0)))
    other = core.TestConfig(1, "a", "s", dict(tc.knobs, blk=(tc.knobs["blk"] + 1) % 4))
    key, key2 = jc.cache_key(tc), jc.cache_key(other)
    host = pair.host()
    got = None
    if case == "fetch-adopts-peer-blob":
        peer = core.JClient(jc, build, transport=pair.client(1), client_id=1, fleet_mode=mode)
        host.push(0, put(me._addr(key), cid=1, blob=peer._payload_blob(key, build(tc))))
        got = me._fleet_fetch(key) == build(tc)
    elif case == "fetch-miss-makes-compiler":
        host.push(0, {"cmd": ARTIFACT_MISS, "addr": me._addr(key), "spec": True})
        host.push(0, {"cmd": ARTIFACT_MISS, "addr": me._addr(key)})
        got = me._fleet_fetch(key)
    elif case == "fetch-serves-inline":
        me._addr_key[me._addr(key2)] = key2
        me._cache_insert(key2, build(other))
        host.push(0, {"cmd": ARTIFACT_FETCH, "addr": me._addr(key2)})
        host.push(0, {"cmd": ARTIFACT_MISS, "addr": me._addr(key)})
        got = me._fleet_fetch(key)
    elif case == "fetch-backlogs-frames":
        host.push(0, {"cmd": "whatever", "x": 1})
        host.push(0, {"cmd": ARTIFACT_MISS, "addr": me._addr(key)})
        got = (me._fleet_fetch(key), me._rx_backlog, me._pull(0.0))
    elif case == "serve-fetch-gone":
        me._serve_fetch("deadbeef")
    elif case == "prefetch":
        peer = core.JClient(jc, build, transport=pair.client(1), client_id=1, fleet_mode=mode)
        host.push(0, put(me._addr(key), cid=1, blob=peer._payload_blob(key, build(tc))))
        host.push(0, {"cmd": ARTIFACT_MISS, "addr": me._addr(key2), "spec": True})
        me._fleet_prefetch([key, key2])
        got = (me._cache[key] == build(tc), key2 in me._fleet_skip)
    elif case == "prefetch-claims-duty":
        host.push(0, {"cmd": ARTIFACT_MISS, "addr": me._addr(key)})
        me._fleet_prefetch([key])
        claimed = key in me._fleet_skip
        got = (claimed, me._artifact(key, tc) == build(tc), key in me._fleet_skip)
    # a blob pickles the package's own Artifact class, whose module path
    # differs in length: byte counters are compared as zero or not
    info = {k: (v > 0 if k.startswith("fleet_bytes") else v) for k, v in me.cache_info().items()}
    return got, _host_frames(core, pair), me.n_compiled, info


CLIENT_CASES = ["fetch-adopts-peer-blob", "fetch-miss-makes-compiler", "fetch-serves-inline",
                "fetch-backlogs-frames", "serve-fetch-gone", "prefetch", "prefetch-claims-duty"]


@pytest.mark.parametrize("case", CLIENT_CASES)
def test_client_fleet_tier_matches_the_reference(case):
    ours = _client_case("port", case)
    assert ours == _client_case("ref", case)
    got, frames = ours[0], ours[1]
    if case == "fetch-adopts-peer-blob":
        assert got is True and frames[0]["cmd"] == ARTIFACT_QUERY
    if case == "serve-fetch-gone":
        assert frames[0]["cmd"] == ARTIFACT_PUT and frames[0]["status"] == "gone"


# ---------------------------------------------------------------------------
# scheduler: fleet-resident groups ride free
# ---------------------------------------------------------------------------


def _free_rider(core, fleet_fn):
    sched = core.DispatchScheduler([0], policy="eager", batch_size=6, affinity="strict",
                                   fingerprint_fn=lambda tc: tc.knobs["sw"],
                                   fleet_resident_fn=fleet_fn)
    for i, fp in enumerate(["A", "A", "B", "B", "C", "C"]):
        sched.submit(core.TestConfig(i, "a", "s", {"x": i, "sw": fp}))
    return [(c, [t.config_id for t in tcs]) for c, tcs in sched.next_dispatches()], sched.stats()


@pytest.mark.parametrize("resident", ["none", "B", "raises"])
def test_fleet_resident_groups_ride_free_as_in_the_reference(resident):
    fn = {"none": None, "B": lambda fp: fp == "B", "raises": lambda fp: 1 / 0}[resident]
    ours = _free_rider(port_core, fn)
    assert ours == _free_rider(ref_core, fn)
    if resident == "B":
        assert sorted(ours[0][0][1]) == [0, 1, 2, 3] and ours[1]["fleet_rides"] == 1


# ---------------------------------------------------------------------------
# end to end: N clients x F fingerprints -> exactly F builds
# ---------------------------------------------------------------------------


class Replay:
    def __init__(self, ks):
        self._k = list(ks)

    def ask(self, n):
        out, self._k = self._k[:n], self._k[n:]
        return out

    def tell(self, knobs, y):
        pass


def _run_fleet(knobs, jc, build, store, n_clients=4):
    core = port_core
    pair = core.transport.LoopbackPair(n_clients)
    clients = [core.JClient(jc, build, transport=pair.client(i), client_id=i, cache_size=16,
                            fleet_mode=store.mode, fleet_timeout_s=10.0)
               for i in range(n_clients)]
    threads = [threading.Thread(target=c.serve, kwargs=dict(poll_s=0.005), daemon=True)
               for c in clients]
    for t in threads:
        t.start()
    host = core.JHost(pair.host(), core.ResultStore(), timeout_s=60.0, poll_s=0.005)
    res = host.explore(Replay(knobs), "a", "s", len(knobs), batch_size=6, dispatch="pipelined",
                       fingerprint_fn=jc.cache_key, fleet_store=store)
    for i in range(n_clients):
        host.transport.push(i, {"cmd": "stop"})
    for t in threads:
        t.join(timeout=10.0)
    return res, clients


@pytest.mark.parametrize("mode", ["serve", "relay"])
def test_end_to_end_exactly_f_builds(mode):
    space = _small_space(port_core)
    jc = port_core.JConfig(space, n_chips=8)
    build, calls = _counting_build(PortArtifact, jc)
    rng = np.random.default_rng(2)
    knobs = [space.sample(rng) for _ in range(24)]
    unique = len({jc.cache_key(port_core.TestConfig(0, "a", "s", k)) for k in knobs})
    store = port_core.FleetArtifactStore(mode)
    res, clients = _run_fleet(knobs, jc, build, store)
    assert sum(r.status == "ok" for r in res.records) == len(knobs)
    assert sum(c.n_compiled for c in clients) == len(calls) == unique
    assert store.stats()["fleet_hits"] > 0
    if mode == "serve":        # brand-new clients, the same store: no build at all
        res, clients = _run_fleet(knobs, jc, build, store)
        assert sum(c.n_compiled for c in clients) == 0 and len(calls) == unique
        assert sum(c.cache_info()["fleet_hits"] for c in clients) > 0
