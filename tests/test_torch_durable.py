"""Durable sweeps on the port against the JAX package's.

``repro_torch.core.{durable,chaos}`` and ``JHost``'s checkpoint path held
against ``repro.core``'s on the same seeded inputs (the templates are
``tests/test_durable.py``'s, with its fake clocks and stub builds):
* snapshot → restore continues with the uninterrupted picks, for BayesOpt
  and PAL on every GP tier of the port (the device tiers on the CPU, where
  the kernels' wrappers take their plain versions), and those picks are the
  reference's numpy ``incremental`` picks;
* the event log, snapshots and torn-tail repair write the reference's bytes
  and give its replay;
* a sweep crashed mid-run (``ChaosTransport``'s crash hook) and resumed
  has zero duplicate evaluations and the uninterrupted sweep's rows bit for
  bit, on the numpy, ``torch`` and ``cuda`` tiers, and those rows are the
  reference's;
* a checkpoint written by either package resumes in the other;
* a port snapshot is plain host data: no ``torch.Tensor``, and it unpickles
  with no class of ``torch``, ``jax`` or ``repro``.
"""
import io
import os
import pickle
import threading

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro.roofline.analysis import Artifact as RefArtifact
from repro_torch.roofline.analysis import Artifact as PortArtifact

PKGS = {"port": (port_core, PortArtifact), "ref": (ref_core, RefArtifact)}
TIERS = ("incremental", "torch", "cuda")


def _tier_kw(gp_mode):
    return {"gp_mode": gp_mode, **({"device": "cpu"} if gp_mode in ("torch", "cuda") else {})}


def _space(core):
    D, K = core.DesignSpace, core.Knob
    return D([
        K("clock_scale", (0.5, 0.75, 1.0), core.KIND_HW),
        K("hbm_scale", (0.25, 0.5, 1.0), core.KIND_HW),
        K("blk", (64, 128, 256, 512), core.KIND_SW),
        K("dtype", ("bfloat16", "float32"), core.KIND_SW),
    ])


def _objective(space, knobs):
    x = space.encode(knobs)
    return np.array([1.0 + float(x.sum()), 2.0 - float(x[0]) + 0.3 * float(x[1])])


# ---------------------------------------------------------------------------
# snapshot → restore: bit-identical picks, and the reference's picks
# ---------------------------------------------------------------------------


def _picks_around_a_snapshot(core, algo, seed, **kw):
    """Picks of an instance past n_init, then of it and of a fresh instance
    restored from its pickled state_dict, side by side."""
    space = _space(core)

    def mk():
        return core.ALGORITHMS[algo](space, seed=seed, n_init=6, pool_size=48, **kw)

    a = mk()
    for _ in range(3):
        for c in a.ask(4):
            a.tell(c, _objective(space, c))
    state = pickle.loads(pickle.dumps(a.state_dict()))
    b = mk()
    b.load_state(state)
    picks = []
    for _ in range(4):
        pa, pb = a.ask(4), b.ask(4)
        assert pa == pb
        picks.append(pa)
        for c in pa:
            y = _objective(space, c)
            a.tell(c, y)
            b.tell(c, y)
    return picks


@pytest.mark.parametrize("algo", ["bayesopt", "pal"])
@pytest.mark.parametrize("gp_mode", ("incremental", "refit", "torch", "cuda"))
@pytest.mark.parametrize("seed", [0, 7])
def test_snapshot_restore_bit_identical_picks(algo, gp_mode, seed):
    ours = _picks_around_a_snapshot(port_core, algo, seed, **_tier_kw(gp_mode))
    ref_mode = "refit" if gp_mode == "refit" else "incremental"
    assert ours == _picks_around_a_snapshot(ref_core, algo, seed, gp_mode=ref_mode)


@pytest.mark.parametrize("gp_mode", TIERS)
def test_reference_state_continues_in_the_port(gp_mode):
    """A reference BayesOpt's numpy state loads into each port tier, and the
    port continues with the reference's picks."""
    rs, ps = _space(ref_core), _space(port_core)
    ref = ref_core.BayesOpt(rs, seed=3, n_init=6, pool_size=48, gp_mode="incremental")
    for _ in range(3):
        for c in ref.ask(4):
            ref.tell(c, _objective(rs, c))
    ours = port_core.BayesOpt(ps, seed=3, n_init=6, pool_size=48, **_tier_kw(gp_mode))
    ours.load_state(pickle.loads(pickle.dumps(ref.state_dict())))
    for _ in range(3):
        pr, po = ref.ask(4), ours.ask(4)
        assert po == pr
        for c in pr:
            ref.tell(c, _objective(rs, c))
            ours.tell(c, _objective(ps, c))


def test_restore_keeps_the_live_capacity():
    """Batched tells pad a fold to a power of two, so the live factor can be
    wider than a restore at n rows would allocate: the snapshot carries the
    capacity, and the restored tier continues on buffers of the same shape
    with the same picks."""
    space = _space(port_core)
    mk = lambda: port_core.BayesOpt(space, seed=1, n_init=6, pool_size=48,  # noqa: E731
                                    **_tier_kw("cuda"))
    a = mk()
    caps = set()
    for size in (6, 5, 5, 5, 5, 5):     # a 5-row fold pads to 8 rows
        for c in a.ask(size):
            a.tell(c, _objective(space, c))
        a.ask(1)                        # folds the pending tells
        gp = a._gp
        caps.add((gp._n, gp._cap))
        state = pickle.loads(pickle.dumps(a.state_dict()))
        b = mk()
        b.load_state(state)
        assert (b._gp._n, b._gp._cap) == (gp._n, gp._cap)
        assert b.ask(3) == a.ask(3)
    assert any(cap > 16 and n <= cap // 2 for n, cap in caps), caps
    legacy = dict(a._gp.state_dict())
    del legacy["cap"]                   # a reference-shaped state still loads
    n = a._gp._n
    assert mk()._gp.load_state(legacy)._n == n


def test_driver_sync_state_roundtrip():
    space = _space(port_core)

    def mk():
        return port_core.SearchDriver(port_core.BayesOpt(space, seed=1, n_init=6, pool_size=48,
                                                         **_tier_kw("torch")), mode="sync")

    a = mk()
    for _ in range(3):
        for c in a.ask(4):
            a.tell(c, _objective(space, c))
    b = mk()
    b.load_state(pickle.loads(pickle.dumps(a.state_dict())))
    for _ in range(3):
        pa, pb = a.ask(4), b.ask(4)
        assert pa == pb
        for c in pa:
            y = _objective(space, c)
            a.tell(c, y)
            b.tell(c, y)


# ---------------------------------------------------------------------------
# ExplorationCheckpoint mechanics: the reference's bytes and replay
# ---------------------------------------------------------------------------


def _checkpoint_files(core, directory):
    """One scripted use of the checkpoint: snapshots past keep-k, a log with
    an ask and a tell, a torn tail repaired on reopen."""
    ck = core.ExplorationCheckpoint(directory, keep=2)
    for i in range(5):
        ck.save({"i": i, "arr": np.arange(i, dtype=float)}, block=True)
    ck.open_log()
    ck.log_ask([0, 1], [{"x": 1}, {"x": 2}])
    pos = ck.log_pos()
    ck.log_tell(0, {"x": 1}, np.array([1.5, 2.5]))
    ck.close()
    with open(os.path.join(directory, ck.EVENTS), "a") as f:
        f.write('{"t": "tell", "id": 1, "kno')          # killed mid-write
    again = core.ExplorationCheckpoint(directory)
    events = again.read_events(), again.read_events(from_pos=pos)
    size = again.open_log()
    again.close()
    with open(os.path.join(directory, ck.EVENTS), "rb") as f:
        log = f.read()
    latest = again.latest()
    return {"seqs": again.all_seqs(), "latest": (latest["i"], latest["arr"].tolist()),
            "events": events, "size": size, "log": log, "pos": pos,
            "files": sorted(os.listdir(directory))}


def test_checkpoint_files_match_the_reference(tmp_path):
    ours = _checkpoint_files(port_core, str(tmp_path / "port"))
    ref = _checkpoint_files(ref_core, str(tmp_path / "ref"))
    assert ours == ref
    assert ours["seqs"] == [4, 5] and [e["t"] for e in ours["events"][0]] == ["ask", "tell"]
    assert ours["size"] == len(ours["log"])


def test_tenant_checkpoint_dir_matches_the_reference():
    from repro.core.durable import tenant_checkpoint_dir as ref_dir
    from repro_torch.core.durable import tenant_checkpoint_dir

    for name in ("a", "team/a", "team a", "../x", "", "ü"):
        assert tenant_checkpoint_dir("/r", name) == ref_dir("/r", name)


class _SpySearch:
    def __init__(self):
        self.asked, self.told = [], []

    def ask(self, n):
        self.asked.append(n)
        return [{"x": i} for i in range(n)]

    def tell(self, knobs, y):
        self.told.append((knobs, np.asarray(y).tolist()))


@pytest.mark.parametrize("snapshot", [False, True])
def test_restore_sweep_matches_the_reference(snapshot, tmp_path):
    """The late-tell reconciliation (a row the CSV flushed whose tell never
    reached the log) and the replay after a snapshot, in both packages."""
    out = {}
    for name, (core, _) in PKGS.items():
        from importlib import import_module

        durable = import_module(core.__name__ + ".durable")
        results = import_module(core.__name__ + ".results")
        d = str(tmp_path / name)
        ck = core.ExplorationCheckpoint(d)
        ck.open_log()
        ck.log_ask([0, 1, 2], [{"x": 0}, {"x": 1}, {"x": 2}])
        ck.log_tell(0, {"x": 0}, np.array([1.0, 2.0]))
        if snapshot:
            ck.save({"event_pos": ck.log_pos(), "next_id": 3,
                     "outstanding": [(1, {"x": 1}), (2, {"x": 2})],
                     "search_state": {"s": 1}}, block=True)
        ck.log_ask([3], [{"x": 3}])
        ck.close()
        store = results.ResultStore()
        for cid in (0, 1, 3):
            store.add(results.ResultRecord(config_id=cid, arch="a", shape="s",
                                           knobs={"x": cid},
                                           metrics={"time_s": 1.0 + cid, "power_w": 2.0 + cid}))
        spy = _SpySearch()
        spy.load_state = lambda s: spy.told.append(("state", s))
        info = durable.restore_sweep(core.ExplorationCheckpoint(d), spy, store,
                                     ("time_s", "power_w"))
        out[name] = (info, spy.asked, spy.told)
    assert out["port"] == out["ref"]
    info = out["port"][0]
    assert info["from_snapshot"] is snapshot and info["n_late_tells"] == 2
    assert info["outstanding"] == {2: {"x": 2}} and info["next_id"] == 4


def test_torn_trailing_csv_row_is_skipped_and_dropped(tmp_path):
    from repro_torch.core.results import ResultRecord, ResultStore

    p = str(tmp_path / "r.csv")
    store = ResultStore(csv_path=p, knob_names=("x",), metric_names=("time_s",))
    store.add(ResultRecord(config_id=0, arch="a", shape="s", knobs={"x": 1},
                           metrics={"time_s": 1.0}))
    store.close()
    with open(p, "a") as f:
        f.write("1,a,s,ok,0,False")          # killed mid-writerow
    fresh = ResultStore(csv_path=p, knob_names=("x",), metric_names=("time_s",))
    assert fresh.resume_from_csv() == 1
    fresh.add(ResultRecord(config_id=1, arch="a", shape="s", knobs={"x": 2},
                           metrics={"time_s": 2.0}))
    fresh.close()
    with open(p) as f:
        assert len(f.read().splitlines()) == 3


# ---------------------------------------------------------------------------
# ChaosTransport: the reference's seeded faults and counters
# ---------------------------------------------------------------------------


def _chaos_script(core):
    """Drops, duplicates, a killed client and a crash hook on a loopback
    pair; everything the far sides saw and the wrapper's stats."""
    from importlib import import_module

    transport = import_module(core.__name__ + ".transport")
    pair = transport.LoopbackPair(3)
    fired = []
    ch = core.ChaosTransport(pair.host(), seed=11, drop_p=0.3, dup_p=0.3,
                             crash_at_results=5, crash_fn=lambda: fired.append(1),
                             kill_client_at=(2, 3))
    for i in range(12):
        ch.push(i % 3, {"cmd": "x", "i": i})
        ch.push_many(i % 3, [{"config_id": i, "k": 0}, {"config_id": i, "k": 1}])
    seen = {c: [] for c in range(3)}
    for c in range(3):
        while True:
            m = pair.client(c).pull(0.0)
            if m is None:
                break
            seen[c].append(m)
    delivered = []
    for i in range(10):
        pair.client(i % 3).push({"config_id": 100 + i, "client_id": i % 3, "status": "ok"})
        delivered.append(ch.pull_many(0.1))
    return seen, delivered, ch.stats(), fired, ch.client_ids()


def test_chaos_matches_the_reference():
    ours, ref = _chaos_script(port_core), _chaos_script(ref_core)
    assert ours == ref
    seen, delivered, stats, fired, alive = ours
    assert stats["dropped"] > 0 and stats["duplicated"] > 0 and fired == [1]
    assert alive == [0, 1] and stats["killed_clients"] == [2]


# ---------------------------------------------------------------------------
# crash mid-sweep, resume: zero duplicates, the uninterrupted rows
# ---------------------------------------------------------------------------


class _Boom(Exception):
    pass


def _toy(core, artifact_cls):
    import zlib

    space = _space(core)
    jc = core.JConfig(space, n_chips=8)

    def build(tc):
        h = zlib.crc32(repr(jc.cache_key(tc)).encode()) % 7 + 1
        return artifact_cls(flops_per_device=5e12 * h, bytes_per_device=2e10,
                            wire_bytes_per_device=1e8, collectives={},
                            arg_bytes=10 ** 9, temp_bytes=10 ** 8,
                            output_bytes=10 ** 6, n_devices=8), {}

    return space, jc, build


def _leg(pkg, directory, *, gp_mode="incremental", n=36, crash_at=None, resume=False):
    """One explore leg of a durable toy sweep (BayesOpt, batches of 6, a
    snapshot every 12 results) in package ``pkg``; a crash raises out of
    the host loop where the real hook ends the process."""
    core, artifact_cls = PKGS[pkg]
    space, jc, build = _toy(core, artifact_cls)
    pair = core.transport.LoopbackPair(1)
    client = core.JClient(jc, build, transport=pair.client(0), client_id=0)
    thread = threading.Thread(target=client.serve, kwargs=dict(poll_s=0.005), daemon=True)
    thread.start()
    ht = pair.host()
    if crash_at is not None:
        def boom():
            raise _Boom()
        ht = core.ChaosTransport(ht, crash_at_results=crash_at, crash_fn=boom)
    store = core.ResultStore(csv_path=os.path.join(directory, "r.csv"),
                             knob_names=[k.name for k in space],
                             metric_names=("time_s", "power_w"))
    host = core.JHost(ht, store, timeout_s=60.0, poll_s=0.002)
    kw = _tier_kw(gp_mode) if pkg == "port" else {"gp_mode": gp_mode}
    search = core.BayesOpt(space, seed=4, n_init=8, pool_size=64, **kw)
    crashed = False
    try:
        host.explore(search, "toy", "gen", n, batch_size=6, dispatch="eager",
                     checkpoint_dir=os.path.join(directory, "ckpt"),
                     checkpoint_every=12, resume=resume)
    except _Boom:
        crashed = True
    host.stop_clients()
    thread.join(timeout=10.0)
    store.close()
    return store, crashed, getattr(host, "resume_info", None)


def _sweep_key(store):
    return {r.config_id: (tuple(sorted(r.knobs.items())),
                          float(r.metrics["time_s"]).hex(),
                          float(r.metrics["power_w"]).hex())
            for r in store.records}


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The reference's uninterrupted toy sweep (numpy tier)."""
    store, crashed, _ = _leg("ref", str(tmp_path_factory.mktemp("u")))
    assert not crashed
    return _sweep_key(store)


def _check_resumed(store, uninterrupted, n=36):
    ids = [r.config_id for r in store.records]
    assert len(ids) == len(set(ids)) == n            # zero duplicate evaluations
    assert set(ids) == set(range(n))
    assert _sweep_key(store) == uninterrupted        # bit-identical rows


@pytest.mark.parametrize("gp_mode", TIERS)
@pytest.mark.parametrize("crash_at", [7, 20])
def test_crash_resume_zero_dups_bit_identical(crash_at, gp_mode, uninterrupted, tmp_path):
    """crash_at=7 ends before any snapshot (the whole log replays against a
    fresh searcher); crash_at=20 past one (snapshot plus the log's suffix)."""
    straight, crashed, _ = _leg("port", str(tmp_path / "u"), gp_mode=gp_mode)
    assert not crashed and _sweep_key(straight) == uninterrupted
    _, crashed, _ = _leg("port", str(tmp_path / "c"), gp_mode=gp_mode, crash_at=crash_at)
    assert crashed
    resumed, crashed, info = _leg("port", str(tmp_path / "c"), gp_mode=gp_mode, resume=True)
    assert not crashed
    assert info["from_snapshot"] is (crash_at == 20) and info["n_ask_mismatch"] == 0
    assert info["outstanding"]                       # the lost chunk, re-submitted
    _check_resumed(resumed, uninterrupted)


@pytest.mark.parametrize("crash_at", [7, 20])
@pytest.mark.parametrize("crashed_in,resumed_in", [("ref", "port"), ("port", "ref")])
def test_checkpoint_crosses_between_the_packages(crashed_in, resumed_in, crash_at,
                                                 uninterrupted, tmp_path):
    """The WAL and snapshots one package's crashed sweep left resume in the
    other package's JHost, to the reference's uninterrupted rows."""
    _, crashed, _ = _leg(crashed_in, str(tmp_path), crash_at=crash_at)
    assert crashed
    resumed, crashed, _ = _leg(resumed_in, str(tmp_path), resume=True)
    assert not crashed
    _check_resumed(resumed, uninterrupted)


class _HostDataOnly(pickle.Unpickler):
    """Unpickles numpy and builtins only: a class of torch, jax or either
    JExplore package (which would import JAX on load) fails."""

    def find_class(self, module, name):
        if not (module.split(".")[0] in ("numpy", "builtins", "collections", "copyreg",
                                          "_codecs")):
            raise AssertionError(f"snapshot needs {module}.{name}")
        return super().find_class(module, name)


def _tensors_in(obj, seen=None):
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return 0
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return 1
    if isinstance(obj, dict):
        return sum(_tensors_in(k, seen) + _tensors_in(v, seen) for k, v in obj.items())
    if isinstance(obj, (list, tuple, set, frozenset)):
        return sum(_tensors_in(v, seen) for v in obj)
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        return _tensors_in(vars(obj), seen)
    return 0


@pytest.mark.parametrize("gp_mode", ("torch", "cuda"))
@pytest.mark.parametrize("algo", ["bayesopt", "pal"])
def test_snapshot_is_plain_host_data(algo, gp_mode, tmp_path):
    core = port_core
    space, jc, build = _toy(core, PortArtifact)
    search = core.ALGORITHMS[algo](space, seed=2, n_init=6, pool_size=32, **_tier_kw(gp_mode))
    for _ in range(3):
        for c in search.ask(5):
            search.tell(c, _objective(space, c))
    ck = core.ExplorationCheckpoint(str(tmp_path))
    ck.save({"version": 1, "event_pos": 0, "next_id": 15, "outstanding": [],
             "search_state": search.state_dict(), "meta": {}}, block=True)
    ck.close()
    (name,) = [f for f in os.listdir(str(tmp_path)) if f.startswith("snap_")]
    with open(os.path.join(str(tmp_path), name), "rb") as f:
        snap = _HostDataOnly(io.BytesIO(f.read())).load()
    assert _tensors_in(snap) == 0
    assert snap["search_state"]["attrs"]["_gp_state"]["kind"] == gp_mode


# ---------------------------------------------------------------------------
# elastic membership: a client joins mid-sweep, another drains and leaves
# ---------------------------------------------------------------------------


def test_elastic_join_and_drain_end_to_end():
    """The port's counterpart of ``tests/test_durable.py``'s test of the same
    name: a client HELLOs in mid-sweep and serves dispatches; another
    GOODBYEs (drain) and leaves without losing a config.  The join (at the
    10th result) and the drain (at the 25th) are driven by the record count
    on the host's own thread, inside ``ResultStore.add``, so the joiner
    finds 50 configs still to come however fast the builds run."""
    core = port_core
    space, jc, build = _toy(core, PortArtifact)
    pair = core.transport.LoopbackPair(2)
    clients = {i: core.JClient(jc, build, transport=pair.client(i), client_id=i)
               for i in range(2)}
    threads = [threading.Thread(target=c.serve, kwargs=dict(poll_s=0.005), daemon=True)
               for c in clients.values()]

    def join():
        pair.add_client(2)                   # the mailbox before serve (loopback)
        clients[2] = core.JClient(jc, build, transport=pair.client(2), client_id=2)
        threads.append(threading.Thread(target=clients[2].serve,
                                        kwargs=dict(poll_s=0.005), daemon=True))
        threads[-1].start()
        clients[2].hello()

    events = {10: join, 25: lambda: clients[1].goodbye(drain=True)}

    class Store(core.ResultStore):
        def add(self, rec):
            super().add(rec)
            events.pop(len(self.records), lambda: None)()

    for t in threads:
        t.start()
    store = Store()
    host = core.JHost(pair.host(), store, timeout_s=60.0, poll_s=0.002)
    host.explore(core.RandomSearch(space, seed=0), "toy", "gen", 60, batch_size=5,
                 dispatch="pipelined")
    host.stop_clients()
    assert not events
    ids = [r.config_id for r in store.records]
    assert len(ids) == len(set(ids)) == 60
    assert all(r.status == "ok" for r in store.records)
    served = [r.client_id for r in store.records]
    assert 2 in served                       # the joiner did real work
    stats = host.scheduler.stats()
    assert stats["clients_joined"] >= 1 and stats["clients_left"] >= 1
