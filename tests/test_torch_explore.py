"""The explore loop end to end: ``repro_torch.launch.explore`` against
``repro.launch.explore``.

Both packages' ``main`` run with ``make_build_fn`` replaced by one stub,
which returns a deterministic Artifact (prefill and decode) from the arch
and the sw knobs.  With the same seed and ``--clients 1`` the CSVs have
identical knob and ``metric.*`` columns per ``config_id`` and the same pick
order, for random, nsga2 and bayesopt, scalar and ``--batch-size 4``, eager
and pipelined; with ``--clients 2`` the metrics keyed by knobs are equal.
The durability, fault-injection and fleet flags give the reference's CSV
on the same stub build.  The port's own runs: the real build
(``--reduced``), the GP tiers against each other on the CPU, the persistent
cache, a crash that ends the process with exit code 42 and its resume.  The
reference is imported inside the fixtures, so the card test at the end runs
where there is no JAX.
"""
import csv
import functools
import os
import subprocess
import sys
import types

import pytest
import torch

from repro_torch.core.search import ALGORITHMS, BayesOpt
from repro_torch.launch import explore
from repro_torch.roofline import analysis

ALGOS = ["random", "nsga2", "bayesopt"]
BASE = ["--workload", "llama2-7b", "--reduced", "--seed", "3", "--timeout", "60"]


def _stub_factory(artifact_cls):
    """A ``make_build_fn`` whose builds are a fixed function of the arch and
    the sw knobs (no model is built)."""
    def make_build_fn(args, jc):
        def build(tc):
            k = tc.knobs
            q, kv = k.get("attn_block_q", 256), k.get("attn_block_kv", 256)
            scale = len(tc.arch) * (1.0 + q / 1024.0) * (1.0 + kv / 4096.0)

            def art(f):
                return artifact_cls(
                    flops_per_device=1e11 * scale * f, bytes_per_device=3e9 * f / scale,
                    wire_bytes_per_device=2e7 * f, collectives={"all-reduce": 2e7 * f},
                    arg_bytes=int(2e9 * f), temp_bytes=int(q * kv * 1000),
                    output_bytes=int(4e6 * f), n_devices=8,
                    hbm_est_per_device=1.5e9 * f * (1.0 + 64.0 / q))
            return art(1.0), {"decode_artifact": art(0.02),
                              "n_decode_tokens": args.gen_tokens}
        return build
    return make_build_fn


@pytest.fixture
def ref_explore(monkeypatch):
    """The reference's explore module with the stub build.  Importing it
    sets ``XLA_FLAGS`` when unset; the fixture keeps that out of the
    process."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import explore as ref
    from repro.roofline import analysis as ref_analysis

    monkeypatch.setattr(ref, "make_build_fn", _stub_factory(ref_analysis.Artifact))
    return ref


@pytest.fixture
def stub_port(monkeypatch):
    monkeypatch.setattr(explore, "make_build_fn", _stub_factory(analysis.Artifact))


def _run_ref(ref, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["explore"] + argv)
    ref.main()


def _rows(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return {int(r["config_id"]): {k: v for k, v in r.items()
                                  if k.startswith(("knob.", "metric."))} for r in rows}


def _header(path):
    with open(path) as f:
        return next(csv.reader(f))


@pytest.mark.parametrize("dispatch", ["eager", "pipelined"])
@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("algo", ALGOS)
def test_same_csv_as_the_reference(algo, batch, dispatch, ref_explore, stub_port,
                                   monkeypatch, tmp_path):
    argv = BASE + ["--algorithm", algo, "--samples", "24", "--clients", "1",
                   "--dispatch", dispatch]
    if batch:
        argv += ["--batch-size", str(batch)]
    ours, ref = str(tmp_path / "port.csv"), str(tmp_path / "ref.csv")
    store = explore.main(argv + ["--gp", "incremental", "--out", ours])
    _run_ref(ref_explore, argv + ["--gp", "incremental", "--out", ref], monkeypatch)
    assert _header(ours) == _header(ref)
    got, want = _rows(ours), _rows(ref)
    assert sorted(got) == sorted(want) == list(range(24))
    assert got == want                       # knobs (the picks) and metrics
    assert len(store.ok_records()) == 24


@pytest.mark.parametrize("algo", ["random", "bayesopt"])
def test_two_clients_same_metrics_per_knobs(algo, ref_explore, stub_port, monkeypatch,
                                            tmp_path):
    argv = BASE + ["--algorithm", algo, "--samples", "16", "--clients", "2",
                   "--batch-size", "2", "--gp", "incremental"]
    ours, ref = str(tmp_path / "port.csv"), str(tmp_path / "ref.csv")
    explore.main(argv + ["--out", ours])
    _run_ref(ref_explore, argv + ["--out", ref], monkeypatch)

    def by_knobs(rows):
        return {tuple(sorted((k, v) for k, v in r.items() if k.startswith("knob."))):
                {k: v for k, v in r.items() if k.startswith("metric.")}
                for r in rows.values()}

    got, want = by_knobs(_rows(ours)), by_knobs(_rows(ref))
    assert len(got) == 16
    if algo == "random":                      # its picks ignore the tells
        assert got == want
    shared = set(got) & set(want)
    assert shared and all(got[k] == want[k] for k in shared)


def test_torch_tier_on_the_cpu_matches_the_reference(ref_explore, stub_port, monkeypatch,
                                                     tmp_path):
    argv = BASE + ["--algorithm", "bayesopt", "--samples", "20", "--clients", "1"]
    ours, ref = str(tmp_path / "port.csv"), str(tmp_path / "ref.csv")
    explore.main(argv + ["--gp", "torch", "--device", "cpu", "--out", ours])
    _run_ref(ref_explore, argv + ["--gp", "incremental", "--out", ref], monkeypatch)
    assert _rows(ours) == _rows(ref)


@pytest.mark.parametrize("algo,strategy", [("bayesopt", "ehvi"), ("bayesopt", "parego"),
                                           ("pal", None)])
def test_gp_tiers_give_the_same_sweep(algo, strategy, tmp_path, monkeypatch):
    """The real build (reduced llama2-7b on meta) under ``--gp incremental``,
    ``torch`` and ``cuda`` (on the CPU the CUDA tier's wrappers take the
    kernels' plain versions): the same CSV columns per config.  The CLI has
    no acquisition flag, as the reference's has none: the strategy is set
    on the searcher the sweep builds."""
    argv = BASE + ["--algorithm", algo, "--samples", "18", "--clients", "1",
                   "--gen-tokens", "8"]
    if strategy:
        monkeypatch.setitem(ALGORITHMS, "bayesopt",
                            functools.partial(BayesOpt, strategy=strategy))
    outs = {}
    for gp in ("incremental", "torch", "cuda"):
        outs[gp] = str(tmp_path / f"{gp}.csv")
        extra = [] if gp == "incremental" else ["--device", "cpu"]
        res = explore.run(argv + ["--gp", gp, "--out", outs[gp]] + extra)
        if gp == "cuda":
            stats = res.algo._gp.stats()
            assert stats["cuda_appends"] > 0
            assert (stats["cuda_scores"] > 0) == (strategy == "ehvi")
    assert _rows(outs["incremental"]) == _rows(outs["torch"]) == _rows(outs["cuda"])


def test_real_build_run_reports_where_time_went(tmp_path, capsys):
    res = explore.run(BASE + ["--algorithm", "random", "--samples", "10", "--clients", "2",
                              "--gen-tokens", "8", "--out", str(tmp_path / "x.csv")])
    t = res.timings
    assert t["builds"] == sum(c.n_compiled for c in res.clients) > 0
    assert t["asks"] > 0 and t["tells"] == 10
    assert 0 < t["build_s"] and 0 <= t["ask_s"] + t["tell_s"] <= t["wall_s"]
    rows = _rows(str(tmp_path / "x.csv"))
    assert len(rows) == 10 and all(float(r["metric.time_s"]) > 0 for r in rows.values())


def test_cache_dir_reuses_builds(tmp_path):
    argv = BASE + ["--algorithm", "random", "--samples", "12", "--clients", "1",
                   "--gen-tokens", "8", "--cache-dir", str(tmp_path / "cache")]
    first = explore.run(argv + ["--out", str(tmp_path / "a.csv")])
    second = explore.run(argv + ["--out", str(tmp_path / "b.csv")])
    assert first.timings["builds"] > 0 and second.timings["builds"] == 0
    assert second.clients[0].cache_info()["disk_hits"] == first.timings["builds"]
    assert _rows(str(tmp_path / "a.csv")) == _rows(str(tmp_path / "b.csv"))


def test_async_search_times_its_polls(stub_port, tmp_path):
    """Under ``--async-search`` the host loop asks through the driver's
    ``poll_ask``: its time is the search's, not the dispatch's."""
    res = explore.run(BASE + ["--algorithm", "bayesopt", "--gp", "incremental",
                              "--async-search", "--samples", "12", "--clients", "1",
                              "--out", str(tmp_path / "x.csv")])
    t = res.timings
    assert t["polls"] > 0 and t["poll_s"] > 0 and t["asks"] == 0 and t["tells"] == 12
    parts = t["ask_s"] + t["tell_s"] + t["poll_s"] + t["dispatch_s"]
    assert parts == pytest.approx(t["wall_s"], rel=1e-9)


class _Crash(Exception):
    pass


@pytest.fixture
def no_exit(monkeypatch):
    """``--chaos-crash-at``'s hook ends the process with ``os._exit(42)``;
    here it raises instead, in both packages, so the sweep's state on disk
    is what a killed host leaves (the CSV is flushed per row)."""
    from repro.core import chaos as ref_chaos
    from repro_torch.core import chaos

    def exit_(code):
        raise _Crash(code)

    for mod in (chaos, ref_chaos):
        monkeypatch.setattr(mod, "os", types.SimpleNamespace(_exit=exit_))


# seed 26 drops the third outbound chunk and no other of the first 30
SLICE_6_FLAGS = {
    "checkpoint-dir": (["--algorithm", "bayesopt", "--clients", "1"], [["--checkpoint-dir"]]),
    "resume": (["--algorithm", "bayesopt", "--clients", "1"],
               [["--checkpoint-dir", "--samples", "10"], ["--checkpoint-dir", "--resume"]]),
    "chaos-crash-at": (["--algorithm", "bayesopt", "--clients", "1", "--batch-size", "3"],
                       [["--checkpoint-dir", "--chaos-crash-at", "5"],
                        ["--checkpoint-dir", "--resume"]]),
    "chaos-drop": (["--algorithm", "random", "--clients", "2", "--batch-size", "4",
                    "--timeout", "0.5"], [["--chaos-drop", "0.1", "--chaos-seed", "26"]]),
    "fleet-cache": (["--algorithm", "random", "--clients", "2", "--batch-size", "2"],
                    [["--fleet-cache", "serve"]]),
}


def _legs(run, legs, argv, directory):
    """Run each leg of a flag's script; ``--checkpoint-dir`` names one
    directory for all of them.  Returns the last leg's result (None where
    a crash ended it)."""
    out = None
    for leg in legs:
        extra = []
        for a in leg:
            extra += [a, os.path.join(directory, "ck")] if a == "--checkpoint-dir" else [a]
        try:
            out = run(argv + extra)
        except _Crash:
            out = None
    return out


@pytest.mark.parametrize("flag", sorted(SLICE_6_FLAGS))
def test_slice_6_flags_give_the_reference_csv(flag, ref_explore, stub_port, no_exit,
                                              monkeypatch, tmp_path):
    """Each durability, fault-injection and fleet flag runs, and the port's
    CSV is the reference's on the shared stub build: the checkpointed sweep,
    a sweep extended by ``--resume``, a crash at the 5th result resumed, a
    dropped chunk retried after its deadline on the other client, and the
    fleet store's shared builds."""
    extra, legs = SLICE_6_FLAGS[flag]
    argv = BASE + ["--gp", "incremental", "--samples", "20"] + extra
    ours, ref = str(tmp_path / "port.csv"), str(tmp_path / "ref.csv")
    res = _legs(lambda a: explore.run(a), legs, argv + ["--out", ours], str(tmp_path / "p"))
    _legs(lambda a: _run_ref(ref_explore, a, monkeypatch), legs, argv + ["--out", ref],
          str(tmp_path / "r"))
    assert _header(ours) == _header(ref)
    got, want = _rows(ours), _rows(ref)
    assert sorted(got) == sorted(want) == list(range(20))
    assert got == want
    if flag == "chaos-crash-at":
        assert res.resume["n_events"] > 0 and res.resume["n_ask_mismatch"] == 0
    if flag == "chaos-drop":
        assert res.chaos_stats["dropped"] == 1
    if flag == "fleet-cache":
        assert res.fleet_stats["fleet_hits"] > 0
        assert res.timings["builds"] == res.fleet_stats["fleet_misses"]


def test_crash_exits_42_and_resumes(tmp_path):
    """The real crash: ``--chaos-crash-at`` ends the explore process with
    exit code 42 (the real build, reduced); ``--resume`` finishes the sweep
    with zero duplicates and the uninterrupted sweep's rows."""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    argv = [sys.executable, "-m", "repro_torch.launch.explore", "--workload", "llama2-7b",
            "--reduced", "--samples", "12", "--algorithm", "bayesopt", "--gp", "incremental",
            "--clients", "1", "--prompt-len", "8", "--gen-tokens", "4", "--seed", "5",
            "--batch-size", "4", "--checkpoint-every", "6",
            "--cache-dir", str(tmp_path / "cache")]

    def run(extra, rc):
        out = subprocess.run(argv + extra, env=env, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == rc, out.stdout + out.stderr
        return out.stdout

    u, c = str(tmp_path / "u.csv"), str(tmp_path / "c.csv")
    run(["--out", u, "--checkpoint-dir", str(tmp_path / "u_ck")], 0)
    run(["--out", c, "--checkpoint-dir", str(tmp_path / "c_ck"), "--chaos-crash-at", "7"], 42)
    assert "# resume:" in run(["--out", c, "--checkpoint-dir", str(tmp_path / "c_ck"),
                               "--resume"], 0)
    with open(c) as f:
        ids = [r["config_id"] for r in csv.DictReader(f)]
    assert len(ids) == len(set(ids)) == 12
    assert _rows(c) == _rows(u)


def test_train_shape_raises_in_the_build(tmp_path):
    """The train cells are counted now (``launch.build``): the reduced
    train_4k sweep of the paper's command runs end to end, every record ok,
    each build a counted train step with its optimizer."""
    res = explore.run(["--workload", "llama2-7b", "--reduced", "--shape", "train_4k",
                       "--algorithm", "bayesopt", "--gp", "incremental",
                       "--samples", "14", "--clients", "2", "--chips", "8",
                       "--out", str(tmp_path / "x.csv")])
    assert len(res.store.records) == 14
    assert all(r.status == "ok" for r in res.store.records)
    assert res.timings["builds"] >= 1
    for r in res.store.records:
        assert r.metrics["time_s"] > 0 and r.metrics["power_w"] > 0


@pytest.mark.parametrize("algo", ["random", "bayesopt"])
def test_train_4k_csv_equals_the_reference(algo, ref_explore, stub_port, monkeypatch,
                                           tmp_path):
    """The train_4k space (``tpu_pod_space`` at 8 chips: dp, fsdp,
    microbatch, remat, sp, grad_rs, loss_chunks, the attention tiles) on the
    shared stub build: the reference's CSV."""
    argv = BASE + ["--shape", "train_4k", "--chips", "8", "--algorithm", algo,
                   "--samples", "20", "--clients", "1", "--gp", "incremental"]
    ours, ref = str(tmp_path / "port.csv"), str(tmp_path / "ref.csv")
    explore.main(argv + ["--out", ours])
    _run_ref(ref_explore, argv + ["--out", ref], monkeypatch)
    assert _header(ours) == _header(ref)
    assert "knob.grad_rs" in _header(ours) and "knob.remat" in _header(ours)
    got, want = _rows(ours), _rows(ref)
    assert sorted(got) == list(range(20)) and got == want


def test_explore_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert explore.parse_args([]).gp == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        explore.main(BASE + ["--algorithm", "bayesopt", "--out", str(tmp_path / "x.csv")])


@pytest.mark.cuda
def test_cuda_tier_gives_the_incremental_sweep_on_the_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; PyTorch sees none")
    from repro_torch.kernels import gp_ops

    monkeypatch.setitem(ALGORITHMS, "bayesopt", functools.partial(BayesOpt, strategy="ehvi"))
    argv = ["--workload", "llama2-7b", "--reduced", "--algorithm", "bayesopt",
            "--samples", "24", "--clients", "1", "--seed", "0"]
    before = (gp_ops.gp_w.launches, gp_ops.gp_g.launches, gp_ops.gp_ehvi.launches)
    res = explore.run(argv + ["--gp", "cuda", "--out", str(tmp_path / "cuda.csv")])
    stats = res.algo._gp.stats()
    assert (gp_ops.gp_w.launches - before[0] == gp_ops.gp_g.launches - before[1]
            == stats["cuda_appends"] > 0)
    assert gp_ops.gp_ehvi.launches - before[2] == stats["cuda_scores"] > 0
    explore.main(argv + ["--gp", "incremental", "--out", str(tmp_path / "inc.csv")])
    assert _rows(str(tmp_path / "cuda.csv")) == _rows(str(tmp_path / "inc.csv"))
