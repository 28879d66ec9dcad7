"""The metric arithmetic on synthetic records: rates over the whole
window, percentiles over all gaps, time to first token from submission."""
import importlib.util

import numpy as np
import pytest

from portbench import readings
from portbench.harness import BENCH, Req, Run, cell_metrics, reader
from portbench.stats import gaps, percentile, union_seconds
from portbench.tests._tiny import bench, config


def _run(stall=0.0):
    """Two requests over a window [0, 10]: steps of 0.1 s, one step made
    longer by ``stall``."""
    run = Run("dsmoe16b.chat", config("dsmoe16b"), {}, setup_s=5.0, t0=0.0)
    t, times = 0.0, []
    for i in range(100):
        start = t
        t += 0.1 + (stall if i == 50 else 0.0)
        run.steps.append((start, t, 2, 1 if i in (0, 60) else 0))
        times.append(t)
    run.t1 = t
    a = Req(0, np.zeros(10, np.int32), 101, submit=-0.05)
    a.times = [times[0]] + times[:]            # first two tokens in one step
    b = Req(1, np.zeros(20, np.int32), 40, submit=times[59])
    b.times = [times[60]] + times[60:]
    run.requests = {0: a, 1: b}
    return run


def test_rate_over_the_whole_window():
    run = _run()
    assert reader("gen_tokens_per_s")(run) == pytest.approx((101 + 41) / run.t1)
    stalled = _run(stall=2.0)
    assert reader("gen_tokens_per_s")(stalled) == pytest.approx((101 + 41) / (run.t1 + 2.0))


def test_gaps_are_between_deliveries_and_a_stall_moves_the_p95():
    run = _run()
    g = readings.token_gaps(run)
    assert len(g) == 99 + 39 and min(g) == pytest.approx(0.1)
    base = reader("itl_ms_p95")(run)
    assert base == pytest.approx(100.0)
    # one stalled step is under 5 % of the gaps; every tenth gap stalled is not
    assert reader("itl_ms_p95")(_run(stall=0.5)) == pytest.approx(100.0)
    many = _run()
    for q in many.requests.values():           # every tenth gap stalled by 0.3 s
        q.times = [t + 0.3 * (i // 10) for i, t in enumerate(q.times)]
    many.t1 += 10.0
    assert reader("itl_ms_p95")(many) > base + 250


def test_itl_modes_and_window_summary():
    run = _run()
    assert "steps admitting 0/1/2+ 0.9800/0.0200/0.0000" in readings.itl_modes(run)
    assert readings.window_summary(run).startswith("window: 100 steps, 100.000 ms a step")


def test_ttft_from_submission_over_requests_submitted_in_the_window():
    run = _run()
    assert readings.ttfts(run) == pytest.approx([run.requests[1].times[0] - run.requests[1].submit])
    assert reader("ttft_ms_p95")(run) == pytest.approx(100.0)
    assert reader("ttft_ms_p95.chat")(run) == pytest.approx(100.0)


def test_occupancy_setup_and_mfu():
    run = _run()
    assert reader("slot_occupancy.chat")(run) == 2.0
    assert reader("setup_s")(run) == 5.0
    run.prefills = [(1.0, 1.2, 20, 1)]
    run.decodes = [(2.0, 2.05, [30, 40])]
    want = (readings.flops.prefill_flops(run.cfg, 20) + readings.flops.decode_flops(run.cfg, 30)
            + readings.flops.decode_flops(run.cfg, 40))
    assert reader("mfu.chat")(run) == pytest.approx(100 * want / (run.t1 * 989e12))
    assert reader("decode_step_ms.chat")(run) == pytest.approx(50.0)
    assert reader("prefill_ms_per_ktok.longdoc")(run) == pytest.approx(200.0 / 0.02)


def test_trace_readers_read_nothing_without_a_trace_or_a_kernel():
    run = _run()
    for name in ("k3_roofline.longdoc", "k4_roofline.longdoc", "device_idle_share.chat"):
        assert reader(name)(run) is None
    run.trace = {"busy_s": 1.0, "window_s": 4.0, "kernel_events": {"k3": 3, "k4": 0},
                 "kernel_s": {"k3": 0.5, "k4": 0.0}, "bound_s": {"k3": 0.1, "k4": 0.0}}
    assert reader("device_idle_share.longdoc")(run) == pytest.approx(75.0)
    assert reader("k3_roofline.longdoc")(run) == pytest.approx(20.0)
    assert reader("k4_roofline.longdoc")(run) is None


def _traced(per_call, drop=0):
    """A profiled span [0, 1] s of two prefills, each of 3 K4 calls that
    launch ``per_call`` kernels a call; ``drop`` events are lost."""
    cfg = config("mamba2")
    run = Run("mamba2.longdoc", cfg, {}, setup_s=1.0, t0=0.0, t1=1.0)
    events = []
    for i, (s0, s1) in enumerate(((0.1, 0.4), (0.5, 0.9))):
        run.prefills.append((s0, s1, 40, i))
        for j in range(3 * per_call):
            t = int((s0 + 0.01 * (j + 1)) * 1e9)
            events.append(("ssd_chunk_kernel<64>", t, t + 1000))
    events.append(("gemm", int(0.45e9), int(0.46e9)))
    return run, events[drop:]


@pytest.mark.parametrize("per_call", [1, 3])
def test_trace_cross_check_holds_the_events_to_the_launches(per_call):
    """However many kernels a call launches, a trace that holds them all
    passes, and one that lost some, or holds kernels no call launched,
    fails."""
    from portbench.harness import summarize_trace

    counts = ({"k3": 0, "k4": 10}, {"k3": 0, "k4": 16})
    quiet = dict(log=lambda *a: None)
    run, events = _traced(per_call)
    out = summarize_trace(run, events, 0.0, 1.0, 0, *counts, **quiet)
    assert out["kernel_events"]["k4"] == 6 * per_call and out["busy_s"] > 0
    assert out["bound_s"]["k4"] > 0 and out["breakdown"]["idle_gaps"][0][0] == "prefill"
    run, events = _traced(per_call, drop=1)
    with pytest.raises(RuntimeError, match="dropped launches"):
        summarize_trace(run, events, 0.0, 1.0, 0, *counts, **quiet)
    run, events = _traced(per_call)
    with pytest.raises(RuntimeError, match="dropped launches"):
        summarize_trace(run, events, 0.0, 1.0, 0, counts[0], {"k3": 0, "k4": 17}, **quiet)
    with pytest.raises(RuntimeError, match="dropped launches"):
        summarize_trace(run, events, 0.0, 1.0, 0, counts[0], counts[0], **quiet)


def test_stats():
    assert union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert gaps([(1, 2), (4, 5)], 0, 6) == [(2, 4), (0, 1), (5, 6)]
    assert percentile([], 95) is None and percentile([1, 2, 3], 50) == 2


def test_every_metric_has_a_reader_and_every_cell_its_metrics():
    b = bench()
    for m in b["end_to_end"] + b["per_layer"]:
        spec = importlib.util.spec_from_file_location("m", BENCH / "metrics" / f"{m['name']}.py")
        assert spec is not None, m["name"]
        reader(m["name"])
    for w in b["workloads"]:
        e2e, layer = cell_metrics(b, w["name"], False), cell_metrics(b, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for name in layer:
            moves = next(m["moves"] for m in b["per_layer"] if m["name"] == name)
            assert moves in e2e
