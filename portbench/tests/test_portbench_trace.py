"""Attribution on synthetic profiler records (kernels that run long after
their launch, launch records on another clock, marker launches), and the
span readers on a tiny CPU run."""
import time

import numpy as np
import pytest
import torch

from portbench import attribution
from portbench.harness import BENCH, Run, kernel_kind, reader
from portbench.tests._tiny import bench, config, overrides

OFF = 1_700_000_000_000_000_123      # the trace's clock minus the spans' clock
MS = 1_000_000


def _span(name, s, e, arg=None):
    return (name, s * MS, e * MS, arg)


def _record():
    """A profiled span [0, 100] ms of two steps: an admission with a prefill
    (two attention layers, each launching K3) and a decode step, then a
    decode step alone.  Each kernel runs 5 ms after its launch; one launch
    falls outside every span."""
    spans = [
        _span("serve.step", 1, 60, 2), _span("serve.admit", 2, 40, (0, 100)),
        _span("model.prefill", 3, 30, 100), _span("layer.attn", 4, 10, 0),
        _span("layer.attn", 12, 20, 1), _span("serve.first_token", 31, 39),
        _span("model.decode_step", 41, 50, 2), _span("layer.attn", 42, 46, 0),
        _span("serve.sample", 51, 59),
        _span("serve.step", 62, 95, 2), _span("model.decode_step", 63, 80, 2),
        _span("layer.attn", 64, 70, 0), _span("serve.sample", 81, 94),
    ]
    launches = {}
    device = []

    def kernel(name, host_ms, run_ms, corr):
        launches[corr] = (int(host_ms * MS) + OFF, "cudaLaunchKernel")
        t = int((host_ms + 5) * MS) + OFF
        device.append((name, t, t + int(run_ms * MS), corr))

    kernel("flash_fwd_bf16", 5, 4, 1)          # layer.attn 0 of the prefill
    kernel("gemm", 8, 6, 2)                    # layer.attn 0, runs past the span's end
    kernel("flash_fwd_bf16", 13, 4, 3)         # layer.attn 1
    kernel("elementwise_kernel", 43, 3, 4)     # decode attention
    kernel("gemm", 47, 2, 5)                   # decode_step, outside its layer
    kernel("memcpy DtoH", 52, 1, 6)            # serve.sample
    kernel("elementwise_kernel", 65, 10, 7)    # second decode attention
    kernel("fill", 96, 1, 8)                   # launched outside every span
    markers = []
    for corr, at in ((100, 0.5), (101, 99.5)):  # marker launches, bracketed by 20 us
        t0 = int(at * MS)
        markers.append((t0, t0 + 20_000))
        launches[corr] = (t0 + 7_000 + OFF, "cudaLaunchKernel")
        device.append(("spin_kernel(long)", t0 + 9_000 + OFF, t0 + 11_000 + OFF, corr))
    return spans, device, launches, markers


def _attribute(spans, device, launches, markers):
    return attribution.attribute(spans, device, launches, markers, OFF + 40 * MS, 0.0, 0.1,
                                 kernel_kind, lambda *a: None)


def _run(att, spans=(), counters=(), trace=True):
    run = Run("dsmoe16b.chat", config("dsmoe16b"), {}, setup_s=1.0, t0=0.0, t1=0.1)
    run.spans, run.counters = list(spans), list(counters)
    if trace:
        run.trace = {"start": 0.0, "stop": 0.1, "window_s": 0.1, "busy_s": 0.05,
                     "attribution": att}
    return run


def test_launch_join_and_measured_offset():
    att = _attribute(*_record())
    assert abs(att["offset_ns"] - OFF) <= 10_000 and att["bracket_ns"] == 20_000
    by = att["device_by_path"]
    assert by["serve.step/serve.admit/model.prefill/layer.attn"] == pytest.approx(0.014)
    assert by["serve.step/model.decode_step/layer.attn"] == pytest.approx(0.013)
    assert by["serve.step/model.decode_step"] == pytest.approx(0.002)
    assert by["serve.step/serve.sample"] == pytest.approx(0.001)
    assert by[attribution.OUTSIDE] == pytest.approx(0.001)
    assert att["prefills"] == [[100, 2, 0]] and att["decode_steps"] == 2
    assert att["launched_outside"] == 1 and att["no_launch"] == att["stray_kernels"] == 0
    run = _run(att)
    assert reader("decode_device_ms.chat")(run) == pytest.approx(7.5)
    assert reader("decode_attn_device_ms.chat")(run) == pytest.approx(6.5)
    assert reader("prefill_device_ms_per_ktok.longdoc")(run) == pytest.approx(140.0)
    assert att["ops_by_span"][:2] == [["layer.attn", "elementwise_kernel", pytest.approx(0.013)],
                                      ["layer.attn", "flash_fwd_bf16", pytest.approx(0.008)]]
    inner = attribution.by_innermost(by)
    assert inner["layer.attn"] == pytest.approx(0.027) and list(inner)[0] == "layer.attn"


def test_idle_by_span_sums_to_the_idle_time_and_cuts_gaps_by_the_host():
    """On the spans' clock (the measured offset puts the device 3 us late)
    the device is busy over 10-22, 48-51, 52-54, 57-58 and 70-80 ms and
    4 us of markers; every idle instant goes to the innermost span then."""
    att = _attribute(*_record())
    idle = att["idle_by_path"]
    assert att["idle_s"] == pytest.approx(0.1 - 0.028 - 4e-6, abs=1e-12)
    assert sum(idle.values()) == pytest.approx(att["idle_s"], abs=1e-12)
    assert idle["serve.step/serve.admit/model.prefill"] == pytest.approx(0.009, abs=1e-12)
    assert idle["serve.step/serve.admit/model.prefill/layer.attn"] == pytest.approx(0.006)
    assert idle["serve.step/serve.admit"] == pytest.approx(0.003)
    assert idle["serve.step/serve.admit/serve.first_token"] == pytest.approx(0.008)
    assert idle[attribution.OUTSIDE] == pytest.approx(0.007996, abs=1e-12)
    dispatch = attribution.under(idle, "model.decode_step")
    assert dispatch == pytest.approx(0.014006, abs=1e-12)
    run = _run(att)
    assert reader("device_idle_dispatch_share.chat")(run) == pytest.approx(100 * dispatch / 0.1)
    assert reader("device_idle_admit_share.longdoc")(run) == pytest.approx(100 * 0.026 / 0.1)


@pytest.mark.parametrize("fault", ["outside", "no_launch"])
def test_an_unattributed_kernel_leaves_the_device_readers_empty(fault):
    spans, device, launches, markers = _record()
    if fault == "outside":                     # a K3 launched outside every span
        launches[9] = (97 * MS + OFF, "cudaLaunchKernel")
    t = 98 * MS + OFF
    device.append(("flash_fwd_bf16", t, t + MS, 9))
    att = _attribute(spans, device, launches, markers)
    assert (att["stray_kernels"], att["no_launch"]) == ((1, 0) if fault == "outside" else (1, 1))
    assert att["launched_outside"] == (2 if fault == "outside" else 1)
    run = _run(att)
    for name in ("decode_device_ms.chat", "decode_attn_device_ms.chat",
                 "device_idle_dispatch_share.chat", "device_idle_admit_share.longdoc",
                 "prefill_device_ms_per_ktok.longdoc"):
        assert reader(name)(run) is None


def test_a_lost_marker_leaves_the_other_and_lost_launches_are_counted():
    spans, device, launches, markers = _record()
    launches[50] = (30 * MS + OFF, "cudaLaunchKernel")          # its kernel is not in the trace
    launches[51] = (31 * MS + OFF, "cudaStreamSynchronize")     # puts no work on the device
    launches[52] = (130 * MS + OFF, "cudaMemcpyAsync")          # after the profiled span
    first = [ev for ev in device if ev[3] != 100]               # the first marker's kernel lost
    att = _attribute(spans, first, launches, markers)
    assert abs(att["offset_ns"] - OFF) <= 10_000
    assert att["lost"] == {"cudaLaunchKernel": 2}
    with pytest.raises(RuntimeError, match="no offset"):
        _attribute(spans, [ev for ev in first if ev[3] != 101], launches, markers)


def test_under_follows_the_order_of_names():
    by = {"a/b/c": 1.0, "a/c/b": 2.0, "b": 4.0}
    assert attribution.under(by, "b", "c") == 1.0
    assert attribution.under(by, "b") == 7.0
    assert attribution.under(by, "a", "c") == 3.0


def test_host_readers_take_the_window_before_the_profiled_span():
    spans = [_span("model.decode_step", 10, 20), _span("layer.ffn", 11, 19),
             _span("k5", 12, 12.05), _span("k5", 30, 30.09),           # not under decode
             _span("model.decode_step", 40, 44), _span("layer.ffn", 41, 43),
             _span("k5", 42, 42.03),
             _span("model.decode_step", 80, 99), _span("k5", 81, 82)]  # profiled span
    counters = [("serve.kv_used", 15 * MS, 30), ("serve.kv_reserved", 15 * MS, 100),
                ("serve.kv_used", 45 * MS, 50), ("serve.kv_reserved", 45 * MS, 100),
                ("serve.kv_used", 200 * MS, 99), ("serve.kv_reserved", 200 * MS, 100)]
    run = _run(None, spans, counters)
    run.trace["start"] = 0.07
    assert reader("decode_host_ms.chat")(run) == pytest.approx(7.0)
    assert reader("k5_host_us.chat")(run) == pytest.approx(40.0)
    assert reader("kv_used_share.chat")(run) == pytest.approx(40.0)
    plain = _run(None, spans, counters, trace=False)
    assert reader("decode_host_ms.chat")(plain) == pytest.approx((10 + 4 + 19) / 3)
    assert reader("k5_host_us.chat")(plain) == pytest.approx((50 + 30 + 1000) / 3)


@pytest.fixture
def traced(monkeypatch):
    monkeypatch.syspath_prepend(str(BENCH))
    import traced

    return traced


@pytest.mark.parametrize("cell", ["dsmoe16b.chat", "mamba2.longdoc"])
def test_host_readers_read_a_tiny_cpu_run(traced, cell):
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res, run = traced.run_with_spans(bench(), cell, 2**32 + 9, 2.0, False, True,
                                         device=torch.device("cpu"),
                                         t_process=time.perf_counter(), overrides=overrides(cell),
                                         log=lambda *a: None)
    finally:
        torch.set_num_threads(before)
    names = {s[0] for s in run.spans}
    assert {"serve.step", "serve.admit", "model.prefill", "model.decode_step"} <= names
    out = traced.summary(res, run)["spans"]
    assert out["decode_host_ms.chat"]["value"] > 0
    assert 0 < out["kv_used_share.chat"]["value"] < 100
    assert "k5_host_us.chat" not in out         # K5's span is its CUDA path's
    assert "decode_device_ms.chat" not in out and "attribution" not in traced.summary(res, run)
    steps = run.window_steps()
    used = [v for n, t, v in run.counters if n == "serve.kv_used" and run.t0 * 1e9 <= t <= run.t1 * 1e9]
    assert len(used) == len(steps)
    res, run = traced.run_with_spans(bench(), cell, 2**32 + 9, 0.5, False, False,
                                     device=torch.device("cpu"), t_process=time.perf_counter(),
                                     overrides=overrides(cell), log=lambda *a: None)
    assert run.spans == [] and traced.summary(res, run)["spans"] == {}


def test_span_cost_loop(traced):
    out = traced.span_cost(n=1000)
    assert set(out) == {"empty_ns", "off_ns", "on_ns"}
    assert np.isfinite(list(out.values())).all()
