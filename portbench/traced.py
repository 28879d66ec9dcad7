"""Runs of one cell with the port's spans and counters on, and each device
event put down to the span that launched it.

    python3 portbench/traced.py --workload <name> --seeds 11,12 --seconds <s> --trace <0|1> \
        [--spans 1|0|1,0,...]
    python3 portbench/traced.py --span-cost

Each seed is one run as ``run.py`` makes it (``harness.run_cell``), with two
additions.  The port's tracing (``repro_torch.trace``) is turned on by the
hook ``run_cell`` calls just before the window opens (``--spans`` 1, one
value for all seeds or one a seed; 0 leaves it off, for the cost of the
spans themselves).  With ``--trace 1`` the profiled span also keeps the
profiler's launch records and two marker launches, so that ``attribution``
ties every device event to its launch and cuts every idle gap by the span
the host was in.  One JSON line a run: what ``run.py`` prints, and under
``spans`` the readings of ``METRICS`` (``metrics/<name>.py``), under
``attribution`` the clock offset, what could not be attributed, and device
and idle seconds by innermost span.

``--span-cost`` times a disabled span (``with trace.span(...)``) and an
enabled one in loops of 10**6, against the empty loop.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import CHECKOUT, environment  # noqa: E402

METRICS = {"decode_device_ms.chat": "ms", "decode_attn_device_ms.chat": "ms",
           "decode_host_ms.chat": "ms", "device_idle_dispatch_share.chat": "%",
           "device_idle_admit_share.longdoc": "%", "prefill_device_ms_per_ktok.longdoc": "ms/ktok",
           "k5_host_us.chat": "us", "kv_used_share.chat": "%"}


def launch_profiler():
    """``harness._Profiler`` that also keeps the launch records, with a
    marker launch at each end of the profiled span to tie the clocks."""
    import torch
    from torch.autograd import DeviceType

    from portbench import attribution, harness
    from repro_torch import trace

    def marker():
        t0 = time.perf_counter_ns()
        torch.cuda._sleep(1)
        return t0, time.perf_counter_ns()

    class LaunchProfiler(harness._Profiler):
        def __init__(self, sync, log):
            super().__init__(sync, log)
            marker()                                  # the marker kernel's first load, in set-up
            sync()
            self.markers = []

        def boundary(self, now, run, seconds):
            opening = self.prof is None
            super().boundary(now, run, seconds)
            if opening and self.prof is not None:
                self.markers.append(marker())

        def close(self, run):
            if self.prof is not None:
                self.markers.append(marker())
            super().close(run)
            trace.disable()
            run.spans, run.counters = trace.drain()
            device, launches = [], {}
            for e in self.prof.profiler.kineto_results.events():
                corr = e.correlation_id()
                if e.device_type() == DeviceType.CUDA:
                    device.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), corr))
                elif corr and (corr not in launches or e.start_ns() < launches[corr][0]):
                    launches[corr] = (e.start_ns(), e.name())
            att = attribution.attribute(run.spans, device, launches, self.markers, self.epoch,
                                        self.start, self.stop, harness.kernel_kind, self.log)
            run.trace["attribution"] = att
            run.trace["breakdown"]["device_by_span"] = attribution.by_innermost(att["device_by_path"])
            run.trace["breakdown"]["idle_by_span"] = attribution.by_innermost(att["idle_by_path"])
            run.trace["breakdown"]["ops_by_span"] = [[span, name[:harness.NAME_CHARS], secs]
                                                     for span, name, secs in att["ops_by_span"]]

    return LaunchProfiler


def run_with_spans(bench, cell, seed, seconds, trace_on, spans_on, *, device, t_process,
                   overrides=None, log=None):
    """``harness.run_cell`` with the port's spans on (``spans_on``); returns
    (its result, the run's records)."""
    from portbench import harness
    from repro_torch import trace

    box = {}

    def before_window(server, model):
        box["run"] = server.step.__self__.run        # the harness's recorder of the run
        if spans_on:
            trace.enable()

    profiler = harness._Profiler
    if trace_on and device.type == "cuda":
        harness._Profiler = launch_profiler()
    try:
        result = harness.run_cell(bench, cell, seed, seconds, trace_on, device=device,
                                  t_process=t_process, overrides=overrides, fault=before_window,
                                  log=log)
    finally:
        harness._Profiler = profiler
        trace.disable()
    run = box["run"]
    if not hasattr(run, "spans"):
        run.spans, run.counters = trace.drain()
    return result, run


def summary(result, run) -> dict:
    from portbench.harness import reader

    steps = run.window_steps()
    out = {"correct": result["correct"], "attempted": result["attempted"],
           "failed": result["failed"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "ms_per_step": 1e3 * (run.t1 - run.t0) / max(len(steps), 1),
           "memory_peak_bytes": result["device"]["memory_peak_bytes"],
           "spans": {}, "checks": result["checks"]}
    for name, unit in METRICS.items():
        value = reader(name)(run)
        if value is not None:
            out["spans"][name] = {"value": value, "unit": unit}
    att = (run.trace or {}).get("attribution")
    if att is not None:
        k3 = sorted({p[1] for p in att["prefills"]})
        k4 = sorted({p[2] for p in att["prefills"]})
        out["attribution"] = {
            **{k: att[k] for k in ("offset_ns", "bracket_ns", "events", "no_launch",
                                   "launched_outside", "stray_kernels", "lost", "decode_steps")},
            "prefills": len(att["prefills"]), "k3_per_prefill": k3, "k4_per_prefill": k4,
            "idle_s": att["idle_s"], "idle_s_of_the_share": run.trace["window_s"]
            - run.trace["busy_s"], "idle_by_span": result["breakdown"]["idle_by_span"],
            "device_by_span": result["breakdown"]["device_by_span"],
            "ops_by_span": result["breakdown"]["ops_by_span"],
            "device_by_path": dict(sorted(att["device_by_path"].items(), key=lambda kv: -kv[1])),
            "idle_by_path": dict(sorted(att["idle_by_path"].items(), key=lambda kv: -kv[1]))}
        out["breakdown"] = {k: result["breakdown"][k] for k in ("device_ops", "idle_gaps")}
    return out


def span_cost(n=10**6) -> dict:
    from repro_torch import trace

    def loop(body):
        t = time.perf_counter_ns()
        for _ in range(n):
            body()
        return (time.perf_counter_ns() - t) / n

    def one():
        with trace.span("layer.attn", 3):
            pass

    out = {"empty_ns": loop(lambda: None)}
    trace.disable()
    out["off_ns"] = loop(one) - out["empty_ns"]
    trace.enable()
    out["on_ns"] = loop(one) - out["empty_ns"]
    trace.disable()
    trace.drain()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seeds")
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--spans", default="1")
    ap.add_argument("--span-cost", action="store_true")
    args = ap.parse_args(argv)
    environment()
    if args.span_cost:
        print(json.dumps({"span_cost": span_cost()}), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    seeds = [int(s) for s in args.seeds.split(",")]
    spans = [bool(int(s)) for s in args.spans.split(",")]
    spans = spans * len(seeds) if len(spans) == 1 else spans
    if len(spans) != len(seeds):
        ap.error("--spans takes one value, or one a seed")
    t = T_PROCESS
    for seed, on in zip(seeds, spans):
        result, run = run_with_spans(bench, args.workload, seed, args.seconds, bool(args.trace),
                                     on, device=torch.device("cuda", 0), t_process=t)
        print(json.dumps({"workload": args.workload, "seed": seed, "spans_on": on,
                          "trace": args.trace, **summary(result, run)}), flush=True)
        del result, run
        gc.unfreeze()                                # run_cell froze this run's set-up
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
