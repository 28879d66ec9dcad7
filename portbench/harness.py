"""One run of one cell: the served model, its closed-loop traffic, the
measured window, the records the metrics read, and the check.

The timed path is the port's ``serve.kv_cache.SlotServer`` over
``models.model.Model``.  The harness wraps four calls on the instances
(``SlotServer.submit``/``step``, ``Model.prefill``/``decode_step``) to
record spans and counts; nothing of the port is edited.  Tokens reach the
client when ``step()`` returns, so each token is stamped with the end of
the step that produced it.

Set-up builds the model, fills its weights from the seed, warms the
cell's shapes (prefills at eight prompt lengths across the mix, the
longest among them), fills every slot
and staggers the slots' progress (``Traffic.in_flight``): each slot starts
with what a steady state would leave in it, so the requests' ends spread
over the window.  The window then runs
``seconds`` of whole steps; each client sends its next request as soon as
its last one ends.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from portbench import flops
from portbench.readings import itl_modes, window_summary
from portbench.traffic import Traffic, load_mix

BENCH = Path(__file__).resolve().parent
KERNELS = ("flash_attention", "ssd_scan", "topk_gating")
K3_NAMES = ("flash_fwd_",)
K4_NAMES = ("ssd_chunk_kernel", "ssd_state_kernel")
TRACE_SPAN_S = 6.0       # the profiled span: the window's last seconds
NAME_CHARS = 160         # a kernel's name in the breakdown, cut to this length
LATE_S = 60.0            # how long past the window a request's first token is awaited


@dataclasses.dataclass
class Req:
    rid: int
    prompt: np.ndarray
    max_new: int
    submit: float
    prefill_start: Optional[float] = None
    prefill_end: Optional[float] = None
    ended: Optional[float] = None                     # when the server finished it
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


@dataclasses.dataclass
class Run:
    """What one run recorded, for the metric readers."""
    cell: str
    cfg: dict
    spec: dict
    setup_s: float
    t0: float = 0.0                                   # window start (host clock, s)
    t1: float = 0.0                                   # window end
    requests: Dict[int, Req] = dataclasses.field(default_factory=dict)
    steps: List[tuple] = dataclasses.field(default_factory=list)     # (start, end, busy, admitted)
    prefills: List[tuple] = dataclasses.field(default_factory=list)  # (start, end, plen, rid)
    decodes: List[tuple] = dataclasses.field(default_factory=list)   # (start, end, positions)
    trace: Optional[dict] = None

    def window_steps(self):
        return [s for s in self.steps if self.t0 <= s[0] and s[1] <= self.t1]

    def in_window(self, t: float) -> bool:
        return self.t0 <= t <= self.t1


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def port_arch(cfg: dict):
    """The port's ``ArchConfig`` with the configuration file's sizes."""
    from repro_torch.configs.base import ArchConfig, LayerSpec

    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {k: v for k, v in cfg.items() if k in fields and k != "pattern"}
    kw["pattern"] = tuple(LayerSpec(mixer=m, ffn=f) for m, f in cfg["pattern"])
    return ArchConfig(**kw)


def reader(name: str) -> Callable:
    """``read(run)`` of metric ``name``, from ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def launch_counts() -> dict:
    """The port's K3 and K4 launch counters."""
    from repro_torch.kernels import flash_attention, ssd_scan

    return {"k3": flash_attention.flash_attention.launches, "k4": ssd_scan.ssd_scan.launches}


class Recorder:
    """Wraps the four calls and keeps the run's records."""

    def __init__(self, run: Run, server, model, sync: Callable, trace: bool):
        self.run, self.server, self.model, self.sync, self.trace = run, server, model, sync, trace
        self.pending: List[int] = []          # submitted, not yet prefilled (FIFO)
        self.admitted = 0
        self._submit, self._step = server.submit, server.step
        self._prefill, self._decode = model.prefill, model.decode_step
        server.submit, server.step = self.submit, self.step
        model.prefill, model.decode_step = self.prefill, self.decode_step
        self._seen_finished = 0
        self.just_finished: List[int] = []

    def detach(self):
        """Hand the four calls back to the instances."""
        for obj, names in ((self.server, ("submit", "step")),
                           (self.model, ("prefill", "decode_step"))):
            for name in names:
                obj.__dict__.pop(name, None)

    def submit(self, rid, tokens, max_new):
        self.run.requests[rid] = Req(rid, np.asarray(tokens, np.int32), int(max_new),
                                     time.perf_counter())
        self.pending.append(rid)
        return self._submit(rid, tokens, max_new)

    def prefill(self, batch):
        t = time.perf_counter()
        rid = self.pending.pop(0)
        req = self.run.requests[rid]
        if batch["tokens"].shape[-1] != req.prompt_len:
            raise RuntimeError(f"prefill of {batch['tokens'].shape[-1]} tokens where request "
                               f"{rid} has {req.prompt_len}")
        out = self._prefill(batch)
        if self.trace:
            self.sync()
        end = time.perf_counter()
        req.prefill_start, req.prefill_end = t, end
        self.run.prefills.append((t, end, req.prompt_len, rid))
        self.admitted += 1
        return out

    def decode_step(self, tokens, caches, pos):
        server = self.server
        positions = [int(server.pos[s]) for s in range(server.n_slots)
                     if server.active[s] is not None]
        t = time.perf_counter()
        out = self._decode(tokens, caches, pos)
        if self.trace:
            self.sync()
        self.run.decodes.append((t, time.perf_counter(), positions))
        return out

    def step(self):
        self.admitted = 0
        t = time.perf_counter()
        busy = self._step()
        end = time.perf_counter()
        self.run.steps.append((t, end, busy, self.admitted))
        self._stamp(end)
        return busy

    def _stamp(self, at: float):
        """Stamp the tokens the last step produced and the requests it finished."""
        server = self.server
        seen = [r for r in server.active if r is not None]
        done = server.finished[self._seen_finished:]
        self._seen_finished = len(server.finished)
        for r in seen + done:
            req = self.run.requests[r.rid]
            new = r.out[len(req.tokens):]
            req.tokens.extend(int(t) for t in new)
            req.times.extend([at] * len(new))
        for r in done:
            self.run.requests[r.rid].ended = at
        self.just_finished = [r.rid for r in done]


def cell_spec(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """Names of the metrics the cell reports: its end-to-end metrics, or
    with ``trace`` its per-layer metrics."""
    e2e = [m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    return [m["name"] for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool, *,
             device, t_process: float, overrides: Optional[dict] = None,
             fault: Optional[Callable] = None, control: bool = False, log=None) -> dict:
    """One run; returns the result line's object.  For the tests:
    ``overrides`` replaces keys of the configuration, the mix and the
    limits (``{"config": {...}, "traffic": {...}, "limits": {...}}``), and
    ``fault`` is called with (server, model) before the window to break
    the timed path."""
    import torch

    from repro_torch.models.model import BuildFlags, Model
    from repro_torch.serve.kv_cache import SlotServer

    from portbench import check, weights
    from portbench.reference.common import strict_fp32

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))

    def phase(name):
        log(f"set-up {name} at {time.perf_counter() - t_process:.3f} s")
    w = cell_spec(bench, cell)
    cfg = load_json(BENCH / "configs" / f"{w['config']}.json")
    overrides = overrides or {}
    cfg.update(overrides.get("config", {}))
    spec = load_mix(w["traffic"], w["config"])
    spec.update(overrides.get("traffic", {}))
    strict_fp32()
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    build_s = 0.0
    if cuda:
        from repro_torch.kernels import build
        t_build = time.perf_counter()
        build.build_all(KERNELS)
        build_s = time.perf_counter() - t_build         # nvcc on a checkout's first run
        phase(f"kernels built ({build_s:.3f} s)")
        torch.cuda.reset_peak_memory_stats()
    arch = port_arch(cfg)
    flags = BuildFlags(dtype=cfg["dtype"], attn_impl=cfg["attn_impl"], ssd_impl=cfg["ssd_impl"])
    model = Model(arch, flags, device=device, seed=None)
    phase("model allocated")
    params = weights.fill(model, seed)
    sync()
    phase("weights drawn")
    traffic = Traffic(spec, seed, arch.vocab_size)
    slots, max_len = int(spec["slots"]), int(spec["max_len"])

    with torch.inference_mode():                       # prefill shapes across the mix
        for plen in traffic.warm_lengths():
            model.prefill({"tokens": traffic.request(0)[0][:1].repeat(plen)[None, :]})
    sync()
    phase("prompt lengths warmed")
    run = Run(cell, cfg, spec, setup_s=0.0)
    server = SlotServer(model, slots, max_len)
    rec = Recorder(run, server, model, sync, trace)
    next_i = 0
    for j in range(slots):                             # fill and stagger the slots
        server.submit(next_i, *traffic.in_flight(j, slots))
        next_i += 1
    server.step()
    phase("slots filled")
    for _ in rec.just_finished:
        tokens, out = traffic.request(next_i)
        server.submit(next_i, tokens, out)
        next_i += 1
    if fault is not None:
        fault(server, model)
    prof = _Profiler(sync, log) if (trace and cuda) else None
    gc.collect()
    gc.freeze()                    # the window's collections skip the set-up's objects
    sync()
    run.t0 = time.perf_counter()
    run.setup_s = run.t0 - t_process
    log(f"setup_s {run.setup_s:.3f} (window opens)")

    deadline = run.t0 + seconds
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        if prof is not None:
            prof.boundary(now, run, seconds)
        server.step()
        for _ in rec.just_finished:                    # each client's next request
            tokens, out = traffic.request(next_i)
            server.submit(next_i, tokens, out)
            next_i += 1
    run.t1 = run.steps[-1][1]
    if prof is not None:
        prof.close(run)
    window_rids = [r for r, q in run.requests.items() if run.in_window(q.submit)]
    late = time.perf_counter() + LATE_S
    while any(not run.requests[r].times for r in window_rids) and time.perf_counter() < late:
        server.step()
    mem_peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    log(itl_modes(run))
    log(window_summary(run))
    failed = sum(1 for r in window_rids if not run.requests[r].times)

    metrics = {}
    for name in cell_metrics(bench, cell, trace):
        value = reader(name)(run)
        if value is not None:
            unit = next(m["unit"] for m in bench["end_to_end"] + bench["per_layer"]
                        if m["name"] == name)
            metrics[name] = {"value": value, "unit": unit}

    rec.detach()                                       # free the program's state
    del server, rec, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = overrides.get("limits") or load_json(BENCH / "limits" / f"{cell}.json")
    checks = check.check_run(run, params, cfg, seed, limits, log=log, control=control)
    correct = all(c["value"] <= c["limit"] for c in checks.values() if c["limit"] is not None)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": mem_peak}
    result = {"correct": correct, "attempted": len(window_rids), "failed": failed,
              "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace["busy_s"]
        device_info["window_s"] = run.trace["window_s"]
        result["breakdown"] = run.trace["breakdown"]
    result["build_s"] = build_s                        # part of setup_s, shown apart
    result["checks"] = checks
    return result


class _Profiler:
    """The profiled span inside the window: device activity from
    ``torch.profiler`` (CUDA only) over a steady part of it, with the port's
    launch counters read at both ends."""

    def __init__(self, sync, log):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.sync, self.log = sync, log
        self._make = lambda: profile(activities=[ProfilerActivity.CUDA])
        warm = self._make()                             # CUPTI's start-up, in set-up
        warm.start()
        torch.zeros(1, device="cuda").add_(1)
        sync()
        warm.stop()
        self.prof = self.start = self.stop = None

    def boundary(self, now, run, seconds):
        """Open the span at the first step boundary of the window's last
        TRACE_SPAN_S seconds; it closes with the window (``close``), so the
        profiler's flush falls after it."""
        if self.prof is None and now >= run.t0 + seconds - TRACE_SPAN_S:
            self.sync()
            self.launches0 = launch_counts()
            self.prof = self._make()
            self.prof.start()
            self.start = time.perf_counter()
            self.epoch = time.time_ns() - time.perf_counter_ns()

    def close(self, run):
        if self.prof is None:
            raise RuntimeError("the window closed before the profiled span opened")
        self.sync()
        self.stop = time.perf_counter()
        self.prof.stop()
        self.launches1 = launch_counts()
        from torch.autograd import DeviceType

        events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in self.prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
        run.trace = summarize_trace(run, events, self.start, self.stop, self.epoch,
                                    self.launches0, self.launches1, self.log)


def kernel_kind(name: str) -> Optional[str]:
    if any(k in name for k in K3_NAMES):
        return "k3"
    if any(k in name for k in K4_NAMES):
        return "k4"
    return None


def summarize_trace(run: Run, events, start, stop, epoch, launches0, launches1, log) -> dict:
    """Busy and idle time, the top kernels, the K3 and K4 events beside the
    launch counters, and each kernel's summed device time and bound.

    The cross-check knows nothing of how many kernels a call launches: the
    span's K3 (K4) events must be a whole multiple of the K3 (K4) calls the
    port's counters saw in it, and at least as many.  ``epoch`` puts host
    seconds · 1e9 on the trace's clock, closely enough to name idle gaps."""
    from portbench.stats import gaps, union_seconds

    cfg = run.cfg
    lo, hi = start * 1e9 + epoch, stop * 1e9 + epoch
    intervals = [(s, e) for _, s, e in events]
    busy_s = union_seconds(intervals) / 1e9
    by_name: Dict[str, float] = {}
    kind_s = {"k3": 0.0, "k4": 0.0}
    kind_n = {"k3": 0, "k4": 0}
    for name, s, e in events:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
        kind = kernel_kind(name)
        if kind:
            kind_s[kind] += (e - s) / 1e9
            kind_n[kind] += 1
    span_prefills = [p for p in run.prefills if start <= p[0] and p[1] <= stop]
    kinds = flops.layer_kinds(cfg)
    n_attn = sum(1 for m, _ in kinds if m in ("attn", "attn_local"))
    n_ssm = sum(1 for m, _ in kinds if m == "mamba")
    log(f"profiled span {stop - start:.3f} s, {len(events)} device events, "
        f"{len(span_prefills)} prefills")
    for k in ("k3", "k4"):
        launched = launches1[k] - launches0[k]
        log(f"profiler {k} events {kind_n[k]}; launch counter {launched} calls")
        if kind_n[k] % max(launched, 1) or kind_n[k] < launched or (kind_n[k] and not launched):
            raise RuntimeError(f"the profiler recorded {kind_n[k]} {k} kernel events where the "
                               f"port launched {launched} calls: the trace dropped launches, so "
                               "no roofline share is read")
    bound = {"k3": 0.0, "k4": 0.0}
    for _, _, plen, _ in span_prefills:
        if n_attn:
            bound["k3"] += n_attn * flops.flash_bound(1, plen, cfg["n_heads"], cfg["n_kv_heads"],
                                                      cfg["head_dim"])[0]
        if n_ssm:
            di = cfg["ssm_expand"] * cfg["d_model"]
            bound["k4"] += n_ssm * flops.ssd_bound(1, plen, di // cfg["ssm_head_dim"],
                                                   cfg["ssm_head_dim"], cfg["ssm_state"],
                                                   flops.ssd_chunk(cfg, plen))[0]
    host = _host_spans(run, epoch)
    idle = [[_host_at(host, (g0 + g1) / 2), (g1 - g0) / 1e9]
            for g0, g1 in gaps(intervals, lo, hi)[:10]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top = [(name[:NAME_CHARS], secs) for name, secs in top]
    return {"busy_s": busy_s, "window_s": stop - start, "start": start, "stop": stop,
            "kernel_s": kind_s, "kernel_events": kind_n, "bound_s": bound,
            "breakdown": {"device_ops": [[n, s] for n, s in top], "idle_gaps": idle}}


def _host_spans(run: Run, epoch):
    spans = [(s * 1e9 + epoch, e * 1e9 + epoch, "prefill") for s, e, _, _ in run.prefills]
    spans += [(s * 1e9 + epoch, e * 1e9 + epoch, "decode_step") for s, e, _ in run.decodes]
    spans += [(s * 1e9 + epoch, e * 1e9 + epoch, "step outside the model")
              for s, e, _, _ in run.steps]
    return spans


def _host_at(spans, t) -> str:
    """What the host was doing at epoch time t: the innermost span holding it."""
    best = None
    for s, e, name in spans:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "between steps (client and harness)"
