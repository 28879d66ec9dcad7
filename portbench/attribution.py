"""Which of the port's spans launched each device event, and what the host
was doing through each idle gap of the device.

A traced run holds three records: the port's spans (``repro_torch.trace``,
``(name, start_ns, end_ns, arg)`` on ``time.perf_counter_ns()``); the
profiler's device events, each with the correlation id of the launch that
made it; and the profiler's launch records (the CUDA API
calls, ``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...), each with its host
start on the trace's clock.  A kernel runs long after its launch, so its own
time says nothing of the call that made it; its launch's host time does.

The two clocks are tied by marker launches made in the run: the host's
clock read before and after a launch brackets the launch record's time, so
the offset is known to within the bracket's width.  A launch's host time,
put on the spans' clock, falls in a stack of spans; the innermost names the
event's owner.  Idle time is cut the same way, instant by instant: each
piece of a gap goes to the innermost span the host was in at that instant.

Spans are keyed by their path, the names from the outermost span down
("serve.step/serve.admit/model.prefill/layer.attn"); a launch or an idle
instant in no span is ``OUTSIDE``.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Optional

from portbench.stats import gaps, union_seconds

OUTSIDE = "outside serve.step"
MARKER = "spin_kernel"         # the kernel of torch.cuda._sleep, which the markers launch
TOP = 10                       # kernels listed by the span that launched them
WORK_CALLS = ("Launch", "Memcpy", "Memset")    # API calls that put work on the device


def nesting(spans) -> List[Optional[int]]:
    """Each span's parent, an index into ``spans`` or None: the innermost
    span open at its start (spans of one thread nest)."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][1], -spans[i][2]))
    parent: List[Optional[int]] = [None] * len(spans)
    stack: List[int] = []
    for i in order:
        while stack and spans[stack[-1]][2] <= spans[i][1]:
            stack.pop()
        if stack:
            parent[i] = stack[-1]
        stack.append(i)
    return parent


def paths(spans, parent) -> List[str]:
    """Each span's path: the names from its outermost span down to its own."""
    out: List[Optional[str]] = [None] * len(spans)

    def path(i):
        if out[i] is None:
            p = parent[i]
            out[i] = spans[i][0] if p is None else f"{path(p)}/{spans[i][0]}"
        return out[i]

    return [path(i) for i in range(len(spans))]


def ancestor(spans, parent, i: Optional[int], name: str) -> Optional[int]:
    """The innermost span ``name`` that holds span ``i`` (``i`` itself included)."""
    while i is not None and spans[i][0] != name:
        i = parent[i]
    return i


class Timeline:
    """The innermost span at each instant: ``owner[k]`` holds from
    ``bounds[k]`` to ``bounds[k + 1]`` (None: no span)."""

    def __init__(self, spans):
        marks = []
        for i, (_, s, e, _) in enumerate(spans):
            if e > s:
                marks.append((s, 1, -e, i))
                marks.append((e, 0, 0, i))
        marks.sort()
        self.bounds: List[int] = []
        self.owner: List[Optional[int]] = []
        open_: List[int] = []
        for t, is_start, _, i in marks:
            if is_start:
                open_.append(i)
            else:
                open_.remove(i)
            top = open_[-1] if open_ else None
            if self.bounds and self.bounds[-1] == t:
                self.owner[-1] = top
            else:
                self.bounds.append(t)
                self.owner.append(top)

    def at(self, t) -> Optional[int]:
        k = bisect_right(self.bounds, t) - 1
        return self.owner[k] if k >= 0 else None

    def cut(self, a, b):
        """[(owner, length)] of the pieces of [a, b)."""
        k = bisect_right(self.bounds, a) - 1
        out = []
        while a < b:
            nxt = self.bounds[k + 1] if k + 1 < len(self.bounds) else b
            end = min(b, nxt)
            out.append((self.owner[k] if k >= 0 else None, end - a))
            a, k = end, k + 1
        return out


def offset(markers, device, launches, epoch, log):
    """(offset_ns, bracket_ns): trace clock minus the spans' clock, from the
    marker whose host bracket is narrowest.  ``markers`` are (before, after)
    host ns around each marker launch; their device events are the
    ``MARKER`` kernels.  ``epoch``, a rough offset (the wall clock's), tells
    which marker an event is: the markers lie seconds apart, so a marker the
    trace lost leaves the others known."""
    each = []
    for name, _, _, corr in device:
        if MARKER in name and corr in launches:
            host = launches[corr][0]
            t0, t1 = min(markers, key=lambda m: abs(host - epoch - (m[0] + m[1]) // 2))
            each.append((host - (t0 + t1) // 2, t1 - t0))
    log(f"clock offset of {len(each)} of {len(markers)} markers (ns, bracket ns): "
        + "; ".join(f"{o}, {w}" for o, w in each))
    if not each:
        raise RuntimeError(f"none of {len(markers)} marker launches is in the trace: no offset")
    return min(each, key=lambda ob: ob[1])


def attribute(spans, device, launches, markers, epoch, start, stop, kind, log) -> dict:
    """Put the profiled span's device events and idle time down to spans.

    ``device``: (name, start_ns, end_ns, correlation id) on the trace's
    clock; ``launches``: correlation id -> (host start on that clock, API
    call's name); ``start``, ``stop``: the profiled span in host seconds;
    ``kind(name)``: "k3", "k4" or None.  Launch calls of the span whose
    kernel or copy the trace lacks are counted by name (``lost``)."""
    off, bracket = offset(markers, device, launches, epoch, log)
    parent = nesting(spans)
    path = paths(spans, parent)
    line = Timeline(spans)
    lo, hi = int(start * 1e9), int(stop * 1e9)
    inside = [i for i, s in enumerate(spans) if lo <= s[1] and s[2] <= hi]
    prefills = {i: [spans[i][3], 0, 0] for i in inside if spans[i][0] == "model.prefill"}

    device_by_path: Dict[str, float] = {}
    ops: Dict[tuple, float] = {}                # (innermost span, kernel) -> seconds
    no_launch = outside = stray_kernels = 0
    work = [ev for ev in device if MARKER not in ev[0]]
    for name, s, e, corr in work:
        host = launches[corr][0] if corr in launches else None
        owner = None if host is None else line.at(host - off)
        key = OUTSIDE if owner is None else path[owner]
        if host is None:
            no_launch += 1
        elif owner is None:
            outside += 1
        device_by_path[key] = device_by_path.get(key, 0.0) + (e - s) / 1e9
        op = (key.rsplit("/", 1)[-1], name)
        ops[op] = ops.get(op, 0.0) + (e - s) / 1e9
        k = kind(name)
        if k:
            p = ancestor(spans, parent, owner, "model.prefill")
            if p in prefills:
                prefills[p][1 if k == "k3" else 2] += 1
            else:
                stray_kernels += 1

    made = {corr for *_, corr in device}
    lost: Dict[str, int] = {}
    for corr, (host, call) in launches.items():
        if corr not in made and lo <= host - off <= hi and any(k in call for k in WORK_CALLS):
            lost[call] = lost.get(call, 0) + 1

    idle_by_path: Dict[str, float] = {}
    for g0, g1 in gaps([(s, e) for _, s, e, _ in device], lo + off, hi + off):
        for owner, length in line.cut(g0 - off, g1 - off):
            key = OUTSIDE if owner is None else path[owner]
            idle_by_path[key] = idle_by_path.get(key, 0.0) + length / 1e9
    busy = union_seconds([(max(s, lo + off), min(e, hi + off)) for _, s, e, _ in device
                          if e > lo + off and s < hi + off]) / 1e9
    out = {"offset_ns": off, "bracket_ns": bracket, "events": len(work), "no_launch": no_launch,
           "launched_outside": outside, "stray_kernels": stray_kernels, "lost": lost,
           "device_by_path": device_by_path, "idle_by_path": idle_by_path,
           "idle_s": (hi - lo) / 1e9 - busy,
           "ops_by_span": [[span, name, secs] for (span, name), secs
                           in sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]],
           "prefills": [prefills[i] for i in sorted(prefills, key=lambda i: spans[i][1])],
           "decode_steps": sum(1 for i in inside if spans[i][0] == "model.decode_step")}
    log(f"attribution: {len(work)} device events, {len(launches)} launch records; "
        f"no launch record {no_launch}, launched outside every span {outside}, K3/K4 "
        f"outside model.prefill {stray_kernels}; launch calls without their device event "
        f"{lost}; offset {off} ns, bracket {bracket} ns")
    return out


def by_innermost(by_path: Dict[str, float]) -> Dict[str, float]:
    """Seconds by the innermost span's name (``OUTSIDE`` kept), longest first."""
    out: Dict[str, float] = {}
    for key, secs in by_path.items():
        name = key.rsplit("/", 1)[-1]
        out[name] = out.get(name, 0.0) + secs
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def under(by_path: Dict[str, float], *names) -> float:
    """Seconds of the paths that hold ``names`` in that order (at any depth)."""
    total = 0.0
    for key, secs in by_path.items():
        parts, at = key.split("/"), 0
        for name in names:
            if name not in parts[at:]:
                break
            at = parts.index(name, at) + 1
        else:
            total += secs
    return total


def attributed(run) -> Optional[dict]:
    """The run's attribution, or None where there is none or it failed: an
    event without a launch record, or a K3/K4 event launched outside every
    ``model.prefill`` span."""
    att = (run.trace or {}).get("attribution")
    if att is None or att["no_launch"] or att["stray_kernels"]:
        return None
    return att


def host_spans(run, name: str, inside: Optional[str] = None) -> list:
    """The spans ``name`` (under a span ``inside``, if given) of the window's
    part before the profiled span opens, where the profiler's per-launch cost
    does not lengthen them: all of the window in a run without a trace."""
    spans = getattr(run, "spans", None)
    if not spans:
        return []
    lo = int(run.t0 * 1e9)
    hi = int((run.trace["start"] if run.trace else run.t1) * 1e9)
    if inside is None:
        return [s for s in spans if s[0] == name and lo <= s[1] and s[2] <= hi]
    parent = nesting(spans)
    return [s for i, s in enumerate(spans) if s[0] == name and lo <= s[1] and s[2] <= hi
            and ancestor(spans, parent, parent[i], inside) is not None]
