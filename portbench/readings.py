"""Readings of one run's records that the metric readers share.

Every reading covers the window [t0, t1]: whole steps, the first starting
at t0 and the last ending at t1.  A token is delivered when the step that
produced it returns.
"""
from __future__ import annotations

from portbench import flops
from portbench.stats import percentile

PEAK_FLOPS = flops.PEAK_BF16_FLOPS


def window_tokens(run) -> int:
    """Tokens delivered inside the window, first tokens included."""
    return sum(1 for q in run.requests.values() for t in q.times if run.in_window(t))


def token_gaps(run) -> list:
    """Seconds between consecutive deliveries of a request, both inside the
    window (a request's first two tokens arrive in one step: one delivery)."""
    out = []
    for q in run.requests.values():
        times = sorted(set(t for t in q.times if run.in_window(t)))
        out.extend(b - a for a, b in zip(times, times[1:]))
    return out


def ttfts(run) -> list:
    """Seconds from submission to first token of each request submitted in
    the window (its first token may come after the window closes)."""
    return [q.times[0] - q.submit for q in run.requests.values()
            if run.in_window(q.submit) and q.times]


def window_flops(run) -> int:
    """Model FLOPs of the prefills and decode steps inside the window."""
    total = sum(flops.prefill_flops(run.cfg, plen) for s, e, plen, _ in run.prefills
                if run.in_window(s) and run.in_window(e))
    total += sum(flops.decode_flops(run.cfg, pos) for s, e, positions in run.decodes
                 if run.in_window(s) and run.in_window(e) for pos in positions)
    return total


def mfu_percent(run) -> float:
    return 100.0 * window_flops(run) / ((run.t1 - run.t0) * PEAK_FLOPS)


def idle_percent(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def roofline_percent(run, kernel: str):
    """A kernel's summed least time over its summed device time in the
    profiled span; nothing where it did not run there."""
    if run.trace is None or not run.trace["kernel_events"][kernel]:
        return None
    return 100.0 * run.trace["bound_s"][kernel] / run.trace["kernel_s"][kernel]


def ms_percentile(values, q):
    p = percentile(values, q)
    return None if p is None else 1e3 * p


def itl_modes(run) -> str:
    """Where the token gaps' 95th percentile falls among the steps' modes:
    the share of the window's steps that admitted 0, 1 and 2 or more
    requests, the share of gaps each mode delivered, and the mode of the
    gaps around rank 95 (ranks 93 to 97)."""
    steps = run.window_steps()
    mode_at = {end: min(admitted, 2) for _, end, _, admitted in steps}
    labelled = []
    for q in run.requests.values():
        times = sorted(set(t for t in q.times if run.in_window(t)))
        labelled.extend((b - a, mode_at.get(b, -1)) for a, b in zip(times, times[1:]))
    if not steps or not labelled:
        return "itl modes: nothing to read"
    labelled.sort()
    n = len(labelled)
    step_share = [sum(1 for s in steps if min(s[3], 2) == m) / len(steps) for m in (0, 1, 2)]
    gap_share = [sum(1 for _, m in labelled if m == k) / n for k in (0, 1, 2)]
    near = [m for _, m in labelled[int(0.93 * n):int(0.97 * n) + 1]]
    near_share = [near.count(k) / len(near) for k in (0, 1, 2)]
    top0 = max((g for g, m in labelled if m == 0), default=0.0)
    rank0 = sum(1 for g, _ in labelled if g <= top0) / n
    return ("itl modes: steps admitting 0/1/2+ " + "/".join(f"{x:.4f}" for x in step_share)
            + "; gaps 0/1/2+ " + "/".join(f"{x:.4f}" for x in gap_share)
            + f"; p95 {1e3 * percentile([g for g, _ in labelled], 95):.3f} ms"
            + "; modes at ranks 93-97 " + "/".join(f"{x:.3f}" for x in near_share)
            + f"; the 0-admission mode ends at rank {100 * rank0:.2f}")


def window_summary(run) -> str:
    """Steps and time to first token across the window, to tell a run that
    is slower all through from one whose tail moved."""
    steps = run.window_steps()
    t = sorted(ttfts(run))
    mean_ms = 1e3 * (run.t1 - run.t0) / max(len(steps), 1)
    return (f"window: {len(steps)} steps, {mean_ms:.3f} ms a step; ttft ms p50/p90/p95/p99 "
            + "/".join(f"{ms_percentile(t, q) or 0:.3f}" for q in (50, 90, 95, 99)))
