"""The routed (token, expert) assignments dropped over an expert's capacity, over all routed assignments, summed over the window's model steps (the port's counters moe.dropped and moe.assignments)."""


def read(run):
    lo, hi = run.t0 * 1e9, run.t1 * 1e9
    samples = [(n, v) for n, t, v in getattr(run, "counters", None) or () if lo <= t <= hi]
    assigned = sum(int(v) for n, v in samples if n == "moe.assignments")
    dropped = sum(int(v) for n, v in samples if n == "moe.dropped")
    return 100.0 * dropped / assigned if assigned else None
