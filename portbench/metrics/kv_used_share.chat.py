"""Mean over the window's steps of serve.kv_used (positions the busy slots hold) over serve.kv_reserved (slots x max_len)."""


def read(run):
    lo, hi = run.t0 * 1e9, run.t1 * 1e9
    samples = [(n, v) for n, t, v in getattr(run, "counters", None) or () if lo <= t <= hi]
    used = [v for n, v in samples if n == "serve.kv_used"]
    reserved = [v for n, v in samples if n == "serve.kv_reserved"]
    if not used or len(used) != len(reserved):
        return None
    return 100.0 * sum(u / r for u, r in zip(used, reserved)) / len(used)
