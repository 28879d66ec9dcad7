"""The window's prefill wall (Model.prefill, synchronised at its end) over its prompt tokens / 1000."""


def read(run):
    spans = [(e - s, plen) for s, e, plen, _ in run.prefills if run.in_window(s) and run.in_window(e)]
    tokens = sum(p for _, p in spans)
    return 1e3 * sum(t for t, _ in spans) / (tokens / 1e3) if tokens else None
