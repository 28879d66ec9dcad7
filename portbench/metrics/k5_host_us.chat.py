"""The host's wall time of a k5 span (one launch of K5's CUDA path) under model.decode_step, mean over the window's part before the profiled span."""
from portbench.attribution import host_spans


def read(run):
    spans = host_spans(run, "k5", inside="model.decode_step")
    return sum(e - s for _, s, e, _ in spans) / len(spans) / 1e3 if spans else None
