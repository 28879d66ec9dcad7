"""The host's wall time of a model.decode_step span, mean over the window's part before the profiled span."""
from portbench.attribution import host_spans


def read(run):
    spans = host_spans(run, "model.decode_step")
    return sum(e - s for _, s, e, _ in spans) / len(spans) / 1e6 if spans else None
