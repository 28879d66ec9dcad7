"""The device's idle time while the host was inside serve.admit (prefill, cache write, first token), over the profiled span."""
from portbench.attribution import attributed, under


def read(run):
    att = attributed(run)
    if att is None:
        return None
    return 100.0 * under(att["idle_by_path"], "serve.admit") / run.trace["window_s"]
