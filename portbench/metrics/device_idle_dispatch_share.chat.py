"""The device's idle time while the host was inside model.decode_step (idle instants cut by the innermost span), over the profiled span."""
from portbench.attribution import attributed, under


def read(run):
    att = attributed(run)
    if att is None:
        return None
    return 100.0 * under(att["idle_by_path"], "model.decode_step") / run.trace["window_s"]
