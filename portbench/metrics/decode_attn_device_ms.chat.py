"""Device time of the events launched inside a layer.attn span under model.decode_step (decode attention), per decode step of the profiled span."""
from portbench.attribution import attributed, under


def read(run):
    att = attributed(run)
    if att is None or not att["decode_steps"]:
        return None
    return 1e3 * under(att["device_by_path"], "model.decode_step", "layer.attn") / att["decode_steps"]
