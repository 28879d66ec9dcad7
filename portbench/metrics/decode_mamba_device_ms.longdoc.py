"""Device time of the events launched inside a layer.mamba span under model.decode_step (the Mamba-2 decode layers), per decode step of the profiled span."""
from portbench.attribution import attributed, under


def read(run):
    att = attributed(run)
    if att is None or not att["decode_steps"]:
        return None
    return 1e3 * under(att["device_by_path"], "model.decode_step", "layer.mamba") / att["decode_steps"]
