"""Device time of the events launched inside Model.decode_step (its model.decode_step spans, by launch correlation), per decode step of the profiled span."""
from portbench.attribution import attributed, under


def read(run):
    att = attributed(run)
    if att is None or not att["decode_steps"]:
        return None
    return 1e3 * under(att["device_by_path"], "model.decode_step") / att["decode_steps"]
