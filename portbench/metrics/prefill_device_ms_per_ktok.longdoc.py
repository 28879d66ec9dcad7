"""Device time of the events launched inside model.prefill spans of the profiled span, over those spans' prompt tokens / 1000."""
from portbench.attribution import attributed, under


def read(run):
    att = attributed(run)
    tokens = sum(p[0] for p in att["prefills"]) if att else 0
    if not tokens:
        return None
    return 1e3 * under(att["device_by_path"], "model.prefill") / (tokens / 1e3)
