"""1 - the union of the device's activity intervals over the profiled span (torch.profiler)."""
from portbench.readings import idle_percent


def read(run):
    return idle_percent(run)
