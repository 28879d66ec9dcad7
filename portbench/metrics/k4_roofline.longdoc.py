"""K4 (the SSD scan): the summed least time of its launches in the profiled span over their summed device time."""
from portbench.readings import roofline_percent


def read(run):
    return roofline_percent(run, "k4")
