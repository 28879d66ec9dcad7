"""The model FLOPs of the window's prefills and decode steps (portbench.flops) over the window's length times 989 TFLOP/s."""
from portbench.readings import mfu_percent


def read(run):
    return mfu_percent(run)
