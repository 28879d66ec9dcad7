"""Every token delivered inside the window, first tokens included, over the window's length."""
from portbench.readings import window_tokens


def read(run):
    return window_tokens(run) / (run.t1 - run.t0)
