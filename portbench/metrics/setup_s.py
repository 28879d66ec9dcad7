"""Process start to the window's start: imports, kernel builds, weights, warm-up, filling the slots."""


def read(run):
    return run.setup_s
