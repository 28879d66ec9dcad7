"""Mean of step()'s busy slots over the window's steps."""


def read(run):
    steps = run.window_steps()
    return sum(s[2] for s in steps) / len(steps) if steps else None
