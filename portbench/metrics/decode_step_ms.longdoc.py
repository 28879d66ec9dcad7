"""The window's decode wall (Model.decode_step, synchronised at its end in a traced run) over its decode steps: what the steps between admissions cost."""


def read(run):
    spans = [e - s for s, e, _ in run.decodes if run.in_window(s) and run.in_window(e)]
    return 1e3 * sum(spans) / len(spans) if spans else None
