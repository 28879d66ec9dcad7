"""The median wait from submission to the start of the request's prefill, over the requests submitted in the window."""
from portbench.readings import ms_percentile


def read(run):
    waits = [q.prefill_start - q.submit for q in run.requests.values()
             if run.in_window(q.submit) and q.prefill_start is not None]
    return ms_percentile(waits, 50)
