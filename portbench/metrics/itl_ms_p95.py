"""The 95th percentile of the gaps between a request's consecutive deliveries, over every request in the window."""
from portbench.readings import ms_percentile, token_gaps


def read(run):
    return ms_percentile(token_gaps(run), 95)
