"""The 95th percentile, over every request submitted in the window, of submission to first token."""
from portbench.readings import ms_percentile, ttfts


def read(run):
    return ms_percentile(ttfts(run), 95)
