"""Chat's time to first token: the 95th percentile of submission to first token, over the requests submitted in the window."""
from portbench.readings import ms_percentile, ttfts


def read(run):
    return ms_percentile(ttfts(run), 95)
