"""95th percentile over every inter-token gap in the window, of all
requests."""

from portbench.stats import percentile


def read(rec):
    p = percentile([v for v, _ in rec["itl_s"]], 95)
    return None if p is None else p * 1e3
