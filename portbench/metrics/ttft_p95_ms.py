"""95th percentile of TTFT, over every request whose first token came in
the window: ``submit`` to the end of the step that produced it."""

from portbench.stats import percentile


def read(rec):
    p = percentile([v for v, _ in rec["ttft_s"]], 95)
    return None if p is None else p * 1e3
