"""The inter-token gap's 95th percentile in a host-paced cell, read in the
traced run over the gaps that ended outside the profiled slice."""

from portbench.stats import percentile


def read(rec):
    p = percentile([v for v, prof in rec["itl_s"] if not prof], 95)
    return None if p is None else p * 1e3
