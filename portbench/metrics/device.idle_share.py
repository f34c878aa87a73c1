"""The share of the profiled slice in which no operation ran on the
device (1 - busy / slice), in per cent."""


def read(rec):
    prof = rec.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
