"""Device milliseconds of one ``Model.decode_step`` call: the profiler's
device time of the kernels launched inside its range, over the profiled
slice."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["decode_s"] or not sum(prof["decode_s"]):
        return None
    return sum(prof["decode_s"]) / len(prof["decode_s"]) * 1e3
