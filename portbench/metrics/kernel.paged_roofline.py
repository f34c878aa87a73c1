"""The paged decode kernel's share of its roofline over the profiled
slice: the least time its launches could take (``counts.attention``, the
stepping rows' keys; operations at the bf16 peak or bytes at the HBM
rate, whichever is larger) over the device time the profiler gave them,
in per cent.  None if the launches seen do not match the calls logged."""

from portbench.counts import bound_s
from portbench.counts.attention import paged_bytes, paged_flops

#: tokens a page of the resident cache holds (models/transformer.PAGE_SIZE)
PAGE = 16


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["paged_s"]:
        return None
    dm = rec["dims"]
    calls = [c for c in rec["calls"] if c["kind"] == "decode"
             and c["profiled"]]
    if len(prof["paged_s"]) != len(calls) * dm["layers"]:
        return None
    h, kv, d = dm["heads"], dm["kv"], dm["head_dim"]
    bound = dm["layers"] * sum(
        bound_s(paged_flops(c["lengths"], h, d),
                paged_bytes(c["lengths"], h, kv, d, PAGE)) for c in calls)
    return 100.0 * bound / sum(prof["paged_s"])
