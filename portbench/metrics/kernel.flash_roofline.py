"""The flash prefill kernel's share of its roofline over the profiled
slice: the least time its launches could take (``counts.attention``,
causal over each prompt) over the device time the profiler gave them, in
per cent.  None if the launches seen do not match the calls logged."""

from portbench.counts import bound_s
from portbench.counts.attention import flash_bytes, flash_flops


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["flash_s"]:
        return None
    dm = rec["dims"]
    calls = [c for c in rec["calls"] if c["kind"] == "prefill"
             and c["profiled"]]
    if len(prof["flash_s"]) != len(calls) * dm["layers"]:
        return None
    h, kv, d = dm["heads"], dm["kv"], dm["head_dim"]
    bound = dm["layers"] * sum(
        bound_s(flash_flops(c["prompt"], h, d),
                flash_bytes(c["prompt"], h, kv, d)) for c in calls)
    return 100.0 * bound / sum(prof["flash_s"])
