"""The share of the expert slots a MoE decode call computes that carry a
routed token: the program's count of routed assignments (t * k) over its
count of slots computed (e * capacity), over every decode call of the run
(each at the engine's one executed width), in per cent."""

from portbench.spans import moe_decode_slots


def read(rec):
    got = moe_decode_slots()
    if got is None or not got[1]:
        return None
    return 100.0 * got[0] / got[1]
