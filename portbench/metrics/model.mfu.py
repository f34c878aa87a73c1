"""The whole step's share of the card's bf16 peak: the operations the
window's prefills and decode rows need (``counts.model``: stepping rows
only; a MoE layer's top-k and shared experts, not the experts it skips),
over the window's seconds times the peak, in per cent."""

from portbench.counts import PEAKS
from portbench.counts.model import decode_flops, prefill_flops


def read(rec):
    calls = rec.get("calls")
    if not calls or rec["window_s"] <= 0:
        return None
    dm = rec["dims"]
    flops = sum(prefill_flops(dm, c["prompt"]) if c["kind"] == "prefill"
                else decode_flops(dm, c["lengths"]) for c in calls)
    return 100.0 * flops / (rec["window_s"] * PEAKS["bf16_flops"])
