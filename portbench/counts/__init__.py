"""Operations and bytes the window's work needs, computed from its shapes:
the yardstick behind every roofline share and the MFU.  Only rows that
step count (never the pad rows of a packed step) and each input byte
counts once, however often a kernel reads it."""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations over the bf16 peak
    or bytes over the HBM rate, whichever is larger."""
    return max(flops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"])
