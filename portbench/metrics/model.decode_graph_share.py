"""The share of the run's decode calls that replayed a CUDA graph: the
program's count of ``Model.decode_step`` calls by how they ran ("eager",
"captured", "replayed"), replayed over all, in per cent.  None where the
program counts none."""

import sys


def read(rec):
    mod = sys.modules.get("repro_torch.models.model")
    calls = getattr(getattr(mod, "Model", None), "decode_calls", None)
    if not calls or not sum(calls.values()):
        return None
    return 100.0 * calls.get("replayed", 0) / sum(calls.values())
