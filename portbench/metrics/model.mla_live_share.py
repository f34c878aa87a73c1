"""The share of the latent positions MLA's absorbed decode reads that the
decode rows attend to: over the window's decode calls (the model proxy's),
the stepping rows' key counts times the layers, over the positions one
call reads (the program's ``mla_decode.positions_read`` over its decode
calls, ``Model.decode_calls``: every row of the executed width, each
row's whole cache, in every layer), in per cent.  None where the program
counts none."""

import sys


def read(rec):
    layers = sys.modules.get("repro_torch.models.layers")
    model = sys.modules.get("repro_torch.models.model")
    positions = getattr(getattr(layers, "mla_decode", None),
                        "positions_read", 0)
    calls = getattr(getattr(model, "Model", None), "decode_calls", None)
    window = [c for c in rec.get("calls", ()) if c["kind"] == "decode"]
    if not positions or not calls or not sum(calls.values()) or not window:
        return None
    per_call = positions / sum(calls.values())
    live = (sum(sum(c["lengths"]) for c in window) * rec["dims"]["layers"]
            / len(window))
    return 100.0 * live / per_call
