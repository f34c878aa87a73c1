"""Host milliseconds of one ``Model.decode_step`` call (the model proxy's
clock), over the window's calls outside the profiled slice."""


def read(rec):
    calls = [c["host_s"] for c in rec.get("calls", ())
             if c["kind"] == "decode" and not c["profiled"]]
    return sum(calls) / len(calls) * 1e3 if calls else None
