"""Host milliseconds a step spends in the engine's drain (the program's
``engine/drain`` range: handing the sampled tokens to the drain, or
draining them, and waiting for them on the host), over the steps of the
profiled slice (``engine/step``)."""

from portbench.spans import entries, program_totals, seconds


def read(rec):
    spans = program_totals()
    steps = entries(spans, "engine/step") if spans else 0
    if not steps:
        return None
    return seconds(spans, "engine/drain") / steps * 1e3
