"""Host milliseconds a step spends in the engine's own work: the program's
``engine/step`` range less the model's calls (``model/prefill``,
``model/decode_step``) and the drain (``engine/drain``) inside it, over
the steps of the profiled slice."""

from portbench.spans import entries, program_totals, seconds


def read(rec):
    spans = program_totals()
    steps = entries(spans, "engine/step") if spans else 0
    if not steps:
        return None
    inner = sum(seconds(spans, name, under="engine/step")
                for name in ("model/prefill", "model/decode_step",
                             "engine/drain"))
    return (seconds(spans, "engine/step") - inner) / steps * 1e3
