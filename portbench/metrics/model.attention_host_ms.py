"""Host milliseconds of one decode call's attention: the program's
``model/attention`` ranges (norm, projections, cache write, kernel,
output projection) inside ``model/decode_step``, over the decode calls of
the profiled slice."""

from portbench.spans import entries, program_totals, seconds


def read(rec):
    spans = program_totals()
    calls = entries(spans, "model/decode_step") if spans else 0
    if not calls:
        return None
    return seconds(spans, "model/attention",
                   under="model/decode_step") / calls * 1e3
