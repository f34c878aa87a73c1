"""Host milliseconds of one prefill: the program's ``model/prefill``
range, over the prefills of the profiled slice."""

from portbench.spans import entries, program_totals, seconds


def read(rec):
    spans = program_totals()
    calls = entries(spans, "model/prefill") if spans else 0
    if not calls:
        return None
    return seconds(spans, "model/prefill") / calls * 1e3
