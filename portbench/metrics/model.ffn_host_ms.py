"""Host milliseconds of one decode call's feed-forward layers: the
program's ``model/ffn`` ranges (norm, and MLP or MoE) inside
``model/decode_step``, over the decode calls of the profiled slice."""

from portbench.spans import entries, program_totals, seconds


def read(rec):
    spans = program_totals()
    calls = entries(spans, "model/decode_step") if spans else 0
    if not calls:
        return None
    return seconds(spans, "model/ffn",
                   under="model/decode_step") / calls * 1e3
