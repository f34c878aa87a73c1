"""Dense decoders (nemotron-4-340b): GQA attention with rotary positions,
a squared-ReLU or SwiGLU MLP, the norm the configuration runs."""

from __future__ import annotations

from .common import forward, logits, sublayer_mlp  # noqa: F401


def hidden(weights: dict, spec: dict, seqs: list[dict], lowp: bool):
    def mlp(p, i, h, spans, seqs_, lowp_):
        return sublayer_mlp(p, h, spec["runs_as"]["mlp"], lowp_)
    return forward(weights, spec, seqs, lowp=lowp, mlp_fn=mlp)
