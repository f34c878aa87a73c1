"""Mixture-of-experts decoders (deepseek-moe-16b): dense layers first,
then layers of routed experts beside shared ones.

Routing follows the configuration's ``runs_as``: a float32 router,
softmax over the experts, the top k, the k gates renormalised to sum 1
where ``moe_gates`` is "renormalised" (as the port does) and left as the
softmax gave them where it is "softmax" (the published
``norm_topk_prob`` false).  With a ``moe_prefill_capacity_factor``, a
prompt's assignments are kept in token-major order up to each expert's
capacity ``max(k, ceil(P * k / E * capacity_factor))`` and the rest
dropped, as the port's prefill of ``P`` tokens does; without one (null,
as published) none is dropped.  Every served token is routed whole, as a
decode step does.  Each expert computes only the tokens routed to it."""

from __future__ import annotations

import math

import torch

from .common import F32, forward, linear, logits, sublayer_mlp  # noqa: F401


def kept(idx: torch.Tensor, experts: int, capacity: int) -> torch.Tensor:
    """Which of a prompt's (P, k) assignments fit their expert's capacity,
    counted in token-major order."""
    flat = idx.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat, experts)
    place = torch.cumsum(onehot, 0).gather(1, flat[:, None])[:, 0] - 1
    return (place < capacity).reshape(idx.shape)


def moe_sublayer(p: dict, h: torch.Tensor, spec: dict, spans, seqs,
                 lowp: bool) -> torch.Tensor:
    e, k = spec["n_routed_experts"], spec["num_experts_per_tok"]
    runs = spec["runs_as"]
    cf = runs["moe_prefill_capacity_factor"]
    probs = torch.softmax(h @ p["router"].to(F32), -1)
    gates, idx = torch.topk(probs, k, -1)
    if runs["moe_gates"] == "renormalised":
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    elif runs["moe_gates"] != "softmax":
        raise ValueError(f"unknown moe_gates {runs['moe_gates']!r}")
    keep = torch.ones_like(idx, dtype=torch.bool)
    for (s0, _), s in zip(spans, seqs if cf is not None else ()):
        n = len(s["prompt"])
        capacity = int(max(k, math.ceil(n * k / e * cf)))
        keep[s0:s0 + n] = kept(idx[s0:s0 + n], e, capacity)
    y = torch.zeros_like(h)
    for ex in range(e):
        rows, slot = torch.nonzero((idx == ex) & keep, as_tuple=True)
        if rows.numel() == 0:
            continue
        part = {"wi": p["wi"][ex], "wg": p["wg"][ex], "wo": p["wo"][ex]}
        out = sublayer_mlp(part, h[rows], "swiglu", lowp)
        y.index_add_(0, rows, out * gates[rows, slot, None])
    if "shared" in p:
        y = y + sublayer_mlp(p["shared"], h, "swiglu", lowp)
    return y


def hidden(weights: dict, spec: dict, seqs: list[dict], lowp: bool):
    dense_layers = spec["first_k_dense_replace"]

    def mlp(p, i, h, spans, seqs_, lowp_):
        if i < dense_layers:
            return sublayer_mlp(p, h, spec["runs_as"]["mlp"], lowp_)
        return moe_sublayer(p, h, spec, spans, seqs_, lowp_)
    return forward(weights, spec, seqs, lowp=lowp, mlp_fn=mlp)
