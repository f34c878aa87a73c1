"""Latent attention on mixture-of-experts decoders (DeepSeek-V3), plain
float32, written from the published description; nothing of
``repro_torch`` and no kernel.

Attention (every layer): the query through its low-rank latent (``wdq``,
an RMSNorm, ``wuq``) to 128 heads of nope + rope; the KV latent ``c``
(RMSNorm'd) and one rope key shared by the heads from ``wdkv``; per head
K = [c W_uk, k_pe] and V = c W_uv, decompressed, causal softmax attention
at scale mscale(factor, mscale_all_dim)^2 / sqrt(nope + rope), then
``wo``.  Rotary positions are YaRN's: each frequency blends theta's and
theta's over the factor by a linear ramp between the correction dims of
``beta_fast`` and ``beta_slow`` rotations over the original context,
applied to the rope dims in two halves (as ``runs_as`` says; the
published checkpoint pairs them interleaved, a permutation of the rope
columns of ``wuq`` and ``wdkv``, the same function reparametrised).

MoE layers: sigmoid scores of a float32 router over every published
expert; the choice (``noaux_tc``) adds the per-expert correction bias,
keeps the ``topk_group`` groups (of ``n_group``, consecutive ids) whose two
best biased scores sum highest, and takes the top k of their experts by
biased score; the gates are the unbiased scores of those experts,
renormalised to sum 1 and times ``routed_scaling_factor``.  Only the
experts held here (``expert_offset`` .. + ``n_routed_experts``) compute,
each over the tokens routed to it, beside the shared experts: one
expert-parallel rank's part of the layer.  With a
``moe_prefill_capacity_factor`` a prompt keeps, per expert, its first
``max(k, ceil(P * k / E * factor))`` assignments in token-major order, E
every published expert (``runs_as``, as the port's prefill does); every
served token is routed whole.
"""

from __future__ import annotations

import math

import torch

from .common import (F32, Q_BLOCK, layer, linear, logits,  # noqa: F401
                     norm, sequences, sublayer_mlp)
from .moe import kept


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_frequencies(dim: int, theta: float, rs: dict,
                     device) -> torch.Tensor:
    """The dim / 2 rotary frequencies under YaRN (``rope_scaling``)."""
    factor = float(rs["factor"])
    original = rs["original_max_position_embeddings"]

    def correction_dim(rotations):
        return (dim * math.log(original / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(correction_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(dim // 2, dtype=F32)
    base = theta ** (2 * i / dim)
    ramp = ((i - low) / (high - low)).clamp(0, 1)
    # ramp 0: theta's own frequency (extrapolated); 1: divided by factor
    freqs = (1 - ramp) / base + ramp / (factor * base)
    return freqs.to(device)


def rope(x: torch.Tensor, pos: torch.Tensor, freqs: torch.Tensor,
         scale: float) -> torch.Tensor:
    """x (T, heads, D) rotated in two halves at positions ``pos``, sin and
    cos times ``scale``."""
    half = x.shape[-1] // 2
    ang = pos.to(F32)[:, None] * freqs
    sin = (torch.sin(ang) * scale)[:, None, :]
    cos = (torch.cos(ang) * scale)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def causal_attention(q, k, v, scale: float) -> torch.Tensor:
    """q, k (T, H, Dk), v (T, H, Dv) of one sequence -> (T, H, Dv)."""
    t, h, _ = q.shape
    out = torch.empty((t, h, v.shape[-1]), dtype=F32, device=q.device)
    keys = torch.arange(t, device=q.device)
    for q0 in range(0, t, Q_BLOCK):
        s = torch.einsum("bhd,thd->hbt", q[q0:q0 + Q_BLOCK], k) * scale
        rows = torch.arange(q0, q0 + s.shape[1], device=q.device)
        s = s.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
        out[q0:q0 + Q_BLOCK] = torch.einsum("hbt,thd->bhd",
                                            torch.softmax(s, -1), v)
    return out


def mla(p: dict, h: torch.Tensor, spec: dict, pos, spans, freqs,
        lowp: bool) -> torch.Tensor:
    heads, eps = spec["num_attention_heads"], spec["runs_as"]["norm_eps"]
    dn, dr = spec["qk_nope_head_dim"], spec["qk_rope_head_dim"]
    dc, dv = spec["kv_lora_rank"], spec["v_head_dim"]
    rs = spec["rope_scaling"]
    factor = float(rs["factor"])
    rope_scale = (yarn_mscale(factor, rs["mscale"])
                  / yarn_mscale(factor, rs["mscale_all_dim"]))
    m = yarn_mscale(factor, rs["mscale_all_dim"])
    scale = m * m / math.sqrt(dn + dr)
    if spec["q_lora_rank"]:
        cq = norm(p["q_norm"], linear(h, p["wdq"], lowp), "rmsnorm", eps)
        q = linear(cq, p["wuq"], lowp)
    else:
        q = linear(h, p["wq"], lowp)
    q = q.reshape(-1, heads, dn + dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, freqs, rope_scale)],
                  -1)
    ckv = linear(h, p["wdkv"], lowp)
    c = norm(p["kv_norm"], ckv[:, :dc], "rmsnorm", eps)
    k_pe = rope(ckv[:, None, dc:], pos, freqs, rope_scale)
    att = torch.empty((h.shape[0], heads, dv), dtype=F32, device=h.device)
    for s0, n in spans:
        cs = c[s0:s0 + n]
        k = torch.cat([linear(cs, p["wuk"], lowp).reshape(n, heads, dn),
                       k_pe[s0:s0 + n].expand(n, heads, dr)], -1)
        v = linear(cs, p["wuv"], lowp).reshape(n, heads, dv)
        att[s0:s0 + n] = causal_attention(q[s0:s0 + n], k, v, scale)
    return linear(att.reshape(att.shape[0], -1), p["wo"], lowp)


def route(p: dict, h: torch.Tensor, spec: dict):
    """(gates, expert ids), each (T, k): ``noaux_tc`` over every published
    expert."""
    e = spec["published"]["n_routed_experts"]
    k, n_group = spec["num_experts_per_tok"], spec["n_group"]
    scores = torch.sigmoid(h @ p["router"].to(F32))
    biased = scores + p["router_bias"].to(F32)
    by_group = biased.reshape(-1, n_group, e // n_group)
    group_score = by_group.topk(2, -1).values.sum(-1)
    best = group_score.topk(spec["topk_group"], -1).indices
    allowed = torch.zeros_like(group_score, dtype=torch.bool)
    allowed[torch.arange(len(best), device=h.device)[:, None], best] = True
    choice = torch.where(allowed.repeat_interleave(e // n_group, 1),
                         biased, torch.tensor(float("-inf"), device=h.device))
    idx = choice.topk(k, -1).indices
    gates = scores.gather(1, idx)
    gates = gates / gates.sum(-1, keepdim=True)
    return gates * spec["routed_scaling_factor"], idx


def moe(p: dict, h: torch.Tensor, spec: dict, spans, seqs,
        lowp: bool) -> torch.Tensor:
    e = spec["published"]["n_routed_experts"]
    k, off = spec["num_experts_per_tok"], spec["expert_offset"]
    cf = spec["runs_as"]["moe_prefill_capacity_factor"]
    gates, idx = route(p, h, spec)
    keep = torch.ones_like(idx, dtype=torch.bool)
    for (s0, _), s in zip(spans, seqs if cf is not None else ()):
        n = len(s["prompt"])
        capacity = int(max(k, math.ceil(n * k / e * cf)))
        keep[s0:s0 + n] = kept(idx[s0:s0 + n], e, capacity)
    y = torch.zeros_like(h)
    for j in range(spec["n_routed_experts"]):
        rows, slot = torch.nonzero((idx == off + j) & keep, as_tuple=True)
        if rows.numel() == 0:
            continue
        part = {"wi": p["wi"][j], "wg": p["wg"][j], "wo": p["wo"][j]}
        out = sublayer_mlp(part, h[rows], "swiglu", lowp)
        y.index_add_(0, rows, out * gates[rows, slot, None])
    if "shared" in p:
        y = y + sublayer_mlp(p["shared"], h, "swiglu", lowp)
    return y


def hidden(weights: dict, spec: dict, seqs: list[dict], lowp: bool):
    """The final-normed hidden states (n_scored, d) at the scored rows."""
    sem = spec["runs_as"]
    kind, eps = sem["norm"], sem["norm_eps"]
    device = weights["embed"].device
    tokens, pos, spans, scored = sequences(seqs, device)
    freqs = yarn_frequencies(spec["qk_rope_head_dim"], sem["rope_theta"],
                             spec["rope_scaling"], device)
    x = weights["embed"][tokens].to(F32)
    for i in range(spec["num_hidden_layers"]):
        p = layer(weights, i)
        h = norm(p["attn_norm"], x, kind, eps)
        x = x + mla(p["attn"], h, spec, pos, spans, freqs, lowp)
        h = norm(p["mlp_norm"], x, kind, eps)
        if i < spec["first_k_dense_replace"]:
            x = x + sublayer_mlp(p["mlp"], h, sem["mlp"], lowp)
        else:
            x = x + moe(p["mlp"], h, spec, spans, seqs, lowp)
    return norm(weights["final_norm"], x[scored], kind, eps)
