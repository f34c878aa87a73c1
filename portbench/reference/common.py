"""The plain float32 forward both families share.

It runs every sequence whole (prompt and served tokens, positions 0..L-1,
causal attention over all of them), with no cache, no batching across
sequences inside attention, and no kernel: what a prefill followed by
decoding through a cache has to give.  Weights stay as they were made
(bf16; a MoE router f32) and each matrix is widened to float32 block by
block as it is used, so no float32 copy of the model is ever held.
TF32 is off.

``lowp`` is the control: every product of a matrix stated in bf16 (the
attention projections, the MLPs and experts, the output head) takes its
inputs through float8 e4m3, the input rows scaled per token and the
matrix per output column, accumulating in float32: the next precision
below the configuration's bf16.  Norms, softmaxes, attention products,
the float32 router and the residual stream stay float32.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0
#: elements of a matrix widened to float32 at a time
BLOCK_ELEMS = 1 << 28
#: query rows of one attention block
Q_BLOCK = 256


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded through e4m3, scaled so each slice along ``dim``
    reaches the format's largest value."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(FP8).to(F32) * scale


def linear(x: torch.Tensor, w: torch.Tensor, lowp: bool) -> torch.Tensor:
    """x (T, K) float32 times w viewed (K, N), in float32."""
    w = w.reshape(x.shape[1], -1)
    if lowp:
        x = fp8(x, -1)
    cols = max(1, BLOCK_ELEMS // w.shape[0])
    out = torch.empty((x.shape[0], w.shape[1]), dtype=F32, device=x.device)
    for c0 in range(0, w.shape[1], cols):
        wb = w[:, c0:c0 + cols].to(F32)
        if lowp:
            wb = fp8(wb, 0)
        out[:, c0:c0 + cols] = x @ wb
    return out


def norm(p: dict, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    if kind == "rmsnorm":
        y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
        return y * p["scale"].to(F32)
    if kind == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return ((x - mu) * torch.rsqrt(var + eps) * p["scale"].to(F32)
                + p["bias"].to(F32))
    raise ValueError(f"unknown norm {kind!r}")


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
         fraction: float) -> torch.Tensor:
    """Rotary embedding of x (T, heads, D) at positions ``pos`` (T,): the
    first ``fraction`` of each head rotated in two halves."""
    rot = int(x.shape[-1] * fraction)
    half = rot // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=F32,
                                         device=x.device) / half)
    ang = pos.to(F32)[:, None] * freqs
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2, rest = x[..., :half], x[..., half:rot], x[..., rot:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, rest], -1)


def causal_attention(q, k, v) -> torch.Tensor:
    """q (T, H, D), k and v (T, KV, D) of one sequence -> (T, H, D)."""
    t, h, d = q.shape
    kv = k.shape[1]
    qg = q.reshape(t, kv, h // kv, d)
    out = torch.empty_like(qg)
    keys = torch.arange(t, device=q.device)
    for q0 in range(0, t, Q_BLOCK):
        qb = qg[q0:q0 + Q_BLOCK]                       # (b, kv, r, d)
        s = torch.einsum("bgrd,tgd->grbt", qb, k) / math.sqrt(d)
        rows = torch.arange(q0, q0 + qb.shape[0], device=q.device)
        s = s.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
        out[q0:q0 + Q_BLOCK] = torch.einsum("grbt,tgd->bgrd",
                                            torch.softmax(s, -1), v)
    return out.reshape(t, h, d)


def sublayer_mlp(p: dict, x: torch.Tensor, kind: str,
                 lowp: bool) -> torch.Tensor:
    if kind == "swiglu":
        g = linear(x, p["wg"], lowp)
        return linear(g * torch.sigmoid(g) * linear(x, p["wi"], lowp),
                      p["wo"], lowp)
    if kind == "squared_relu":
        return linear(torch.relu(linear(x, p["wi"], lowp)) ** 2, p["wo"],
                      lowp)
    raise ValueError(f"unknown mlp {kind!r}")


def layer(weights: dict, i: int) -> dict:
    """Layer ``i``'s parameters: ``block0`` apart, else a view of the
    stacked ``blocks``."""
    if "block0" in weights:
        if i == 0:
            return weights["block0"]
        i -= 1

    def view(tree):
        return ({k: view(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree[i])
    return view(weights["blocks"])


def sequences(seqs: list[dict], device):
    """Token ids and positions of every sequence laid end to end, the
    (start, length) of each, and the rows whose logits are scored (the
    positions whose next token was served)."""
    tokens, pos, spans, scored = [], [], [], []
    start = 0
    for s in seqs:
        toks = list(s["prompt"]) + list(s["served"][:-1])
        tokens += toks
        pos += range(len(toks))
        spans.append((start, len(toks)))
        p = len(s["prompt"])
        scored += range(start + p - 1, start + p - 1 + len(s["served"]))
        start += len(toks)
    as_t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
    return as_t(tokens), as_t(pos), spans, as_t(scored)


def forward(weights: dict, spec: dict, seqs: list[dict], *, lowp: bool,
            mlp_fn) -> torch.Tensor:
    """The final-normed hidden states (n_scored, d) at the scored rows.
    ``mlp_fn(p, i, h, spans, seqs, lowp)`` is layer ``i``'s MLP
    sublayer."""
    sem = spec["runs_as"]
    kind, eps = sem["norm"], sem["norm_eps"]
    h_heads, kv = spec["num_attention_heads"], spec["num_key_value_heads"]
    d = spec["hidden_size"]
    hd = spec.get("head_dim", d // h_heads)
    device = weights["embed"].device
    tokens, pos, spans, scored = sequences(seqs, device)
    x = weights["embed"][tokens].to(F32)
    for i in range(spec["num_hidden_layers"]):
        p = layer(weights, i)
        h = norm(p["attn_norm"], x, kind, eps)
        q = linear(h, p["attn"]["wq"], lowp).reshape(-1, h_heads, hd)
        k = linear(h, p["attn"]["wk"], lowp).reshape(-1, kv, hd)
        v = linear(h, p["attn"]["wv"], lowp).reshape(-1, kv, hd)
        q = rope(q, pos, sem["rope_theta"], sem["rotary_fraction"])
        k = rope(k, pos, sem["rope_theta"], sem["rotary_fraction"])
        att = torch.empty_like(q)
        for s0, n in spans:
            att[s0:s0 + n] = causal_attention(q[s0:s0 + n], k[s0:s0 + n],
                                              v[s0:s0 + n])
        x = x + linear(att.reshape(att.shape[0], -1), p["attn"]["wo"], lowp)
        h = norm(p["mlp_norm"], x, kind, eps)
        x = x + mlp_fn(p["mlp"], i, h, spans, seqs, lowp)
    return norm(weights["final_norm"], x[scored], kind, eps)


def logits(weights: dict, spec: dict, h: torch.Tensor,
           lowp: bool) -> torch.Tensor:
    """The output head over the scored rows: (n_scored, V) float32."""
    w = (weights["embed"].T if spec["tie_word_embeddings"]
         else weights["unembed"])
    return linear(h, w, lowp)
