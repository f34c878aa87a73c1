"""Model building blocks: norms, rotary embeddings, GQA attention, MLPs.

PyTorch counterpart of ``repro.models.layers`` for the dense family.
Parameters are plain tensors in nested dicts, in the JAX package's layouts
(``wq`` (d, H, hd), ``wo`` (H, hd, d), ``wi`` (d, f), ...), so moving
weights across is a copy (``repro_torch.convert``).  Every block is a
function ``(params, x, ...) -> y``.

Prefill attention always goes through the flash-attention kernel's wrapper
(``kernels/flash_attention/ops.py``), whatever ``cfg.attn_impl`` says: the
hand-written CUDA kernel for a tensor on the card, its plain version (the
reference's ``dense_attention`` arithmetic) for a tensor on the CPU.
``dense_attention`` and ``blockwise_attention`` are kept as plain versions
of the reference's two jnp attention paths.  MLA and MoE blocks are still
to port (ROADMAP.md, Queue 1 item 4).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

Params = dict  # nested dict of tensors

NEG_INF = -1e30


# ---------------------------------------------------------------------------------
# Initialization helpers
# ---------------------------------------------------------------------------------

def make_param(generator: torch.Generator, shape: tuple, *,
               fan_in: Optional[int] = None, dtype=torch.bfloat16,
               device=None, zeros: bool = False, ones: bool = False,
               lead: tuple = ()) -> torch.Tensor:
    """A parameter of shape ``lead + shape`` drawn from ``generator``:
    normal / sqrt(fan_in), or zeros / ones.  ``fan_in`` defaults to
    ``shape[0]``.

    A stacked parameter (``lead``, the layers axis) is drawn one ``shape``
    slice at a time into a preallocated ``dtype`` tensor, so the f32
    scratch is one slice: drawing qwen3-32b's (64, 5120, 25600) ``wi`` whole
    would take 33.6 GB of f32, twice, beside the weights already drawn."""
    full = tuple(lead) + tuple(shape)
    if zeros:
        return torch.zeros(full, dtype=dtype, device=device)
    if ones:
        return torch.ones(full, dtype=dtype, device=device)
    scale = 1.0 / math.sqrt(max(1, fan_in if fan_in is not None else shape[0]))
    out = torch.empty(full, dtype=dtype, device=device)
    for part in out.view(-1, *shape):
        v = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        part.copy_(v.mul_(scale))
    return out


# ---------------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------------

def init_norm(generator, d: int, kind: str, dtype=torch.bfloat16, *,
              lead: tuple = (), device=None) -> Params:
    """``lead`` prepends stacked axes (the scan-stacked ``blocks`` layout)."""
    if kind == "nonparametric_ln":
        return {}
    if kind == "rmsnorm":
        return {"scale": make_param(generator, lead + (d,), ones=True,
                                    dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": make_param(generator, lead + (d,), ones=True,
                                    dtype=dtype, device=device),
                "bias": make_param(generator, lead + (d,), zeros=True,
                                   dtype=dtype, device=device)}
    raise ValueError(f"unknown norm kind {kind}")


def apply_norm(params: Params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (y * params["scale"].float()).to(x.dtype)
    # layernorm / non-parametric layernorm
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------------
# Rotary position embeddings (half-split, as in the reference)
# ---------------------------------------------------------------------------------

def rope_table(positions: torch.Tensor, dim: int, theta: float = 10000.0):
    """(positions...) -> (sin, cos) of shape positions.shape + (dim/2,)."""
    half = dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exponent)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, dim); sin/cos: (..., seq, dim/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    s, c = sin[..., None, :], cos[..., None, :]  # broadcast over heads
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------------
# Attention cores (plain versions of the reference's jnp paths)
# ---------------------------------------------------------------------------------

def dense_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                    window: Optional[int] = None,
                    kv_len=None) -> torch.Tensor:
    """Plain softmax attention in f32.  q:(B,Sq,H,D) k,v:(B,Sk,H,D)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, NEG_INF)
    if kv_len is not None:  # decode: mask out unwritten cache slots
        logits = torch.where((kpos < kv_len)[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def blockwise_attention(q, k, v, *, causal: bool, block_kv: int = 1024,
                        q_offset: int = 0,
                        window: Optional[int] = None) -> torch.Tensor:
    """The flash-attention algorithm written with tensor ops: a loop over KV
    blocks with running (max, sum, acc), as the reference's lax.scan."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    nblk = -(-sk // block_kv)
    pad = nblk * block_kv - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = 1.0 / math.sqrt(d)
    qf = q.float() * scale
    qpos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    s = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for bidx in range(nblk):
        lo = bidx * block_kv
        kblk = k[:, lo:lo + block_kv].float()
        vblk = v[:, lo:lo + block_kv].float()
        kpos = lo + torch.arange(block_kv, device=q.device)
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kblk)
        mask = torch.ones((sq, block_kv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        mask &= (kpos < sk)[None, :]
        logits = torch.where(mask[None, None], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        s = s * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vblk)
        m = m_new
    out = acc / torch.clamp(s[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)  # (B,H,Sq,D)->(B,Sq,H,D)


def attention_core(q, k, v, *, causal: bool,
                   window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence (train / prefill) attention: the flash kernel's wrapper.
    GQA is native there, so K/V are never repeated in memory."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    return fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal, window=window)


# ---------------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------------

def init_attention(generator, cfg, *, lead: tuple = (), device=None) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def mk(shape, **kw):
        return make_param(generator, shape, lead=lead, dtype=cfg.dtype,
                          device=device, **kw)

    p = {
        "wq": mk((d, h, hd), fan_in=d),
        "wk": mk((d, kv, hd), fan_in=d),
        "wv": mk((d, kv, hd), fan_in=d),
        "wo": mk((h, hd, d), fan_in=h * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = mk((h, hd), zeros=True)
        p["bk"] = mk((kv, hd), zeros=True)
        p["bv"] = mk((kv, hd), zeros=True)
    if cfg.qk_norm:
        p["q_norm"] = init_norm(generator, hd, "rmsnorm", cfg.dtype,
                                lead=lead, device=device)
        p["k_norm"] = init_norm(generator, hd, "rmsnorm", cfg.dtype,
                                lead=lead, device=device)
    return p


def qkv_projections(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor):
    """q, k, v for x: (B, S, D) -> (B,S,H,hd), (B,S,KV,hd) x2, with bias,
    qk-norm and RoPE applied as the reference orders them."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q, "rmsnorm")
        k = apply_norm(p["k_norm"], k, "rmsnorm")
    if cfg.rope:
        sin, cos = rope_table(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    return q, k, v


def attention_block(p: Params, x: torch.Tensor, cfg, *,
                    positions: torch.Tensor, window: Optional[int] = None,
                    causal: bool = True, return_kv: bool = False):
    """GQA attention over a full sequence (train and prefill).  x: (B, S, D).

    With ``return_kv`` the post-RoPE (k, v) come back too, so the caller
    assembles the KV cache in one shot.  Decode against a cache is
    ``transformer.decode_attention`` (the paged kernel).
    Returns (y, (k, v) or None).
    """
    q, k, v = qkv_projections(p, x, cfg, positions)
    out = attention_core(q, k, v, causal=causal, window=window)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, ((k, v) if return_kv else None)


# ---------------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------------

def init_mlp(generator, cfg, d_ff: Optional[int] = None, *, lead: tuple = (),
             device=None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff

    def mk(shape, fan_in):
        return make_param(generator, shape, lead=lead, fan_in=fan_in,
                          dtype=cfg.dtype, device=device)

    if cfg.mlp_kind == "swiglu":
        return {"wi": mk((d, f), d), "wg": mk((d, f), d), "wo": mk((f, d), f)}
    return {"wi": mk((d, f), d), "wo": mk((f, d), f)}


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with the reference's rounding: XLA computes a bf16
    logistic as 1 / (1 + exp(-x)) rounding every step to bf16, where
    ``F.silu`` rounds once; elementwise torch ops on a bf16 tensor round
    each step the same way."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp_block(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.mlp_kind == "swiglu":
        return torch.einsum(
            "bsf,fd->bsd",
            silu(torch.einsum("bsd,df->bsf", x, p["wg"]))
            * torch.einsum("bsd,df->bsf", x, p["wi"]),
            p["wo"])
    h = torch.einsum("bsd,df->bsf", x, p["wi"])
    if cfg.mlp_kind == "squared_relu":
        h = torch.square(F.relu(h))
    elif cfg.mlp_kind == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(cfg.mlp_kind)
    return torch.einsum("bsf,fd->bsd", h, p["wo"])
