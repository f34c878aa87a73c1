"""Model building blocks: norms, rotary embeddings, GQA and MLA attention,
MLPs and MoE.

PyTorch counterpart of ``repro.models.layers``.
Parameters are plain tensors in nested dicts, in the JAX package's layouts
(``wq`` (d, H, hd), ``wo`` (H, hd, d), ``wi`` (d, f), ...), so moving
weights across is a copy (``repro_torch.convert``).  Every block is a
function ``(params, x, ...) -> y``.

Prefill (and the serving encoder's) attention always goes through the
flash-attention kernel's wrapper (``kernels/flash_attention/ops.py``),
whatever ``cfg.attn_impl`` says: the hand-written CUDA kernel for a tensor
on the card, its plain version (the reference's ``dense_attention``
arithmetic) for a tensor on the CPU.  Train mode (``train=True``) runs the
reference's jnp attention paths instead, written with torch ops so autograd
differentiates them: ``train_attention`` follows ``cfg.attn_impl`` as the
reference's ``attention_core`` does (``dense_attention`` or
``blockwise_attention``).  MLA's absorbed decode and the
MoE dispatch and expert products are jnp code in the reference, outside
any Pallas kernel, and plain torch here.  MoE runs on one device unless
``set_moe_mesh`` names a mesh: then its experts run expert-parallel, a
``local_map`` over the mesh standing in for the reference's
``shard_map`` (``moe_block``).

Sharding hints: ``shard_hint`` redistributes a DTensor activation to the
placements the installed resolver gives (``set_activation_resolver``;
``ShardingRules.resolver``).  With no resolver installed, as on the
serving and training paths, it returns its input untouched.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import device_counter, host_counter
from repro_torch.obs import span

Params = dict  # nested dict of tensors

NEG_INF = -1e30
F32 = torch.float32


# ---------------------------------------------------------------------------------
# Initialization helpers
# ---------------------------------------------------------------------------------

#: the axes tables open now (``record_axes``), innermost last
_AXES_TABLES: list[dict] = []


@contextlib.contextmanager
def record_axes():
    """Collect the logical axes of every parameter ``make_param`` makes
    inside: yields a table id(tensor) -> axes (``model.param_axes`` turns
    it into a tree shaped like the parameters)."""
    table: dict = {}
    _AXES_TABLES.append(table)
    try:
        yield table
    finally:
        _AXES_TABLES.pop()


def make_param(generator: torch.Generator, shape: tuple, axes: tuple = (),
               *, fan_in: Optional[int] = None, dtype=torch.bfloat16,
               device=None, zeros: bool = False, ones: bool = False,
               lead: tuple = ()) -> torch.Tensor:
    """A parameter of shape ``lead + shape`` drawn from ``generator``:
    normal / sqrt(fan_in), or zeros / ones.  ``fan_in`` defaults to
    ``shape[0]``.  ``axes`` names each dim of ``shape`` logically (the
    reference's ``Param.axes``: "embed", "heads", "mlp", ...); a stacked
    parameter's leading axis is "layers".  The names go to the open
    ``record_axes`` table, not into the tensor.

    A stacked parameter (``lead``, the layers axis) is drawn one ``shape``
    slice at a time into a preallocated ``dtype`` tensor, so the f32
    scratch is one slice: drawing qwen3-32b's (64, 5120, 25600) ``wi`` whole
    would take 33.6 GB of f32, twice, beside the weights already drawn.
    On ``device="meta"`` (abstract parameters) nothing is drawn and the
    generator is not read."""
    full = tuple(lead) + tuple(shape)
    if zeros:
        out = torch.zeros(full, dtype=dtype, device=device)
    elif ones:
        out = torch.ones(full, dtype=dtype, device=device)
    else:
        out = torch.empty(full, dtype=dtype, device=device)
        if out.device.type != "meta":
            scale = 1.0 / math.sqrt(
                max(1, fan_in if fan_in is not None else shape[0]))
            for part in out.view(-1, *shape):
                v = torch.randn(shape, generator=generator,
                                dtype=torch.float32, device=device)
                part.copy_(v.mul_(scale))
    if _AXES_TABLES:
        if len(axes) != len(shape):
            raise ValueError(f"make_param: axes {axes} for shape {shape}")
        _AXES_TABLES[-1][id(out)] = ("layers",) * len(lead) + tuple(axes)
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
        return {"scale": make_param(generator, (d,), ("embed",), ones=True,
                                    dtype=dtype, device=device, lead=lead)}
    if kind == "layernorm":
        return {"scale": make_param(generator, (d,), ("embed",), ones=True,
                                    dtype=dtype, device=device, lead=lead),
                "bias": make_param(generator, (d,), ("embed",), zeros=True,
                                   dtype=dtype, device=device, lead=lead)}
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

#: (dim, theta, device) -> the rotary frequencies, built once: building
#: them uploads ``theta``, a copy from pageable memory that synchronises
#: the stream, so a per-call build stalls every layer and cannot be
#: recorded in a CUDA graph
_ROPE_FREQS: dict[tuple, torch.Tensor] = {}


def rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    """``1 / theta ** (arange(dim/2) / (dim/2))`` in f32 on ``device``, as
    the reference computes it from a Python float; made on the first call
    for each (dim, theta, device) and kept."""
    key = (dim, float(theta), torch.device(device))
    freqs = _ROPE_FREQS.get(key)
    if freqs is None:
        half = dim // 2
        exponent = torch.arange(0, half, dtype=torch.float32,
                                device=device) / half
        freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                             device=device), exponent)
        _ROPE_FREQS[key] = freqs
    return freqs


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature: 0.1 * mscale * ln(factor) + 1 (1 for
    a factor of at most 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def _yarn_correction_dim(rotations: float, dim: int, theta: float,
                         original: int) -> float:
    """The rotary dim whose wavelength makes ``rotations`` turns over
    ``original`` positions."""
    return (dim * math.log(original / (rotations * 2 * math.pi))
            / (2 * math.log(theta)))


def yarn_freqs_host(dim: int, theta: float, yarn: tuple) -> torch.Tensor:
    """YaRN's blended rotary frequencies in f32 on the host, as DeepSeek
    publishes them: each of the dim/2 frequencies mixes theta's
    (``extra``) and theta's divided by the factor (``inter``), weighted by
    a ramp that is 1 (keep theta's) below the correction dim of
    ``beta_fast`` rotations and 0 past that of ``beta_slow``."""
    factor, original, beta_fast, beta_slow = yarn[:4]
    exponent = torch.arange(0, dim, 2, dtype=F32) / dim
    extra = 1.0 / (theta ** exponent)
    inter = 1.0 / (factor * theta ** exponent)
    low = max(math.floor(_yarn_correction_dim(beta_fast, dim, theta,
                                              original)), 0)
    high = min(math.ceil(_yarn_correction_dim(beta_slow, dim, theta,
                                              original)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=F32) - low)
                       / (high - low), 0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def yarn_freqs(dim: int, theta: float, yarn: tuple, device) -> torch.Tensor:
    """``yarn_freqs_host`` on ``device``, made on the first call for each
    (dim, theta, scaling, device) and kept (an upload, as
    ``rope_freqs``'s)."""
    key = (dim, float(theta), yarn, torch.device(device))
    freqs = _ROPE_FREQS.get(key)
    if freqs is None:
        freqs = _ROPE_FREQS[key] = yarn_freqs_host(dim, theta, yarn).to(
            device)
    return freqs


def rope_table(positions: torch.Tensor, dim: int, theta: float = 10000.0,
               yarn: tuple = ()):
    """(positions...) -> (sin, cos) of shape positions.shape + (dim/2,);
    with ``yarn`` (a config's) over YaRN's frequencies, scaled by
    mscale(factor, mscale) / mscale(factor, mscale_all_dim) where that is
    not 1."""
    freqs = (yarn_freqs(dim, theta, yarn, positions.device) if yarn
             else rope_freqs(dim, theta, positions.device))
    angles = positions.float()[..., None] * freqs
    sin, cos = torch.sin(angles), torch.cos(angles)
    m = (yarn_mscale(yarn[0], yarn[4]) / yarn_mscale(yarn[0], yarn[5])
         if yarn else 1.0)
    return (sin, cos) if m == 1.0 else (sin * m, cos * m)


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
                    window: Optional[int] = None, kv_len=None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention in f32.  q:(B,Sq,H,D) k,v:(B,Sk,H,D);
    ``scale`` defaults to 1 / sqrt(D)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
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
                        q_offset: int = 0, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The flash-attention algorithm written with tensor ops: a loop over KV
    blocks with running (max, sum, acc), as the reference's lax.scan;
    ``scale`` defaults to 1 / sqrt(D)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    nblk = -(-sk // block_kv)
    pad = nblk * block_kv - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = 1.0 / math.sqrt(d) if scale is None else scale
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


def attention_core(q, k, v, *, causal: bool, window: Optional[int] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Full-sequence serving attention (prefill, the encoder, cross
    attention): the flash kernel's wrapper.  GQA is native there, so K/V
    are never repeated in memory.  ``scale`` defaults to 1 / sqrt(D)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    return fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal, window=window,
                                  scale=scale)


def train_attention(q, k, v, cfg, *, causal: bool,
                    window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Train-mode attention, selected by ``cfg.attn_impl`` as the
    reference's ``attention_core`` selects it: K/V heads repeated for GQA,
    then ``"blockwise"`` runs ``blockwise_attention`` over blocks of
    ``cfg.attn_block_kv`` keys and ``"dense"`` runs ``dense_attention``,
    both torch ops that autograd differentiates.

    ``"pallas"`` raises: the reference would run its forward-only Pallas
    kernel there, which has no VJP, so neither package can train through
    it, and the port's CUDA kernels have no backward either (their wrappers
    refuse inputs that require grad).  This is a design choice, not a
    fallback: serving calls run the kernels whatever ``attn_impl`` says,
    and training never does."""
    if cfg.attn_impl == "pallas":
        raise NotImplementedError(
            f"{cfg.name}: attn_impl 'pallas' cannot train: the flash kernel "
            f"has no backward (no VJP in the reference either); use "
            f"'blockwise' or 'dense'")
    n_rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(n_rep, dim=2)
    v = v.repeat_interleave(n_rep, dim=2)
    if cfg.attn_impl == "blockwise":
        return blockwise_attention(q, k, v, causal=causal, window=window,
                                   block_kv=cfg.attn_block_kv, scale=scale)
    if cfg.attn_impl == "dense":
        return dense_attention(q, k, v, causal=causal, window=window,
                               scale=scale)
    raise ValueError(f"{cfg.name}: unknown attn_impl {cfg.attn_impl!r}")


# ---------------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------------

def init_attention(generator, cfg, *, lead: tuple = (), device=None) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def mk(shape, axes, **kw):
        return make_param(generator, shape, axes, lead=lead, dtype=cfg.dtype,
                          device=device, **kw)

    p = {
        "wq": mk((d, h, hd), ("embed", "heads", "head_dim"), fan_in=d),
        "wk": mk((d, kv, hd), ("embed", "kv_heads", "head_dim"), fan_in=d),
        "wv": mk((d, kv, hd), ("embed", "kv_heads", "head_dim"), fan_in=d),
        "wo": mk((h, hd, d), ("heads", "head_dim", "embed"), fan_in=h * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = mk((h, hd), ("heads", "head_dim"), zeros=True)
        p["bk"] = mk((kv, hd), ("kv_heads", "head_dim"), zeros=True)
        p["bv"] = mk((kv, hd), ("kv_heads", "head_dim"), zeros=True)
    if cfg.qk_norm:
        p["q_norm"] = init_norm(generator, hd, "rmsnorm", cfg.dtype,
                                lead=lead, device=device)
        p["k_norm"] = init_norm(generator, hd, "rmsnorm", cfg.dtype,
                                lead=lead, device=device)
    return p


def qkv_projections(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor,
                    kv_override: Optional[tuple] = None):
    """q, k, v for x: (B, S, D) -> (B,S,H,hd), (B,S,KV,hd) x2, with bias,
    qk-norm and RoPE applied as the reference orders them.  With
    ``kv_override`` (cross attention) k and v are the given ones, not
    projected from x, and RoPE is not applied."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if kv_override is None:
        k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
        if cfg.qkv_bias:
            k, v = k + p["bk"], v + p["bv"]
    else:
        k, v = kv_override
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q, "rmsnorm")
        k = apply_norm(p["k_norm"], k, "rmsnorm")
    if cfg.rope and kv_override is None:
        sin, cos = rope_table(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    return q, k, v


def attention_block(p: Params, x: torch.Tensor, cfg, *,
                    positions: torch.Tensor, window: Optional[int] = None,
                    causal: bool = True, kv_override: Optional[tuple] = None,
                    return_kv: bool = False, train: bool = False):
    """GQA attention over a full sequence (train, prefill, the encoder).
    x: (B, S, D).

    ``kv_override``: (k, v) for cross attention (encoder-decoder), of
    shape (B, Sk, KV, hd), Sk the encoder's length.  With ``return_kv`` the
    post-RoPE (k, v) come back too, so the caller assembles the KV cache in
    one shot.  ``train`` runs ``train_attention`` (autograd through the
    reference's jnp paths) in place of the flash kernel.  Decode against a
    cache is ``transformer.decode_attention`` (the paged kernel).
    Returns (y, (k, v) or None).
    """
    q, k, v = qkv_projections(p, x, cfg, positions, kv_override)
    if train:
        out = train_attention(q, k, v, cfg, causal=causal, window=window)
    else:
        out = attention_core(q, k, v, causal=causal, window=window)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, ((k, v) if return_kv else None)


# ---------------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------------

def init_mlp(generator, cfg, d_ff: Optional[int] = None, *, lead: tuple = (),
             device=None) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff

    def mk(shape, axes, fan_in):
        return make_param(generator, shape, axes, lead=lead, fan_in=fan_in,
                          dtype=cfg.dtype, device=device)

    up, down = ("embed", "mlp"), ("mlp", "embed")
    if cfg.mlp_kind == "swiglu":
        return {"wi": mk((d, f), up, d), "wg": mk((d, f), up, d),
                "wo": mk((f, d), down, f)}
    return {"wi": mk((d, f), up, d), "wo": mk((f, d), down, f)}


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with the reference's rounding: XLA computes a bf16
    logistic as 1 / (1 + exp(-x)) rounding every step to bf16, where
    ``F.silu`` rounds once; elementwise torch ops on a bf16 tensor round
    each step the same way."""
    return x * (1 / (1 + torch.exp(-x)))


#: (dtype, device) -> GELU's two constants in that dtype, made once (each
#: an upload, as ``_ROPE_FREQS``'s)
_GELU_CONSTANTS: dict[tuple, tuple] = {}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its tanh form) with the reference's rounding:
    ``x * (0.5 * (1 + tanh(c * (x + k * x**3))))`` where XLA rounds every
    step, ``x**3`` as ``(x * x) * x``, and the constants ``k = 0.044715``
    and ``c = sqrt(2 / pi)`` themselves, to x's dtype (read from the
    compiled HLO); ``F.gelu`` rounds once."""
    key = (x.dtype, x.device)
    if key not in _GELU_CONSTANTS:
        _GELU_CONSTANTS[key] = tuple(
            torch.tensor(v, dtype=x.dtype, device=x.device)
            for v in (0.044715, math.sqrt(2 / math.pi)))
    k, c = _GELU_CONSTANTS[key]
    cdf = 0.5 * (1 + torch.tanh(c * (x + k * (x * x * x))))
    return x * cdf


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
        h = gelu(h)
    else:
        raise ValueError(cfg.mlp_kind)
    return torch.einsum("bsf,fd->bsd", h, p["wo"])


# ---------------------------------------------------------------------------------
# MLA attention (deepseek-v2, deepseek-v3): latent KV cache
# ---------------------------------------------------------------------------------

def init_mla(generator, cfg, *, lead: tuple = (), device=None) -> Params:
    """MLA's leaves; with ``cfg.q_lora_rank`` the query runs through a
    low-rank latent (``wdq``, ``q_norm``, ``wuq``) in place of ``wq``."""
    d, h = cfg.d_model, cfg.n_heads
    dc, dr = cfg.kv_lora_rank, cfg.rope_head_dim
    dn, dv = cfg.nope_head_dim, cfg.v_head_dim
    dq = cfg.q_lora_rank

    def mk(shape, axes, fan_in):
        return make_param(generator, shape, axes, lead=lead, fan_in=fan_in,
                          dtype=cfg.dtype, device=device)

    if dq:
        p = {"wdq": mk((d, dq), ("embed", "q_lora"), d),
             "q_norm": init_norm(generator, dq, "rmsnorm", cfg.dtype,
                                 lead=lead, device=device),
             "wuq": mk((dq, h, dn + dr), ("q_lora", "heads", "head_dim"), dq)}
    else:
        p = {"wq": mk((d, h, dn + dr), ("embed", "heads", "head_dim"), d)}
    return p | {
        "wdkv": mk((d, dc + dr), ("embed", "kv_lora"), d),
        "kv_norm": init_norm(generator, dc, "rmsnorm", cfg.dtype, lead=lead,
                             device=device),
        "wuk": mk((dc, h, dn), ("kv_lora", "heads", "head_dim"), dc),
        "wuv": mk((dc, h, dv), ("kv_lora", "heads", "head_dim"), dc),
        "wo": mk((h, dv, d), ("heads", "head_dim", "embed"), h * dv),
    }


def mla_softmax_scale(cfg) -> float:
    """1 / sqrt(nope + rope), times YaRN's mscale(factor, mscale_all_dim)
    squared where the config scales its rope so."""
    scale = 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)
    if cfg.yarn and cfg.yarn[5]:
        m = yarn_mscale(cfg.yarn[0], cfg.yarn[5])
        scale = scale * m * m
    return scale


def mla_latents(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor):
    """q_nope, q_pe (post-RoPE), the normed latent c and the shared
    post-RoPE rope key k_pe of x: (B, S, D).  Ranges ``model/mla/q`` (the
    query, through its latent where the config has one) and
    ``model/mla/latent``."""
    dc, dr, dn = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.nope_head_dim
    sin, cos = rope_table(positions, dr, cfg.rope_theta, cfg.yarn)
    with span("model/mla/q"):
        if cfg.q_lora_rank:
            cq = torch.einsum("bsd,dq->bsq", x, p["wdq"])
            cq = apply_norm(p["q_norm"], cq, "rmsnorm")
            q = torch.einsum("bsq,qhk->bshk", cq, p["wuq"])
        else:
            q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        q_nope, q_pe = q[..., :dn], apply_rope(q[..., dn:], sin, cos)
    with span("model/mla/latent"):
        ckv = torch.einsum("bsd,dk->bsk", x, p["wdkv"])
        c, k_pe = ckv[..., :dc], ckv[..., dc:]
        c = apply_norm(p["kv_norm"], c, "rmsnorm")
        k_pe = apply_rope(k_pe[:, :, None, :], sin, cos)[:, :, 0, :]
    return q_nope, q_pe, c, k_pe


def mla_block(p: Params, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              return_kv: bool = False, train: bool = False):
    """Multi-head latent attention over a full sequence (train, prefill):
    K/V are decompressed per head and run through the flash kernel (train:
    ``train_attention``) at head dim ``nope + rope`` with V zero-padded to
    it, then sliced back to ``v_head_dim`` (range ``model/mla/core``), at
    ``mla_softmax_scale``.  With ``return_kv`` the post-RoPE latents (c,
    k_pe) come back for one-shot cache assembly.  Decode is
    ``mla_decode``."""
    b, s, _ = x.shape
    h, dr = cfg.n_heads, cfg.rope_head_dim
    dn, dv = cfg.nope_head_dim, cfg.v_head_dim
    q_nope, q_pe, c, k_pe = mla_latents(p, x, cfg, positions)
    # without YaRN the kernel's own 1 / sqrt(D), D = nope + rope
    scale = {"scale": mla_softmax_scale(cfg)} if cfg.yarn else {}
    with span("model/mla/core"):
        k_nope = torch.einsum("btc,chn->bthn", c, p["wuk"])
        v = torch.einsum("btc,chv->bthv", c, p["wuv"])
        k_full = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, s, h, dr)],
                           dim=-1)
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        v_full = F.pad(v, (0, dn + dr - dv))
        if train:
            out = train_attention(q_full, k_full, v_full, cfg, causal=True,
                                  **scale)
        else:
            out = attention_core(q_full, k_full, v_full, causal=True,
                                 **scale)
    with span("model/mla/out"):
        y = torch.einsum("bshv,hvd->bsd", out[..., :dv], p["wo"])
    return y, ((c, k_pe) if return_kv else None)


def mla_decode(p: Params, x: torch.Tensor, cfg, *, positions: torch.Tensor,
               cache: dict, cache_index: torch.Tensor, slots: torch.Tensor):
    """One new token per row against the latent cache, *in place*: row
    ``i`` writes (c, k_pe) at ``[slots[i], cache_index[i]]`` (no ring;
    ``pos`` keeps its prefill values, as the reference leaves it) and
    attends in the absorbed form, W_uk folded into q, over its slot's
    positions ``0 .. cache_index[i]``.  The products take bf16 operands
    with f32 sums: the operands are widened to f32, whose products of bf16
    values are exact, as the reference computes them off the TPU.  Ranges
    ``model/mla/q`` (with the absorption), ``latent``, ``core`` (the
    cache write and the attention) and ``out``; ``positions_read`` counts
    the latent positions the core reads, every row's whole cache."""
    q_nope, q_pe, c, k_pe = mla_latents(p, x, cfg, positions)
    with span("model/mla/q"):
        q_c = torch.einsum("bshn,chn->bshc", q_nope, p["wuk"])
    with span("model/mla/core"):
        core = functools.partial(_mla_core, scale=mla_softmax_scale(cfg))
        o_c = cache_step(core, (q_c, q_pe, c, k_pe), cache, cache_index,
                         slots)
    mla_decode.positions_read += q_c.shape[0] * cache["c"].shape[1]
    with span("model/mla/out"):
        out = torch.einsum("bshc,chv->bshv", o_c,
                           p["wuv"].float()).to(x.dtype)
        return torch.einsum("bshv,hvd->bsd", out, p["wo"])


#: the latent positions ``mla_decode`` reads, rows times the cache's
#: length a call and layer: counted from shapes, no device read
host_counter(mla_decode, "positions_read")


def _mla_core(q_c, q_pe, c, k_pe, cache, cache_index, rows, *, scale):
    """MLA decode's cache write and absorbed attention over rows ``rows``:
    returns the latent output o_c (b, 1, h, dc) in f32."""
    cc, ck = cache["c"], cache["k_pe"]
    rows, idx = rows.to(torch.int64), cache_index.to(torch.int64)
    cc[rows, idx] = c[:, 0].to(cc.dtype)
    ck[rows, idx] = k_pe[:, 0].to(ck.dtype)
    lat, rope_k = cc[rows].float(), ck[rows].float()     # (b, T, dc), (b, T, dr)
    logits = (torch.einsum("bshc,btc->bhst", q_c.float(), lat)
              + torch.einsum("bshr,btr->bhst", q_pe.float(), rope_k)) * scale
    tpos = torch.arange(cc.shape[1], device=q_c.device)
    mask = tpos[None, :] <= idx[:, None]                 # (b, T)
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,btc->bshc", probs, lat)


def cache_step(core, tokens: tuple, cache: dict, cache_index, slots):
    """``core(*tokens, cache, cache_index, rows)``: one decode step's cache
    write and attention.

    ``slots`` None is the dry run's whole-batch step on meta DTensor
    caches, sharded on batch and on the sequence ("model"): it runs
    context-parallel, ``core`` on each rank's local shards, the step's
    tokens gathered to every head of the rank's batch rows (that
    collective is counted) over the rank's sequence shard of the cache;
    the ranks' outputs are partial sums over the model axis (``Partial``),
    reduced back to the tokens' placements (the merge stands in for a
    log-sum-exp combine of the same size).  The local token shards are
    built from the cache's row count: meta carries shapes only, and this
    holds whatever local shapes a torch version's redistribution gives
    (torch 2.11's differed from 2.13's on the multi-pod mesh)."""
    if slots is not None:
        return core(*tokens, cache, cache_index, slots)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    names = list(cache)
    leaves = [cache[n] for n in names]
    mesh = leaves[0].device_mesh
    if leaves[0].to_local().device.type != "meta":
        raise NotImplementedError(
            "a whole-batch decode step on DTensor caches is the dry run's "
            "shape analysis (meta); give the rows' slots")
    cache_pl = leaves[0].placements
    row = [Shard(0) if pl == Shard(0) else Replicate() for pl in cache_pl]
    out = [Partial() if pl == Shard(1) else r for pl, r in zip(cache_pl, row)]
    b_loc = leaves[0].to_local().shape[0]
    local = []
    for t in (cache_index, *tokens):
        t = t.redistribute(mesh, row)
        local.append(torch.empty((b_loc,) + tuple(t.shape[1:]),
                                 dtype=t.dtype, device="meta"))
    idx, *toks = local
    y = core(*toks, {n: t.to_local() for n, t in zip(names, leaves)}, idx,
             torch.arange(b_loc, device="meta"))
    y = DTensor.from_local(y, mesh, out, run_check=False)
    back = [Replicate() if pl.is_partial() else pl
            for pl in tokens[0].placements]
    return y.redistribute(mesh, back)


# ---------------------------------------------------------------------------------
# MoE: shared + routed top-k experts, capacity-based dispatch (one device,
# or expert-parallel over a mesh)
# ---------------------------------------------------------------------------------

def init_moe(generator, cfg, *, lead: tuple = (), device=None) -> Params:
    """The router over every routed expert (with the sigmoid router's
    f32 correction bias ``router_bias``), the weights of the experts held
    here (``cfg.experts_here``) and the shared experts."""
    d, f, e = cfg.d_model, cfg.d_expert, cfg.n_routed_experts
    e_here = cfg.experts_here

    def mk(shape, axes, fan_in, dtype=cfg.dtype):
        return make_param(generator, shape, axes, lead=lead, fan_in=fan_in,
                          dtype=dtype, device=device)

    up = ("expert", "embed", "mlp")
    p = {"router": mk((d, e), ("embed", "expert"), d, torch.float32)}
    if cfg.router_scoring == "sigmoid_noaux_tc":
        p["router_bias"] = mk((e,), ("expert",), e, torch.float32)
    p |= {"wi": mk((e_here, d, f), up, d), "wg": mk((e_here, d, f), up, d),
          "wo": mk((e_here, f, d), ("expert", "mlp", "embed"), f)}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(generator, cfg,
                               d_ff=cfg.d_expert * cfg.n_shared_experts,
                               lead=lead, device=device)
    return p


def moe_capacity(t: int, cfg, *, capacity_factor: float,
                 no_drop: bool) -> int:
    """Token slots per expert: every token (decode) or
    ``max(k, ceil(t*k/e*capacity_factor))``, in the reference's float
    order."""
    k, e = cfg.moe_top_k, cfg.n_routed_experts
    if no_drop:
        return t
    return int(max(k, math.ceil(t * k / e * capacity_factor)))


def moe_dispatch(idx: torch.Tensor, n_experts: int, capacity: int,
                 local: Optional[torch.Tensor] = None):
    """Slots of the flattened (t, k) assignments: each assignment's place
    in its expert's queue (cumsum in assignment order), kept below
    ``capacity``; a dropped one goes to the waste slot ``capacity``.
    ``local`` (t, k) marks the assignments to experts this rank owns
    (expert parallel; ``idx`` then holds local ids); the others take no
    slot and are not kept.  Returns (flat expert ids, slots, kept), each
    (t*k,)."""
    flat = idx.reshape(-1)
    onehot = F.one_hot(flat, n_experts).to(torch.int32)
    if local is not None:
        # few experts a rank: a scan down each expert's column of (t*k,
        # e) runs one thread a column, so each is scanned as a row
        onehot = (onehot * local.reshape(-1, 1)).t().contiguous()
        pos = (torch.cumsum(onehot, dim=1) - 1).t()
    else:
        pos = torch.cumsum(onehot, dim=0) - 1
    pos = torch.gather(pos, 1, flat[:, None])[:, 0]
    keep = pos < capacity
    if local is not None:
        keep = keep & local.reshape(-1)
    slot = torch.where(keep, pos, torch.full_like(pos, capacity))
    return flat, slot.to(torch.int64), keep


def moe_expert_compute(x, idx, gates, wi, wg, wo, *, capacity: int,
                       dtype, e_offset: int = 0,
                       e_total: Optional[int] = None) -> torch.Tensor:
    """Routed experts ``e_offset .. e_offset + e_loc - 1`` (``wi``'s
    leading dim, of ``e_total``; default all of them) on one device.
    x: (t, d); idx/gates: (t, k) global expert ids.

    The kept assignments scatter into an (e_loc, capacity + 1, d) buffer
    whose last slot absorbs the dropped ones (as zeros) and is discarded;
    each expert runs its SwiGLU over its ``capacity`` slots as a batched
    matmul (every expert's weights are read, as the reference's dense
    dispatch reads them), and the outputs gather back weighted by the
    gates.  Assignments to other ranks' experts contribute nothing here
    (expert parallel: the caller sums the ranks' outputs).  Returns y
    (t, d) in f32."""
    t, d = x.shape
    e, k = wi.shape[0], idx.shape[-1]
    local = None
    with span("model/moe/dispatch"):            # slots, scatter into them
        if e_total is not None and e != e_total:
            local = (idx >= e_offset) & (idx < e_offset + e)
            idx = torch.where(local, idx - e_offset, torch.zeros_like(idx))
        flat, slot, keep = (moe_dispatch(idx, e, capacity) if local is None
                            else moe_dispatch(idx, e, capacity, local))
        if x.device.type == "cpu":
            # an accumulating scatter is deterministic on the card only if
            # no two kept assignments share a slot: duplicates are the
            # waste slot's, which add zeros and are discarded
            pairs = flat[keep] * (capacity + 1) + slot[keep]
            assert pairs.unique().numel() == pairs.numel(), \
                "two kept MoE assignments share an expert slot"
        buf = torch.zeros((e, capacity + 1, d), dtype=dtype, device=x.device)
        src = x.repeat_interleave(k, dim=0).to(dtype)
        src = torch.where(keep[:, None], src, torch.zeros_like(src))
        # with a share of the experts most assignments are other ranks':
        # all go to one waste slot, whose duplicates the accumulating
        # scatter serialises, so they are written (zeros over zeros)
        buf.index_put_((flat, slot), src, accumulate=local is None)
        buf = buf[:, :capacity]
    with span("model/moe/experts"):             # SwiGLU, gated gather back
        hg = silu(torch.einsum("ecd,edf->ecf", buf, wg))
        hi = torch.einsum("ecd,edf->ecf", buf, wi)
        out = torch.einsum("ecf,efd->ecd", hg * hi, wo)
        out = F.pad(out, (0, 0, 0, 1))                   # waste slot reads 0
        gathered = out[flat, slot]                       # (t*k, d)
        w = (gates.reshape(t * k) * keep).float()
        return (gathered.float() * w[:, None]).reshape(t, k, d).sum(dim=1)


def grouped_topk(biased: torch.Tensor, cfg) -> torch.Tensor:
    """``noaux_tc``'s choice (..., e) -> (..., k) expert ids: the experts
    fall into ``cfg.router_groups`` groups of consecutive ids, a group
    scores the sum of its two best ``biased`` scores, the
    ``router_topk_groups`` best groups are kept and the top k of their
    experts chosen."""
    *lead, e = biased.shape
    groups = biased.reshape(*lead, cfg.router_groups, e // cfg.router_groups)
    group_score = groups.topk(2, dim=-1).values.sum(-1)
    kept = torch.topk(group_score, cfg.router_topk_groups, dim=-1).indices
    mask = torch.zeros_like(group_score, dtype=torch.bool).scatter_(
        -1, kept, True)
    masked = groups.masked_fill(~mask[..., None], float("-inf"))
    return torch.topk(masked.reshape(*lead, e), cfg.moe_top_k,
                      dim=-1).indices


def moe_route(p: Params, x: torch.Tensor, cfg):
    """The f32 router.  "softmax": softmax over experts, top-k;
    "sigmoid_noaux_tc": sigmoid scores, the experts ``grouped_topk`` picks
    from the scores plus ``router_bias``, gated by the unbiased scores.
    Gates renormalised, then times ``cfg.router_scale``.  Returns (probs
    (g,s,e), gates (g,s,k), idx (g,s,k))."""
    logits = torch.einsum("gsd,de->gse", x.float(), p["router"])
    if cfg.router_scoring == "softmax":
        probs = torch.softmax(logits, dim=-1)
        gates, idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    elif cfg.router_scoring == "sigmoid_noaux_tc":
        probs = torch.sigmoid(logits)
        idx = grouped_topk(probs + p["router_bias"], cfg)
        gates = torch.gather(probs, -1, idx)
    else:
        raise ValueError(f"{cfg.name}: unknown router_scoring "
                         f"{cfg.router_scoring!r}")
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    if cfg.router_scale != 1.0:
        gates = gates * cfg.router_scale
    return probs, gates, idx


#: expert-parallel execution context, installed by the launcher alongside
#: the activation resolver: (mesh, data_axes, model_axis) or None for local
#: runs
_MOE_CONTEXT: dict = {"mesh": None, "data_axes": (), "model_axis": None}


def set_moe_mesh(mesh, data_axes: tuple, model_axis: Optional[str]) -> None:
    """Run MoE expert-parallel over ``mesh``'s ``model_axis`` (None:
    every expert on one device)."""
    _MOE_CONTEXT.update(mesh=mesh, data_axes=tuple(data_axes),
                        model_axis=model_axis)


def _ep_degree(e: int) -> int:
    """Ranks the experts spread over (0: no expert parallelism)."""
    mesh, axis = _MOE_CONTEXT["mesh"], _MOE_CONTEXT["model_axis"]
    if mesh is None or axis is None:
        return 0
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    return n if e % n == 0 else 0


def moe_block(p: Params, x: torch.Tensor, cfg, *,
              capacity_factor: float = 1.25,
              no_drop: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed + shared experts.  Returns (y, aux): aux the
    Switch-style load-balancing loss.  ``no_drop``: capacity is every
    token, so decode routes exactly.

    A share (``cfg.experts_held``): the router routes over every expert,
    the experts held here compute their part of the result
    (``moe_expert_compute``'s ``e_offset`` / ``e_total``) at the capacity
    reckoned over all of them, the shared experts run whole; what the
    other experts would add is left out, as on one rank of an
    expert-parallel deployment without its exchange.  A decode call adds
    the assignments that fall to the held experts to
    ``decode_held_assignments`` on the device.

    Expert parallel (``set_moe_mesh``, the experts divide the model axis):
    a ``local_map`` over the mesh, the reference's ``shard_map``.  The
    expert weights are ``Shard(0)`` on the model axis and the tokens
    sharded on the data axes; each rank scatters its tokens' assignments
    to its ``e_loc`` experts (``e_offset = rank * e_loc``) into a local
    capacity buffer, computes them, and the ranks' partial outputs are
    summed by an all-reduce over the model axis (``Partial`` ->
    ``Replicate``), the reference's ``lax.psum``.  The capacity comes from
    the tokens of one data shard, as the reference's does."""
    g, s, d = x.shape
    e, k = cfg.n_routed_experts, cfg.moe_top_k
    with span("model/moe/route"):               # router, top-k, aux loss
        probs, gates, idx = moe_route(p, x, cfg)
        me = probs.mean(dim=(0, 1))
        ce = probs.new_zeros(e).index_add_(
            0, idx.reshape(-1), torch.ones_like(idx.reshape(-1), dtype=F32)
        ) / (g * s * k)
        aux = e * torch.sum(me * ce)
    n_model = _ep_degree(e)
    if n_model and cfg.experts_held:
        raise NotImplementedError(f"{cfg.name}: a share of the experts "
                                  f"under an expert-parallel mesh")
    if not n_model:
        t = g * s
        capacity = moe_capacity(t, cfg, capacity_factor=capacity_factor,
                                no_drop=no_drop)
        share = {}
        if cfg.experts_held:
            share = dict(e_offset=cfg.experts_offset, e_total=e)
        if no_drop:
            moe_block.decode_assignments += t * k
            moe_block.decode_slots += cfg.experts_here * capacity
            if share:
                off = cfg.experts_offset
                moe_block.decode_held_assignments.add(
                    ((idx >= off) & (idx < off + cfg.experts_held)).sum())
        y = moe_expert_compute(x.reshape(t, d), idx.reshape(t, k),
                               gates.reshape(t, k), p["wi"], p["wg"],
                               p["wo"], capacity=capacity, dtype=cfg.dtype,
                               **share)
    else:
        y = _moe_expert_parallel(p, x, idx, gates, cfg, n_model,
                                 capacity_factor=capacity_factor,
                                 no_drop=no_drop)
    y = y.to(x.dtype).reshape(g, s, d)
    if cfg.n_shared_experts:
        with span("model/moe/shared"):
            y = y + mlp_block(p["shared"], x, cfg)
    return y, aux


#: on one device, the routed assignments (t * k, over every expert) and the
#: expert slots computed (the experts held here times the capacity) of
#: every ``no_drop`` (decode) call: counted from shapes, no device read
host_counter(moe_block, "decode_assignments")
host_counter(moe_block, "decode_slots")
#: under a share, the decode assignments that fall to the held experts: a
#: count of the data, tallied on the device (``kernels.DeviceTally``)
device_counter(moe_block, "decode_held_assignments")


def _moe_expert_parallel(p: Params, x, idx, gates, cfg, n_model: int, *,
                         capacity_factor: float, no_drop: bool):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = _MOE_CONTEXT["mesh"]
    model_axis = _MOE_CONTEXT["model_axis"]
    data_axes = _MOE_CONTEXT["data_axes"]
    names = mesh.mesh_dim_names
    g, s, d = x.shape
    e, k = cfg.n_routed_experts, cfg.moe_top_k
    n_data = math.prod(mesh.size(names.index(a)) for a in data_axes)
    g_loc = max(1, g // n_data) if g % n_data == 0 else g
    capacity = moe_capacity(g_loc * s, cfg, capacity_factor=capacity_factor,
                            no_drop=no_drop)
    e_loc = e // n_model
    e_offset = mesh.get_local_rank(model_axis) * e_loc
    shard_batch = g % n_data == 0
    tok = tuple(Shard(0) if (a in data_axes and shard_batch) else Replicate()
                for a in names)
    part = tuple(Partial() if a == model_axis else pl
                 for a, pl in zip(names, tok))
    wpl = tuple(Shard(0) if a == model_axis else Replicate() for a in names)

    def body(x_blk, idx_blk, gates_blk, wi_l, wg_l, wo_l):
        gb = x_blk.shape[0]
        y_loc = moe_expert_compute(
            x_blk.reshape(gb * s, d), idx_blk.reshape(gb * s, k),
            gates_blk.reshape(gb * s, k), wi_l, wg_l, wo_l,
            capacity=capacity, dtype=cfg.dtype, e_offset=e_offset,
            e_total=e)
        return y_loc.reshape(gb, s, d)

    args = [t if isinstance(t, DTensor)
            else DTensor.from_local(t, mesh, tok, run_check=False)
            for t in (x, idx, gates)]
    y = local_map(body, out_placements=list(part),
                  in_placements=(tok, tok, tok, wpl, wpl, wpl),
                  device_mesh=mesh, redistribute_inputs=True)(
        *args, p["wi"], p["wg"], p["wo"])
    return y.redistribute(mesh, tok)                 # EP combine: all-reduce


# ---------------------------------------------------------------------------------
# Sharding hint plumbing (resolved by shardings.py when a mesh is active)
# ---------------------------------------------------------------------------------

_ACTIVATION_RULES: dict[str, Any] = {"resolver": None}


def set_activation_resolver(fn) -> None:
    """Install a fn(logical_axes, shape) -> (mesh, placements) or None
    (``ShardingRules.resolver``); None uninstalls it."""
    _ACTIVATION_RULES["resolver"] = fn


def gather_for_use(params):
    """FSDP's gather-on-use (the reference's ZeRO-3 layout, "embed" ->
    "data"): with a resolver installed, every DTensor parameter sharded on
    a data axis ("pod", "data") is all-gathered there before the step
    uses it, so its products shard the batch, not the contraction; in a
    train step autograd returns its gradient by reduce-scatter.  The tree
    itself is returned with no resolver, as on the serving and training
    paths."""
    if _ACTIVATION_RULES["resolver"] is None:
        return params
    from torch.distributed.tensor import DTensor, Replicate

    def one(t):
        if not isinstance(t, DTensor):
            return t
        names = t.device_mesh.mesh_dim_names
        pl = tuple(Replicate() if n in ("pod", "data") and p.is_shard()
                   else p for n, p in zip(names, t.placements))
        return t if pl == tuple(t.placements) else t.redistribute(
            t.device_mesh, pl)
    from repro_torch.training.optimizer import tree_map
    return tree_map(one, params)


def shard_hint(x: torch.Tensor, logical: tuple) -> torch.Tensor:
    """``x`` redistributed to the placements the resolver gives its
    logical axes (the reference's ``with_sharding_constraint``).  The
    identity with no resolver, for a plain tensor, or where the resolver
    gives none."""
    resolver = _ACTIVATION_RULES["resolver"]
    if resolver is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    got = resolver(logical, tuple(x.shape))
    if got is None:
        return x
    mesh, pl = got
    if tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(mesh, pl)
