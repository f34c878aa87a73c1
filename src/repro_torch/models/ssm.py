"""Recurrent sequence-mixing blocks: xLSTM's mLSTM and sLSTM, and the
Mamba-2 (SSD) heads of hymba's hybrid blocks.

PyTorch counterpart of ``repro.models.ssm``, in its parameter layouts.  The mLSTM prefill (``mlstm_chunked``) runs its
chunkwise-parallel scan through the chunked mLSTM kernel's wrapper
(``kernels/mlstm_scan/ops.py``): the hand-written CUDA kernel for tensors on
the card, its plain version (the reference's per-chunk body, op for op)
for tensors on the CPU.  The one-token decode steps and the sLSTM
recurrence (a Python loop over time: its hidden-to-gate dependency is
sequential) are plain torch, as the reference has no kernel for them.

State structures (decode), as the reference's:
  mLSTM: {"C": (B,H,dk,dv), "n": (B,H,dk), "m": (B,H)}, f32
  sLSTM: {"c", "n", "h", "m"}: (B, inner), f32
  Mamba-2: {"ssm": (B,H,dh,N) f32, "conv": (B, conv_width-1, e)}; the
           empty state's ``conv`` is f32, a prefill returns it in the
           input's dtype (bf16), and ``_mamba_proj`` casts it back to that
           dtype before the convolution, as the reference does.
The Mamba-2 chunked scan (``mamba_chunked``) is jnp code in the reference
(a ``KERNEL_ssd_scan`` scope, not a Pallas kernel) and plain torch here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import repeated
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops
from repro_torch.kernels.mlstm_scan.ref import mlstm_chunked_ref

from .layers import (Params, apply_norm, init_norm, make_param, shard_hint,
                     silu)

F32 = torch.float32
#: the reference's mLSTM prefill chunk (``mlstm_chunked(chunk=256)``)
MLSTM_CHUNK = 256


def mlstm_dims(cfg) -> tuple[int, int, int, int]:
    """(inner, heads, dk, dv): q/k heads are half the value head width."""
    inner = cfg.ssm_expand * cfg.d_model
    h = cfg.n_heads
    dh = inner // h
    return inner, h, dh // 2, dh


# ---------------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory block)
# ---------------------------------------------------------------------------------

def init_mlstm(generator, cfg, *, device=None) -> Params:
    d = cfg.d_model
    inner, h, dk, dh = mlstm_dims(cfg)

    def mk(shape, axes, fan_in, dtype=cfg.dtype, **kw):
        return make_param(generator, shape, axes, fan_in=fan_in, dtype=dtype,
                          device=device, **kw)

    qkv = ("mlp", "heads", "head_dim")
    return {
        "w_up": mk((d, 2 * inner), ("embed", "mlp"), d),
        "wq": mk((inner, h, dk), qkv, inner),
        "wk": mk((inner, h, dk), qkv, inner),
        "wv": mk((inner, h, dh), qkv, inner),
        "wi": mk((inner, h), ("mlp", "heads"), inner, F32),
        "wf": mk((inner, h), ("mlp", "heads"), inner, F32),
        "bf": mk((h,), ("heads",), None, F32, ones=True),
        "out_norm": init_norm(generator, inner, "rmsnorm", cfg.dtype,
                              device=device),
        "w_down": mk((inner, d), ("mlp", "embed"), inner),
    }


def _mlstm_gates(p, u):
    """u: (B,S,inner) -> per-head q, k, v and log gates."""
    q = torch.einsum("bse,ehk->bshk", u, p["wq"])
    k = torch.einsum("bse,ehk->bshk", u, p["wk"])
    v = torch.einsum("bse,ehk->bshk", u, p["wv"])
    uf = u.float()
    log_i = torch.einsum("bse,eh->bsh", uf, p["wi"])      # pre-act input gate
    log_f = F.logsigmoid(torch.einsum("bse,eh->bsh", uf, p["wf"]) + p["bf"])
    return q, k, v, log_i, log_f


def _mlstm_out(p, y, z):
    """Output norm, SiLU gate and down projection: (B,S,inner) -> (B,S,D)."""
    y = apply_norm(p["out_norm"], y, "rmsnorm") * silu(z)
    return torch.einsum("bse,ed->bsd", y, p["w_down"])


def mlstm_chunked(p: Params, x: torch.Tensor, cfg, *,
                  chunk: int = MLSTM_CHUNK, state: Optional[dict] = None,
                  use_kernel: bool = True):
    """Chunkwise-parallel mLSTM forward with stabilised exponential gating.

    Returns (y, final_state).  The scan (q pre-scaled and q/k/v in f32, as
    the reference computes them) is the mLSTM kernel's; ``use_kernel=False``
    (train mode) runs the torch chunked scan (``ref.mlstm_chunked_ref``)
    instead, which autograd differentiates, as the reference trains through
    its jnp scan (``mlstm_chunked(use_kernel=False)``)."""
    b, s, _ = x.shape
    inner, h, dk, dh = mlstm_dims(cfg)
    up = torch.einsum("bsd,de->bse", x, p["w_up"])
    u, z = up[..., :inner], up[..., inner:]
    q, k, v, log_i, log_f = _mlstm_gates(p, u)
    scale = 1.0 / math.sqrt(dk)
    # the scan's inputs placed by their logical axes (identity off a mesh):
    # left to DTensor, the chunked scan's reshapes would split batch x
    # heads over every rank, unevenly on the multi-pod mesh
    heads = ("batch", "seq", "heads", "head_dim")
    q, k, v = (shard_hint(t, heads) for t in (q, k, v))
    log_i, log_f = (shard_hint(t, heads[:3]) for t in (log_i, log_f))
    qc = (q.float() * scale).contiguous()
    kc, vc = k.float().contiguous(), v.float().contiguous()
    init = None if state is None else (state["C"], state["n"], state["m"])
    scan = mlstm_ops.mlstm_scan if use_kernel else mlstm_chunked_ref
    y, (C, n, m) = scan(
        qc, kc, vc, log_i.contiguous(), log_f.contiguous(), chunk=chunk,
        initial_state=init)
    y = y.reshape(b, s, inner).to(x.dtype)
    return _mlstm_out(p, y, z), {"C": C, "n": n, "m": m}


def mlstm_step(p: Params, x: torch.Tensor, cfg, state: dict):
    """Single-token decode step.  x: (B,1,D)."""
    b = x.shape[0]
    inner, h, dk, dh = mlstm_dims(cfg)
    up = torch.einsum("bsd,de->bse", x, p["w_up"])
    u, z = up[..., :inner], up[..., inner:]
    q, k, v, log_i, log_f = _mlstm_gates(p, u)
    # the reference divides by sqrt(dk); its compiled decode multiplies by
    # the f32 reciprocal instead, which rounds differently
    inv = torch.tensor(math.sqrt(dk), dtype=F32).reciprocal().item()
    q = q[:, 0].float() * inv
    k, v = k[:, 0].float(), v[:, 0].float()
    li, lf = log_i[:, 0], log_f[:, 0]                      # (b,h)
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, li)
    fw = torch.exp(lf + m - m_new)
    iw = torch.exp(li - m_new)
    C = (C * fw[..., None, None]
         + iw[..., None, None] * k[..., :, None] * v[..., None, :])
    n = n * fw[..., None] + iw[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", q, n)),
                        torch.exp(-m_new))
    y = (num / den[..., None]).reshape(b, 1, inner).to(x.dtype)
    return _mlstm_out(p, y, z), {"C": C, "n": n, "m": m_new}


def init_mlstm_state(b: int, cfg, *, device=None) -> dict:
    _, h, dk, dh = mlstm_dims(cfg)
    return {"C": torch.zeros((b, h, dk, dh), dtype=F32, device=device),
            "n": torch.zeros((b, h, dk), dtype=F32, device=device),
            "m": torch.full((b, h), -1e30, dtype=F32, device=device)}


# ---------------------------------------------------------------------------------
# sLSTM (xLSTM scalar-memory block): inherently sequential
# ---------------------------------------------------------------------------------

def init_slstm(generator, cfg, *, device=None) -> Params:
    d = cfg.d_model
    inner = cfg.ssm_expand * d

    def mk(shape, axes, fan_in, dtype=F32, **kw):
        return make_param(generator, shape, axes, fan_in=fan_in, dtype=dtype,
                          device=device, **kw)

    return {"w_in": mk((d, 4 * inner), ("embed", "mlp"), d),
            "r": mk((inner, 4), ("mlp", None), 1),
            "b": mk((4 * inner,), ("mlp",), None, zeros=True),
            "out_norm": init_norm(generator, inner, "rmsnorm", cfg.dtype,
                                  device=device),
            "w_down": mk((inner, d), ("mlp", "embed"), inner, cfg.dtype),
            "w_z": mk((d, inner), ("embed", "mlp"), d, cfg.dtype)}


def _slstm_cell(p, xt, state):
    """xt: (B, 4*inner) pre-activations; diagonal recurrence (per-unit R).

    The four gates' recurrent terms ``hprev * r[:, j]`` are one broadcast
    product and ``log_f + m`` is formed once: the same elementwise values
    as the reference's, in fewer launches (this runs once per timestep)."""
    c, n, hprev, m = state
    b, inner = hprev.shape
    rec = (hprev[:, None, :] * p["r"].T[None]).reshape(b, 4 * inner)
    zi, ii, fi, oi = torch.chunk(xt + rec, 4, dim=-1)
    zt = torch.tanh(zi)
    log_i = ii
    log_f = F.logsigmoid(fi)
    o = torch.sigmoid(oi)
    lfm = log_f + m
    m_new = torch.maximum(lfm, log_i)
    iw = torch.exp(log_i - m_new)
    fw = torch.exp(lfm - m_new)
    c_new = fw * c + iw * zt
    n_new = fw * n + iw
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new)


def slstm_forward(p: Params, x: torch.Tensor, cfg,
                  state: Optional[dict] = None):
    b, s, d = x.shape
    inner = cfg.ssm_expand * d
    pre = torch.einsum("bsd,dk->bsk", x.float(), p["w_in"]) + p["b"]
    z = torch.einsum("bsd,de->bse", x, p["w_z"])
    if state is None:
        st = tuple(v for v in init_slstm_state(b, cfg,
                                               device=x.device).values())
    else:
        st = (state["c"], state["n"], state["h"], state["m"])
    hs = []
    if x.device.type == "meta" and s > 1:
        # shape analysis (the dry run): one step stands for all s, counted
        # s times (its backward, elementwise only, once)
        with repeated(s):
            st = _slstm_cell(p, pre[:, 0], st)
        hs = [st[2]] * s
    for t in range(len(hs), s):
        st = _slstm_cell(p, pre[:, t], st)
        hs.append(st[2])
    y = torch.stack(hs, dim=1).to(x.dtype)                 # (b,s,inner)
    y = apply_norm(p["out_norm"], y, "rmsnorm") * silu(z)
    y = torch.einsum("bse,ed->bsd", y, p["w_down"])
    return y, {"c": st[0], "n": st[1], "h": st[2], "m": st[3]}


def slstm_step(p: Params, x: torch.Tensor, cfg, state: dict):
    return slstm_forward(p, x, cfg, state)


def init_slstm_state(b: int, cfg, *, device=None) -> dict:
    inner = cfg.ssm_expand * cfg.d_model
    zeros = lambda: torch.zeros((b, inner), dtype=F32, device=device)
    return {"c": zeros(), "n": zeros(), "h": zeros(),
            "m": torch.full((b, inner), -1e30, dtype=F32, device=device)}


# ---------------------------------------------------------------------------------
# Mamba-2 / SSD heads (hymba's SSM path)
# ---------------------------------------------------------------------------------

#: the reference's Mamba-2 prefill chunk (``mamba_chunked(chunk=256)``)
MAMBA_CHUNK = 256


def mamba_dims(cfg) -> tuple[int, int, int, int]:
    """(e, heads, dh, N): the expanded width, split over the attention
    heads, and the state width."""
    e = cfg.ssm_expand * cfg.d_model
    h = cfg.n_heads
    return e, h, e // h, cfg.ssm_state


def init_mamba(generator, cfg, *, lead: tuple = (), device=None) -> Params:
    """``lead`` prepends stacked axes (a scan-stacked hybrid tree)."""
    d = cfg.d_model
    e, h, dh, n = mamba_dims(cfg)

    def mk(shape, axes, fan_in, dtype=cfg.dtype, **kw):
        return make_param(generator, shape, axes, fan_in=fan_in, dtype=dtype,
                          device=device, lead=lead, **kw)

    return {
        "w_in": mk((d, 2 * e), ("embed", "mlp"), d),
        "conv": mk((cfg.conv_width, e), (None, "mlp"), cfg.conv_width),
        "wB": mk((e, h, n), ("mlp", "heads", None), e),
        "wC": mk((e, h, n), ("mlp", "heads", None), e),
        "w_dt": mk((e, h), ("mlp", "heads"), e, F32),
        "a_log": mk((h,), ("heads",), None, F32, ones=True),
        "d_skip": mk((h,), ("heads",), None, F32, ones=True),
        "w_down": mk((e, d), ("mlp", "embed"), e),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` as the reference computes it:
    ``max(x, 0) + log1p(exp(-|x|))`` (``F.softplus`` switches to ``x``
    above a threshold)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _mamba_proj(p, x, cfg, conv_state=None, *, fused: bool = False):
    """Shared input path: in-proj, causal depthwise conv, gates.  Returns
    (u (B,S,H,dh), z, B_, C_, dt, new_conv_state).

    ``fused``: the reference's compiled decode feeds the f32 ``dt``
    product the SiLU's f32 result before its bf16 rounding (XLA drops the
    round trip of ``u.astype(f32)``); its eager prefill rounds first."""
    b, s, d = x.shape
    e, h, dh, _ = mamba_dims(cfg)
    w = cfg.conv_width
    up = torch.einsum("bsd,de->bse", x, p["w_in"])
    u, z = up[..., :e], up[..., e:]
    hist = (conv_state if conv_state is not None
            else torch.zeros((b, w - 1, e), dtype=u.dtype, device=x.device))
    seq = torch.cat([hist.to(u.dtype), u], dim=1)
    kern = p["conv"]
    conv = seq[:, 0:s] * kern[0]
    for i in range(1, w):
        conv = conv + seq[:, i:i + s] * kern[i]
    sig = 1 / (1 + torch.exp(-conv))                     # as layers.silu
    u = conv * sig
    u_f32 = conv.float() * sig.float() if fused else u.float()
    new_conv = seq[:, -(w - 1):] if w > 1 else hist
    B_ = torch.einsum("bse,ehn->bshn", u, p["wB"])
    C_ = torch.einsum("bse,ehn->bshn", u, p["wC"])
    dt = softplus(torch.einsum("bse,eh->bsh", u_f32, p["w_dt"]))
    return u.reshape(b, s, h, dh), z, B_, C_, dt, new_conv


def mamba_chunked(p: Params, x: torch.Tensor, cfg, *,
                  chunk: int = MAMBA_CHUNK, state: Optional[dict] = None):
    """SSD chunked forward: scalar-per-head decay a^dt, f32 state
    (B,H,dh,N) carried over chunks of ``chunk`` steps (the prompt padded to
    a whole chunk, as the reference pads it).  Returns (y, new_state)."""
    b, s, d = x.shape
    e, h, dh, n = mamba_dims(cfg)
    conv_state = state["conv"] if state is not None else None
    uh, z, B_, C_, dt, new_conv = _mamba_proj(p, x, cfg, conv_state)
    # the scan's inputs placed by their logical axes (identity off a mesh),
    # as the mLSTM scan's are
    heads = ("batch", "seq", "heads", "head_dim")
    uh, B_, C_ = (shard_hint(t, heads) for t in (uh, B_, C_))
    dt = shard_hint(dt, heads[:3])
    a = -torch.exp(p["a_log"])                           # (h,) negative rate
    la = dt * a                                          # (b,s,h) log decay
    xbar = uh.float() * dt[..., None]                    # dt-weighted input
    Bf, Cf = B_.float(), C_.float()

    nchunk = -(-s // chunk)
    pad = nchunk * chunk - s
    if pad:
        xbar = F.pad(xbar, (0, 0, 0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, 0, 0, pad))
        la = F.pad(la, (0, 0, 0, pad))
    hst = (state["ssm"] if state is not None
           else torch.zeros((b, h, dh, n), dtype=F32, device=x.device))
    tpos = torch.arange(chunk, device=x.device)
    causal = (tpos[:, None] >= tpos[None, :])[None, :, :, None]
    outs = []
    for c in range(nchunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        xb, Bb, Cb, lab = xbar[:, sl], Bf[:, sl], Cf[:, sl], la[:, sl]
        L = torch.cumsum(lab, dim=1)                     # (b,chunk,h)
        # intra-chunk: scores(t,s) = C_t . B_s * exp(L_t - L_s), s <= t
        dec = L[:, :, None, :] - L[:, None, :, :]
        dec = torch.where(causal, dec, -1e30)
        scores = (torch.einsum("bthn,bshn->bths", Cb, Bb)
                  * torch.exp(dec).permute(0, 1, 3, 2))
        intra = torch.einsum("bths,bshv->bthv", scores, xb)
        inter = torch.einsum("bthn,bhvn->bthv", Cb * torch.exp(L)[..., None],
                             hst)
        outs.append(intra + inter)
        # state to the end of the chunk
        Ltot = L[:, -1]                                  # (b,h)
        w_in = torch.exp(Ltot[:, None] - L)              # (b,chunk,h)
        hst = (hst * torch.exp(Ltot)[..., None, None]
               + torch.einsum("bshn,bsh,bshv->bhvn", Bb, w_in, xb))
    y = torch.cat(outs, dim=1)[:, :s]
    y = y + uh.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(b, s, e).to(x.dtype) * silu(z)
    y = torch.einsum("bse,ed->bsd", y, p["w_down"])
    return y, {"ssm": hst, "conv": new_conv}


def mamba_step(p: Params, x: torch.Tensor, cfg, state: dict):
    """Single-token decode.  x: (B,1,D); O(1) state update."""
    b = x.shape[0]
    e, h, dh, n = mamba_dims(cfg)
    uh, z, B_, C_, dt, new_conv = _mamba_proj(p, x, cfg, state["conv"],
                                              fused=True)
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt[:, 0] * a)                      # (b,h)
    xbar = uh[:, 0].float() * dt[:, 0][..., None]        # (b,h,dh)
    hst = (state["ssm"] * decay[..., None, None]
           + torch.einsum("bhn,bhv->bhvn", B_[:, 0].float(), xbar))
    y = torch.einsum("bhn,bhvn->bhv", C_[:, 0].float(), hst)
    y = y + uh[:, 0].float() * p["d_skip"][None, :, None]
    y = y.reshape(b, 1, e).to(x.dtype) * silu(z)
    y = torch.einsum("bse,ed->bsd", y, p["w_down"])
    return y, {"ssm": hst, "conv": new_conv}


def init_mamba_state(b: int, cfg, *, lead: tuple = (), device=None) -> dict:
    e, h, dh, n = mamba_dims(cfg)
    return {"ssm": torch.zeros(lead + (b, h, dh, n), dtype=F32, device=device),
            "conv": torch.zeros(lead + (b, cfg.conv_width - 1, e), dtype=F32,
                                device=device)}
