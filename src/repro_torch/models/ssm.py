"""Recurrent sequence-mixing blocks: xLSTM's mLSTM and sLSTM.

PyTorch counterpart of the xLSTM half of ``repro.models.ssm``, in its
parameter layouts.  The mLSTM prefill (``mlstm_chunked``) runs its
chunkwise-parallel scan through the chunked mLSTM kernel's wrapper
(``kernels/mlstm_scan/ops.py``): the hand-written CUDA kernel for tensors on
the card, its plain version (the reference's per-chunk body, op for op)
for tensors on the CPU.  The one-token decode steps and the sLSTM
recurrence (a Python loop over time: its hidden-to-gate dependency is
sequential) are plain torch, as the reference has no kernel for them.

State structures (decode), as the reference's:
  mLSTM: {"C": (B,H,dk,dv), "n": (B,H,dk), "m": (B,H)}, f32
  sLSTM: {"c", "n", "h", "m"}: (B, inner), f32
Mamba-2 (hymba's SSM heads) is still to port (ROADMAP.md, Queue 1 item 4).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm_scan import ops as mlstm_ops

from .layers import Params, apply_norm, init_norm, make_param, silu

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

    def mk(shape, fan_in, dtype=cfg.dtype, **kw):
        return make_param(generator, shape, fan_in=fan_in, dtype=dtype,
                          device=device, **kw)

    return {
        "w_up": mk((d, 2 * inner), d),
        "wq": mk((inner, h, dk), inner),
        "wk": mk((inner, h, dk), inner),
        "wv": mk((inner, h, dh), inner),
        "wi": mk((inner, h), inner, F32),
        "wf": mk((inner, h), inner, F32),
        "bf": mk((h,), None, F32, ones=True),
        "out_norm": init_norm(generator, inner, "rmsnorm", cfg.dtype,
                              device=device),
        "w_down": mk((inner, d), inner),
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
                  chunk: int = MLSTM_CHUNK, state: Optional[dict] = None):
    """Chunkwise-parallel mLSTM forward with stabilised exponential gating.

    Returns (y, final_state).  The scan (q pre-scaled and q/k/v in f32, as
    the reference computes them) is the mLSTM kernel's."""
    b, s, _ = x.shape
    inner, h, dk, dh = mlstm_dims(cfg)
    up = torch.einsum("bsd,de->bse", x, p["w_up"])
    u, z = up[..., :inner], up[..., inner:]
    q, k, v, log_i, log_f = _mlstm_gates(p, u)
    scale = 1.0 / math.sqrt(dk)
    qc = (q.float() * scale).contiguous()
    kc, vc = k.float().contiguous(), v.float().contiguous()
    init = None if state is None else (state["C"], state["n"], state["m"])
    y, (C, n, m) = mlstm_ops.mlstm_scan(
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

    def mk(shape, fan_in, dtype=F32, **kw):
        return make_param(generator, shape, fan_in=fan_in, dtype=dtype,
                          device=device, **kw)

    return {"w_in": mk((d, 4 * inner), d),
            "r": mk((inner, 4), 1),
            "b": mk((4 * inner,), None, zeros=True),
            "out_norm": init_norm(generator, inner, "rmsnorm", cfg.dtype,
                                  device=device),
            "w_down": mk((inner, d), inner, cfg.dtype),
            "w_z": mk((d, inner), d, cfg.dtype)}


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
    for t in range(s):
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
