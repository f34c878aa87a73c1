"""Optimizer: AdamW with global-norm clipping, plus int8 gradient
compression with error feedback for the data-parallel all-reduce.

PyTorch counterpart of ``repro.training.optimizer``.  Parameters are the
model's tree of tensors (nested dicts and lists, ``Model.params``); the
optimizer state mirrors it: ``{"mu", "nu"}`` f32 trees and ``"step"``, a
0-d int32 tensor.  The arithmetic is the reference's, in f32: the learning
rate schedule on f32 0-d tensors as jnp computes it, the moments and the
update per leaf.  ``adamw_update`` updates parameters and moments in place
under ``torch.no_grad()`` and frees each gradient once its leaf is
updated, so a full-width step holds one set of state (the reference
donates its buffers for the same reason).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

F32 = torch.float32


def leaves(tree) -> list:
    """The leaves of a nested dict / list tree, dict keys sorted as JAX
    flattens them (so sums over leaves run in the reference's order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over matching leaves of nested dict / list trees of one
    structure (anything else, a tuple too, is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    #: int8 gradient compression with error feedback for the DP all-reduce
    compress_grads: bool = False


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac`` of ``lr``: a 0-d
    f32 tensor, computed in f32 as the reference computes it from an int32
    step."""
    step = torch.as_tensor(step, dtype=torch.int32).to(F32)
    warm = torch.clamp(step / float(max(cfg.warmup_steps, 1)), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / float(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def init_opt_state(params) -> dict:
    """Zero f32 moments beside every parameter (placed as it is, a DTensor
    parameter's moments too) and a 0-d int32 step."""
    def zeros(t):
        return torch.zeros_like(t, dtype=F32,
                                memory_format=torch.contiguous_format)
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": step}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in order, as Python's ``sum``) of each
    leaf's f32 sum of squares."""
    total = None
    for t in leaves(tree):
        s = torch.sum(torch.square(t.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


# ---------------------------------------------------------------------------------
# Gradient compression (int8 + error feedback)
# ---------------------------------------------------------------------------------

def compress_int8(g: torch.Tensor, err: Optional[torch.Tensor]):
    """One leaf's gradient plus the carried error, quantized to int8 codes
    at one f32 scale (max |.| / 127, rounding half to even as ``jnp.round``
    does) and widened back.  Returns (dequantized, new error), both f32:
    the error is what the codes lost, carried to the next step."""
    gf = g.float() + (err if err is not None else 0.0)
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, gf - deq


def maybe_compress(grads, err_state, enabled: bool):
    """``compress_int8`` over every leaf when ``enabled``, carrying
    ``err_state`` (zeros when None); otherwise the gradients unchanged."""
    if not enabled:
        return grads, err_state
    if err_state is None:
        err_state = tree_map(
            lambda g: torch.zeros(g.shape, dtype=F32, device=g.device), grads)
    pairs = tree_map(compress_int8, grads, err_state)   # (deq, err) leaves
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)


# ---------------------------------------------------------------------------------
# Update
# ---------------------------------------------------------------------------------

@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: dict):
    """One AdamW step, in place: ``params``, ``state["mu"]`` and
    ``state["nu"]`` are updated where they lie, ``state["step"]`` is
    replaced by the next step.  ``grads`` mirrors ``params`` (any float
    dtype); None reads each parameter's ``.grad`` and drops it as soon as
    its leaf is updated, so the gradients go leaf by leaf.  Each leaf's
    update runs in f32 and is cast back to the parameter's dtype, as the
    reference's: ``v - lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * v)``
    after clipping the gradients to a global norm of ``grad_clip``.
    Returns (params, state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step).to(state["step"].device)
    owned = grads is None
    grad_list = ([v.grad for v in leaves(params)] if owned
                 else leaves(grads))
    gnorm = global_norm(grad_list)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(F32)
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=F32, device=stepf.device),
                       stepf)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=F32, device=stepf.device),
                       stepf)
    for i, (v, m, n) in enumerate(zip(leaves(params), leaves(state["mu"]),
                                      leaves(state["nu"]))):
        gf = grad_list[i].float() * scale
        grad_list[i] = None
        if owned:
            v.grad = None
        m.mul_(b1).add_(gf * (1 - b1))
        n.mul_(b2).add_((gf * (1 - b2)) * gf)
        del gf
        vf = v.float()
        upd = (m / c1) / (torch.sqrt(n / c2) + cfg.eps) \
            + cfg.weight_decay * vf
        v.copy_((vf - lr * upd).to(v.dtype))
        del vf, upd
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
