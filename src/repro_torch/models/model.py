"""Top-level model API: init / prefill / decode_step.

PyTorch counterpart of ``repro.models.model`` for the dense family and
the xLSTM stack (whose ``blocks`` and caches are per-layer lists).  The
module-level functions take the parameter tree explicitly, as the
reference's do; ``Model`` is the ``nn.Module`` that owns one tree on one
device and binds them.

Batch contracts:
  prefill: tokens (B,S) int; returns (last_logits (B,1,V), cache, S)
  decode:  tokens (B,1) + cache + index (B,) [+ slots (B,)]; returns
           (logits (B,1,V), cache) with the cache updated in place
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device

from .layers import Params, apply_norm, init_norm, make_param
from .transformer import (block_apply, check_supported, init_blocks,
                          init_layer_states, init_stacked_cache, layer_params,
                          xlstm_block_apply)


# ---------------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------------

def init_params(cfg, generator: torch.Generator, *, device=None) -> dict:
    """Random parameters in the reference's tree layout (stacked dense
    blocks or a per-layer xLSTM list, tied or separate unembedding), drawn
    from ``generator``."""
    check_supported(cfg)
    params: dict = {
        "embed": make_param(generator, (cfg.vocab_size, cfg.d_model),
                            fan_in=cfg.d_model, dtype=cfg.dtype,
                            device=device),
        "final_norm": init_norm(generator, cfg.d_model, cfg.norm_kind,
                                cfg.dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = make_param(generator, (cfg.d_model, cfg.vocab_size),
                                       fan_in=cfg.d_model, dtype=cfg.dtype,
                                       device=device)
    params["blocks"] = init_blocks(generator, cfg, device=device)
    return params


# ---------------------------------------------------------------------------------
# Shared trunk
# ---------------------------------------------------------------------------------

def _trunk(params, cfg, x, *, mode, positions, caches=None, cache_index=None,
           slots=None, max_len: int = 0):
    """Run all decoder blocks; returns (x, new_caches)."""
    if isinstance(params["blocks"], list):       # unrolled xLSTM stack
        # the reference's compiled decode (one jit over the unrolled
        # stack) feeds every norm the f32 residual sum before its bf16
        # rounding (XLA's default excess precision); the stream keeps the
        # rounded sum, and its eager prefill rounds before every norm
        layers = (caches["blocks"] if caches is not None
                  else [None] * cfg.n_layers)
        decode = mode == "decode"
        resid, new_layers = None, []
        for i, p in enumerate(params["blocks"]):
            x, resid, nc = xlstm_block_apply(
                p, x, cfg, i, mode=mode, cache=layers[i], slots=slots,
                norm_in=resid if decode else None)
            new_layers.append(nc)
        x = apply_norm(params["final_norm"], resid if decode else x,
                       cfg.norm_kind).to(x.dtype)
        return x, (caches if decode else {"blocks": new_layers})
    kv = caches["blocks"]["kv"] if caches is not None else None
    new_layers = []
    for i in range(cfg.n_layers):
        layer_cache = (None if kv is None
                       else {name: t[i] for name, t in kv.items()})
        x, nc = block_apply(layer_params(params["blocks"], i), x, cfg,
                            mode=mode, positions=positions, cache=layer_cache,
                            cache_index=cache_index, slots=slots,
                            max_len=max_len)
        new_layers.append(nc)
    x = apply_norm(params["final_norm"], x, cfg.norm_kind)
    if mode == "decode":
        return x, caches                  # updated in place
    stacked = {name: torch.stack([c[name] for c in new_layers])
               for name in new_layers[0]}
    return x, {"blocks": {"kv": stacked}}


def _logits(params, cfg, x):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return torch.einsum("bsd,dv->bsv", x, w).to(cfg.logits_dtype)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


# ---------------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """The resident decode cache: the dense KV cache (``max_len``
    positions, ``dtype``), or xLSTM's f32 recurrent state, whose size does
    not depend on ``max_len``."""
    if cfg.family == "ssm":
        return {"blocks": init_layer_states(cfg, batch, device)}
    return {"blocks": init_stacked_cache(cfg, batch, max_len, dtype, device)}


def prefill(params, cfg, tokens: torch.Tensor, max_len: int):
    """Process the full prompt, build the cache in one shot.

    Returns (last_position_logits, caches, next_index)."""
    b, total = tokens.shape
    x = params["embed"][tokens]
    x, new_caches = _trunk(params, cfg, x, mode="prefill",
                           positions=_positions(b, total, tokens.device),
                           max_len=max_len)
    return _logits(params, cfg, x[:, -1:]), new_caches, total


def decode_step(params, cfg, caches, tokens: torch.Tensor,
                index: torch.Tensor, slots: Optional[torch.Tensor] = None):
    """One decode step, in place.  tokens: (B,1); index: (B,) current
    lengths; slots: (B,) distinct cache rows the tokens belong to
    (default: rows 0..B-1, a cache of exactly B rows)."""
    b = tokens.shape[0]
    index = index.reshape(-1).expand(b) if index.numel() == 1 else index
    if slots is None:
        slots = torch.arange(b, device=tokens.device)
    x = params["embed"][tokens]
    x, caches = _trunk(params, cfg, x, mode="decode",
                       positions=index[:, None], caches=caches,
                       cache_index=index, slots=slots)
    return _logits(params, cfg, x), caches


# ---------------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------------

def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}__")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}__")
    else:
        yield prefix[:-2], tree


class Model(nn.Module):
    """One model's parameters on one device, and the calls that use them.

    ``params`` (a tree from ``init_params`` or ``convert.params_from_numpy``)
    is taken as it is; without it, the weights are drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``.  ``device`` is
    the card unless the caller passes "cpu"."""

    def __init__(self, cfg, *, params: Optional[dict] = None, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
            with torch.no_grad():
                params = init_params(cfg, generator, device=self.device)
        for name, t in _flatten(params):
            if t.device != self.device:
                raise ValueError(f"parameter {name} lies on {t.device}, "
                                 f"the model on {self.device}")
            self.register_buffer(name, t)
        self.params = params

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int):
        return prefill(self.params, self.cfg, tokens, max_len)

    @torch.no_grad()
    def decode_step(self, caches, tokens, index, slots=None):
        return decode_step(self.params, self.cfg, caches, tokens, index, slots)

    def init_cache(self, batch: int, max_len: int) -> dict:
        return init_cache(self.cfg, batch, max_len, dtype=self.cfg.dtype,
                          device=self.device)
