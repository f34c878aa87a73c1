"""Top-level model API: init / prefill / decode_step.

PyTorch counterpart of ``repro.models.model`` for the decoder-only
families: dense, MoE and MLA decoders (scan-stacked ``blocks``, MoE's dense
layer 0 apart as ``block0``), hymba's hybrid blocks and the xLSTM stack
(per-layer lists).  The module-level functions take the parameter tree
explicitly, as the reference's do; ``Model`` is the ``nn.Module`` that owns
one tree on one device and binds them.

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
from .transformer import (block_apply, check_supported, first_stacked_layer,
                          init_attention_caches, init_block, init_blocks,
                          init_layer_states, layer_params, xlstm_block_apply)


# ---------------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------------

def init_params(cfg, generator: torch.Generator, *, device=None) -> dict:
    """Random parameters in the reference's tree layout (``block0`` and
    stacked or per-layer ``blocks``, tied or separate unembedding), drawn
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
    if first_stacked_layer(cfg):
        params["block0"] = init_block(generator, cfg, 0, device=device)
    params["blocks"] = init_blocks(generator, cfg, device=device)
    return params


# ---------------------------------------------------------------------------------
# Shared trunk
# ---------------------------------------------------------------------------------

def _stack(trees: list):
    """Per-layer cache trees stacked on a new leading layers axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _xlstm_trunk(params, cfg, x, *, mode, caches, slots):
    # the reference's compiled decode (one jit over the unrolled stack)
    # feeds every norm the f32 residual sum before its bf16 rounding (XLA's
    # default excess precision); the stream keeps the rounded sum, and its
    # eager prefill rounds before every norm
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


def _trunk(params, cfg, x, *, mode, positions, caches=None, cache_index=None,
           slots=None, max_len: int = 0):
    """Run all decoder blocks; returns (x, new_caches).  A decode updates
    ``caches`` in place and returns it."""
    if cfg.family == "ssm":                      # unrolled xLSTM stack
        return _xlstm_trunk(params, cfg, x, mode=mode, caches=caches,
                            slots=slots)
    decode = mode == "decode"
    kw = dict(mode=mode, positions=positions, cache_index=cache_index,
              slots=slots, max_len=max_len)
    new: dict = {}
    start = 0
    if "block0" in params:
        # applied outside the reference's scan: eager in its prefill
        start = 1
        x, _, new["block0"] = block_apply(
            params["block0"], x, cfg, 0,
            cache=caches["block0"] if decode else None, fused=decode, **kw)
    blocks = params["blocks"]
    if isinstance(blocks, list):                 # unrolled (hymba)
        # the reference's jitted decode over the unrolled stack feeds each
        # norm the f32 residual sum before its bf16 rounding, as in the
        # xLSTM stack; its eager prefill rounds
        resid, layers = None, []
        for i, p in enumerate(blocks):
            x, resid, nc = block_apply(
                p, x, cfg, start + i,
                cache=caches["blocks"][i] if decode else None, fused=decode,
                norm_in=resid, keep_f32=decode, **kw)
            layers.append(nc)
        new["blocks"] = layers
        if decode:
            x = apply_norm(params["final_norm"], resid,
                           cfg.norm_kind).to(x.dtype)
            return x, caches
    else:                                        # scan-stacked
        layers = []
        for i in range(cfg.n_layers - start):
            layer_cache = (layer_params(caches["blocks"], i) if decode
                           else None)
            x, _, nc = block_apply(layer_params(blocks, i), x, cfg, start,
                                   cache=layer_cache, **kw)
            layers.append(nc)
        if not decode:
            new["blocks"] = _stack(layers)
    x = apply_norm(params["final_norm"], x, cfg.norm_kind)
    return x, (caches if decode else new)


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
    """The resident decode cache: the attention layers' KV (or MLA latent)
    caches of ``max_len`` positions (a sliding layer's ring of its window)
    in ``dtype``, with hymba's Mamba-2 state beside them; or xLSTM's f32
    recurrent state, whose size does not depend on ``max_len``."""
    if cfg.family == "ssm":
        return {"blocks": init_layer_states(cfg, batch, device)}
    return init_attention_caches(cfg, batch, max_len, dtype, device)


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
                index: torch.Tensor, slots: Optional[torch.Tensor] = None,
                max_len: int = 0):
    """One decode step, in place.  tokens: (B,1); index: (B,) current
    lengths; slots: (B,) distinct cache rows the tokens belong to
    (default: rows 0..B-1, a cache of exactly B rows); max_len: the
    length the caller retires a row at (the serving engine's), which lets
    a sliding layer whose cache holds every position use the paged kernel
    (0: unknown, every window layer decodes through its ring)."""
    b = tokens.shape[0]
    index = index.reshape(-1).expand(b) if index.numel() == 1 else index
    if slots is None:
        slots = torch.arange(b, device=tokens.device)
    x = params["embed"][tokens]
    x, caches = _trunk(params, cfg, x, mode="decode",
                       positions=index[:, None], caches=caches,
                       cache_index=index, slots=slots, max_len=max_len)
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
    def decode_step(self, caches, tokens, index, slots=None, max_len=0):
        return decode_step(self.params, self.cfg, caches, tokens, index, slots,
                           max_len)

    def init_cache(self, batch: int, max_len: int) -> dict:
        return init_cache(self.cfg, batch, max_len, dtype=self.cfg.dtype,
                          device=self.device)
