"""Top-level model API: init / forward / loss / prefill / decode_step.

PyTorch counterpart of ``repro.models.model`` for every family: dense, MoE
and MLA decoders (scan-stacked ``blocks``, MoE's dense layer 0 apart as
``block0``), hymba's hybrid blocks and the xLSTM stack (per-layer lists),
the seamless encoder-decoder (``params["encoder"]``, cross attention in
every decoder block) and the internvl vision-language decoder (precomputed
patch embeddings before the tokens).  The module-level functions take the
parameter tree explicitly, as the reference's do; ``Model`` is the
``nn.Module`` that owns one tree on one device and binds them.

Batch contracts:
  train:   {"tokens": (B,S) int, "targets": (B,S) int, "loss_mask": (B,S)
           f32} + "patch_embeds" (B,P,D) for vlm / "frames" (B,F,D) for an
           encoder-decoder; ``forward`` returns (logits over the token
           positions, MoE aux loss), ``loss_fn`` (total, metrics)
  prefill: tokens (B,S) int [+ frames= / patch_embeds=]; returns
           (last_logits (B,1,V), cache, next index)
  decode:  tokens (B,1) + cache + index (B,) [+ slots (B,)]; returns
           (logits (B,1,V), cache) with the cache updated in place

Train mode runs attention through ``layers.train_attention`` (the
reference's jnp paths as torch ops, selected by ``cfg.attn_impl``) and
xLSTM's scan through its torch version, so autograd differentiates every
step; it never reaches a CUDA kernel, whose wrappers refuse inputs that
require grad.  Serving (prefill, decode, the serving encoder) runs the
kernels.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device

from repro_torch.kernels import note_loop
from repro_torch.obs import span
from repro_torch.training.optimizer import tree_map

from .decode_graph import DecodeGraphs, PrefillGraphs, is_dtensor
from .layers import (Params, apply_norm, gather_for_use, init_norm,
                     make_param, record_axes, shard_hint)
from .transformer import (block_apply, check_supported, encoder_config,
                          first_stacked_layer, init_attention_caches,
                          init_block, init_blocks, init_layer_states,
                          layer_params, remat, xlstm_block_apply)

F32 = torch.float32


# ---------------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------------

def init_params(cfg, generator: torch.Generator, *, device=None) -> dict:
    """Random parameters in the reference's tree layout (``block0``,
    stacked or per-layer ``blocks``, tied or separate unembedding, an
    encoder-decoder's ``encoder``), drawn from ``generator``."""
    check_supported(cfg)
    params: dict = {
        "embed": make_param(generator, (cfg.vocab_size, cfg.d_model),
                            ("vocab", "embed"), fan_in=cfg.d_model,
                            dtype=cfg.dtype, device=device),
        "final_norm": init_norm(generator, cfg.d_model, cfg.norm_kind,
                                cfg.dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = make_param(generator, (cfg.d_model, cfg.vocab_size),
                                       ("embed", "vocab"), fan_in=cfg.d_model,
                                       dtype=cfg.dtype, device=device)
    if first_stacked_layer(cfg):
        params["block0"] = init_block(generator, cfg, 0,
                                      cross_attention=cfg.encoder_layers > 0,
                                      device=device)
    params["blocks"] = init_blocks(generator, cfg, device=device)
    if cfg.encoder_layers:
        enc_cfg = encoder_config(cfg)
        n = cfg.encoder_layers
        blocks = (init_block(generator, enc_cfg, 0, lead=(n,), device=device)
                  if cfg.scan_layers else
                  [init_block(generator, enc_cfg, i, device=device)
                   for i in range(n)])
        params["encoder"] = {
            "blocks": blocks,
            "final_norm": init_norm(generator, cfg.d_model, cfg.norm_kind,
                                    cfg.dtype, device=device)}
    return params


def abstract_params(cfg) -> tuple[dict, dict]:
    """The parameter tree on ``device="meta"`` (shapes and dtypes; nothing
    allocated, nothing drawn), and the tree of each leaf's logical axes
    (the reference's ``Param.axes``), shaped like it."""
    with record_axes() as table:
        params = init_params(cfg, None, device="meta")
    return params, tree_map(lambda t: table[id(t)], params)


def param_axes(cfg) -> dict:
    """The logical axes of every parameter, in a tree shaped like
    ``init_params``'s (keyed as the checkpoint's leaves are)."""
    return abstract_params(cfg)[1]


# ---------------------------------------------------------------------------------
# Shared trunk
# ---------------------------------------------------------------------------------

def _stack(trees: list):
    """Per-layer cache trees stacked on a new leading layers axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layers(blocks, n: int):
    """Each layer's parameters: views into a stacked tree, or the list's.
    Tells a listening cost counter the loop's passes (its
    ``trip_counts``)."""
    layers = (blocks if isinstance(blocks, list)
              else [layer_params(blocks, i) for i in range(n)])
    note_loop("blocks", len(layers))
    return layers


def _xlstm_trunk(params, cfg, x, *, mode, caches, slots):
    # the reference's compiled decode and train step (one jit over the
    # unrolled stack) feed every norm the f32 residual sum before its bf16
    # rounding (XLA's default excess precision); the stream keeps the
    # rounded sum, and its eager prefill rounds before every norm
    layers = (caches["blocks"] if caches is not None
              else [None] * cfg.n_layers)
    compiled = mode in ("decode", "train")
    resid, new_layers = None, []
    for i, p in enumerate(_layers(params["blocks"], cfg.n_layers)):
        x, resid, nc = xlstm_block_apply(
            p, x, cfg, i, mode=mode, cache=layers[i], slots=slots,
            norm_in=resid if compiled else None)
        new_layers.append(nc)
    with span("model/logits"):                  # the final norm
        x = apply_norm(params["final_norm"], resid if compiled else x,
                       cfg.norm_kind).to(x.dtype)
    if mode == "decode":
        return x, caches, None
    return x, (None if mode == "train" else {"blocks": new_layers}), None


def _trunk(params, cfg, x, *, mode, positions, caches=None, cache_index=None,
           slots=None, max_len: int = 0, enc_out=None):
    """Run all decoder blocks; returns (x, new_caches, aux): a decode
    updates ``caches`` in place and returns it, train mode returns no cache
    and the summed MoE load-balancing loss (None in the other modes)."""
    if cfg.family == "ssm":                      # unrolled xLSTM stack
        return _xlstm_trunk(params, cfg, x, mode=mode, caches=caches,
                            slots=slots)
    decode, train = mode == "decode", mode == "train"
    # the reference runs decode and its train step compiled (jit); its
    # prefill runs block0 and an unrolled stack eagerly (scan bodies are
    # compiled in every mode)
    compiled = decode or train
    kw = dict(mode=mode, positions=positions, cache_index=cache_index,
              slots=slots, max_len=max_len, enc_out=enc_out)
    new: dict = {}
    aux = x.new_zeros((), dtype=F32) if train else None
    start = 0
    if "block0" in params:
        # applied outside the reference's scan
        start = 1
        x, _, out = block_apply(
            params["block0"], x, cfg, 0,
            cache=caches["block0"] if decode else None, fused=compiled, **kw)
        if train:
            aux = aux + out
        else:
            new["block0"] = out
    blocks = params["blocks"]
    if isinstance(blocks, list):                 # unrolled (hymba)
        # the reference's jitted decode and train step over the unrolled
        # stack feed each norm the f32 residual sum before its bf16
        # rounding, as in the xLSTM stack; its eager prefill rounds
        resid, layers = None, []
        for i, p in enumerate(_layers(blocks, len(blocks))):
            x, resid, out = block_apply(
                p, x, cfg, start + i,
                cache=caches["blocks"][i] if decode else None, fused=compiled,
                norm_in=resid, keep_f32=compiled, **kw)
            if train:
                aux = aux + out
            layers.append(out)
        if compiled:
            with span("model/logits"):          # the final norm
                x = apply_norm(params["final_norm"], resid,
                               cfg.norm_kind).to(x.dtype)
            return x, (caches if decode else None), aux
        new["blocks"] = layers
    else:                                        # scan-stacked
        apply = remat(block_apply, cfg) if train else block_apply
        layers = []
        for i, p in enumerate(_layers(blocks, cfg.n_layers - start)):
            layer_cache = (layer_params(caches["blocks"], i) if decode
                           else None)
            x, _, out = apply(p, x, cfg, start, cache=layer_cache, **kw)
            if train:
                aux = aux + out
            layers.append(out)
        if mode == "prefill":
            new["blocks"] = _stack(layers)
    with span("model/logits"):                  # the final norm
        x = apply_norm(params["final_norm"], x, cfg.norm_kind)
    if decode:
        return x, caches, None
    return x, (None if train else new), aux


def _encoder_forward(params, cfg, frames: torch.Tensor, *,
                     train: bool) -> torch.Tensor:
    """The encoder over precomputed frame embeddings (the stub frontend's
    output): positions 0..F-1, blocks of the encoder config
    (``transformer.encoder_config``), then its final norm.  Its blocks
    attend causally when stacked (``scan_layers``; every registered
    encoder-decoder) and bidirectionally when unrolled, as the reference's
    do (its ``scan_blocks`` drops the ``causal=False`` that its unrolled
    loop passes; a reference fault the port copies).  In train
    mode through ``layers.train_attention`` (under ``remat``, as the
    reference's scan body), else through the flash kernel."""
    enc_cfg = encoder_config(cfg)
    b, s, _ = frames.shape
    positions = _positions(b, s, frames.device)
    enc = params["encoder"]
    mode = "train" if train else "encode"
    stacked = not isinstance(enc["blocks"], list)
    apply = remat(block_apply, cfg) if train and stacked else block_apply
    x = frames
    for i, p in enumerate(_layers(enc["blocks"], cfg.encoder_layers)):
        # the reference's scan over a stacked encoder does not pass
        # ``causal`` on, so its blocks attend causally; only its unrolled
        # encoder is bidirectional.  Copied for parity (ROADMAP Queue 3)
        x, _, _ = apply(p, x, enc_cfg, 0 if stacked else i, mode=mode,
                        positions=positions, causal=stacked)
    return apply_norm(enc["final_norm"], x, cfg.norm_kind)


def _assemble_inputs(params, cfg, tokens: torch.Tensor, *, frames=None,
                     patch_embeds=None, train: bool = False):
    """Token/frontend fusion.  Returns (x, positions, enc_out, prefix_len):
    a vlm's patch embeddings go before the token embeddings (positions run
    over both), an encoder-decoder's frames through the encoder."""
    b = tokens.shape[0]
    x = _embed_tokens(params, tokens)
    enc_out, prefix = None, 0
    if cfg.family == "vlm" and patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
        prefix = patch_embeds.shape[1]
    if cfg.encoder_layers:
        if frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: it needs "
                             f"frames (B, {cfg.frontend_tokens}, "
                             f"{cfg.d_model})")
        enc_out = _encoder_forward(params, cfg, frames.to(x.dtype),
                                   train=train)
    return x, _positions(b, x.shape[1], x.device), enc_out, prefix


def _embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
    return shard_hint(params["embed"][tokens], ("batch", "seq", "embed"))


def _logits(params, cfg, x):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = torch.einsum("bsd,dv->bsv", x, w).to(cfg.logits_dtype)
    return shard_hint(logits, ("batch", "seq", "vocab"))


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


# ---------------------------------------------------------------------------------
# Train forward / loss
# ---------------------------------------------------------------------------------

def forward(params, cfg, batch: dict):
    """Training forward.  Returns (logits over the token positions in
    ``cfg.logits_dtype``, the MoE aux loss in f32)."""
    params = gather_for_use(params)
    x, positions, enc_out, prefix = _assemble_inputs(
        params, cfg, batch["tokens"], frames=batch.get("frames"),
        patch_embeds=batch.get("patch_embeds"), train=True)
    x, _, aux = _trunk(params, cfg, x, mode="train", positions=positions,
                       enc_out=enc_out)
    if prefix:
        x = x[:, prefix:]
    if aux is None:                              # xLSTM: no MoE layers
        aux = x.new_zeros((), dtype=F32)
    return _logits(params, cfg, x), aux


def loss_fn(params, cfg, batch: dict):
    """Next-token cross entropy with z-loss and the MoE aux term, as the
    reference's ``loss_fn``: logits in ``cfg.logits_dtype`` then f32,
    logsumexp over the vocab, the mask's token count as the denominator
    (at least 1).  Returns (total, {"loss", "z_loss", "moe_aux",
    "tokens"})."""
    logits, aux = forward(params, cfg, batch)
    targets = batch["targets"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=F32, device=targets.device)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt_logit = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = (logz - tgt_logit) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    zloss = cfg.z_loss * ((logz * mask) ** 2).sum() / denom
    total = loss + zloss + cfg.moe_aux_weight * aux
    return total, {"loss": loss, "z_loss": zloss, "moe_aux": aux,
                   "tokens": denom}


# ---------------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None, enc_len: int = 0) -> dict:
    """The resident decode cache: the attention layers' KV (or MLA latent)
    caches of ``max_len`` positions (a sliding layer's ring of its window)
    in ``dtype``, with hymba's Mamba-2 state beside them and an
    encoder-decoder's cross K/V of ``enc_len`` positions; or xLSTM's f32
    recurrent state, whose size does not depend on ``max_len``."""
    if cfg.family == "ssm":
        return {"blocks": init_layer_states(cfg, batch, device)}
    return init_attention_caches(cfg, batch, max_len, dtype, device,
                                 enc_len=enc_len)


def prefill(params, cfg, tokens: torch.Tensor, max_len: int, *,
            frames: Optional[torch.Tensor] = None,
            patch_embeds: Optional[torch.Tensor] = None):
    """Process the full prompt, build the cache in one shot.  An
    encoder-decoder takes its ``frames`` (B, F, D) through the encoder and
    keeps each decoder layer's cross K/V in the cache; a vlm's
    ``patch_embeds`` (B, P, D) go before the tokens and into the cache.

    Returns (last_position_logits, caches, next_index)."""
    with span("model/prefill"):
        params = gather_for_use(params)
        with span("model/embed"):
            x, positions, enc_out, _ = _assemble_inputs(
                params, cfg, tokens, frames=frames, patch_embeds=patch_embeds)
        total = x.shape[1]
        x, new_caches, _ = _trunk(params, cfg, x, mode="prefill",
                                  positions=positions, max_len=max_len,
                                  enc_out=enc_out)
        with span("model/logits"):
            logits = _logits(params, cfg, x[:, -1:])
        return logits, new_caches, total


def decode_step(params, cfg, caches, tokens: torch.Tensor,
                index: torch.Tensor, slots: Optional[torch.Tensor] = None,
                max_len: int = 0):
    """One decode step, in place.  tokens: (B,1); index: (B,) current
    lengths; slots: (B,) cache rows the tokens belong to, a row repeated
    only with identical token and index, whose in-place writes then carry
    identical bits (the serving engine's pad rows); default: rows 0..B-1,
    a cache of exactly B rows; for DTensor inputs, the dry run's, every
    row of each rank's shard, ``layers.cache_step``.  max_len: the
    length the caller retires a row at (the serving engine's), which lets
    a sliding layer whose cache holds every position use the paged kernel
    (0: unknown, every window layer decodes through its ring).  An
    encoder-decoder's cross attention reads the rows' cross K/V."""
    with span("model/decode_step"):
        params = gather_for_use(params)
        b = tokens.shape[0]
        index = index.reshape(-1).expand(b) if index.numel() == 1 else index
        if slots is None and not is_dtensor(tokens):
            slots = torch.arange(b, device=tokens.device)
        with span("model/embed"):
            x = _embed_tokens(params, tokens)
        x, caches, _ = _trunk(params, cfg, x, mode="decode",
                              positions=index[:, None], caches=caches,
                              cache_index=index, slots=slots, max_len=max_len)
        with span("model/logits"):
            logits = _logits(params, cfg, x)
        return logits, caches


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
    the card unless the caller passes "cpu".

    The serving calls (``prefill``, ``decode_step``) run without autograd.
    ``train()`` makes every parameter a leaf tensor that requires grad, so
    ``forward`` and ``loss`` build a graph (``eval()`` undoes it); the
    training stack (``repro_torch.training``) works on ``params``.

    On the card ``decode_step`` is recorded once as a CUDA graph for each
    engine's caches and width and replayed (``decode_graphs``, a
    ``decode_graph.DecodeGraphs``; inside its ``eager()`` every call runs
    eagerly, for a tool that patches the functions a decode call runs).
    Where ``cfg.prefill_graphs`` is set, ``prefill`` of a token-only prompt
    is recorded too, for that many prompt shapes (``prefill_graphs``, a
    ``decode_graph.PrefillGraphs``)."""

    #: decode calls of every model in the process, by how they ran:
    #: "eager", "captured" (recorded as a CUDA graph, then replayed once)
    #: and "replayed"
    decode_calls = {"eager": 0, "captured": 0, "replayed": 0}
    #: prefill calls of every model in the process, by how they ran
    prefill_calls = {"eager": 0, "captured": 0, "replayed": 0}

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
        super().train(False)
        plain = not any(is_dtensor(t) for _, t in _flatten(params))
        self.decode_graphs = DecodeGraphs(
            functools.partial(decode_step, params, cfg), plain)
        self.prefill_graphs = PrefillGraphs(
            functools.partial(prefill, params, cfg), plain,
            cfg.prefill_graphs)

    def train(self, mode: bool = True) -> "Model":
        """Train mode: every parameter requires grad (False: none does)."""
        super().train(mode)
        for _, t in _flatten(self.params):
            t.requires_grad_(mode)
        return self

    def forward(self, batch: dict):
        return forward(self.params, self.cfg, batch)

    def loss(self, batch: dict):
        return loss_fn(self.params, self.cfg, batch)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int, *, frames=None,
                patch_embeds=None):
        if frames is not None or patch_embeds is not None:
            return prefill(self.params, self.cfg, tokens, max_len,
                           frames=frames, patch_embeds=patch_embeds)
        *out, how = self.prefill_graphs(tokens, max_len)
        Model.prefill_calls[how] += 1
        return tuple(out)

    @torch.no_grad()
    def decode_step(self, caches, tokens, index, slots=None, max_len=0):
        logits, caches, how = self.decode_graphs(caches, tokens, index,
                                                 slots, max_len)
        Model.decode_calls[how] += 1
        return logits, caches

    def init_cache(self, batch: int, max_len: int, enc_len: int = 0) -> dict:
        return init_cache(self.cfg, batch, max_len, dtype=self.cfg.dtype,
                          device=self.device, enc_len=enc_len)
