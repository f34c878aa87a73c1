"""Transformer assembly: dense, MoE and MLA decoders, hymba's hybrid
attention+Mamba-2 blocks with sliding-window ring caches, xLSTM stacks and
the seamless encoder-decoder (encoder blocks, decoder blocks with cross
attention).

PyTorch counterpart of ``repro.models.transformer`` for every family.
Modes of ``block_apply``: "train" (the whole sequence, no cache, autograd
through ``layers.train_attention``), "encode" (the serving encoder: the
whole sequence through the flash kernel, no cache), "prefill" and
"decode".  Under ``cfg.remat`` a train-mode pass wraps each block of a
scan-stacked tree in ``torch.utils.checkpoint`` (``remat``), as the
reference wraps its scan body.  A config with
``scan_layers`` keeps the reference's scan-stacked layout (each leaf of
``params["blocks"]`` has a leading layers axis) and is applied in a Python
loop over views; ``scan_layers=False`` trees (hymba, xLSTM) are per-layer
lists, as the reference unrolls them.  MoE configs with
``first_layer_dense`` carry layer 0 apart as ``params["block0"]``.

Cache layout (decode), as the reference builds it, so cache contents
compare one to one:
  attention: ``{"kv": {"k", "v", "pos"}}`` per layer, ``k``/``v``
         (B, cap, KV, D) and ``pos`` (B, cap), cap ``min(max_len, window)``;
         MLA: ``{"kv": {"c", "k_pe", "pos"}}``, the latent (B, cap, dc) and
         the shared rope key (B, cap, dr); hybrid layers add ``"ssm"``, the
         Mamba-2 state.  Stacked over layers for a scan-stacked tree, a
         per-layer list otherwise; ``"block0"`` beside ``"blocks"``.
         Decode updates it *in place*.
  encoder-decoder: each decoder layer adds ``cross_k`` / ``cross_v``
         (B, enc_len, KV, D), the encoder output projected through the
         layer's ``cross.wk`` / ``cross.wv`` at prefill and read back at
         decode.
  xLSTM: a list of per-layer ``{"ssm": state}`` trees (``models/ssm.py``).
Recurrent state (xLSTM, Mamba-2) is read at the stepping rows' ``slots``
and written back into those rows in place (``index_copy_``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels.paged_attention import ops as pa_ops

from . import ssm
from .layers import (NEG_INF, Params, apply_norm, attention_block,
                     init_attention, init_mla, init_mlp, init_moe, init_norm,
                     cache_step, mla_block, mla_decode, mlp_block,
                     moe_block, qkv_projections, shard_hint)

#: tokens per KV page when a layer's resident cache is viewed as pages
PAGE_SIZE = 16


def check_supported(cfg) -> None:
    """Raise for a config whose layers this package cannot run, naming
    each missing feature.  Every arch in ``ARCH_IDS`` passes; what is
    refused are layouts no registered config uses."""
    missing = []
    if cfg.family == "ssm":
        if cfg.ssm_kind != "xlstm":
            missing.append(f"ssm_kind {cfg.ssm_kind!r}")
        if cfg.scan_layers:
            missing.append("scan-stacked (scan_layers=True) xLSTM trees")
    elif cfg.family not in ("dense", "moe", "hybrid", "encdec", "vlm"):
        missing.append(f"family {cfg.family!r}")
    if cfg.hybrid and cfg.ssm_kind != "mamba":
        missing.append(f"hybrid ssm_kind {cfg.ssm_kind!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to PyTorch")


# ---------------------------------------------------------------------------------
# Block init
# ---------------------------------------------------------------------------------

def block_kind(cfg, layer_idx: int) -> str:
    """"mlstm" / "slstm" for xLSTM blocks (every ``slstm_every``-th is
    sLSTM), "hybrid" for hymba's, "moe" past a dense first layer, "dense"
    otherwise."""
    if cfg.family == "ssm":
        if cfg.slstm_every and (layer_idx % cfg.slstm_every
                                == cfg.slstm_every - 1):
            return "slstm"
        return "mlstm"
    if cfg.hybrid:
        return "hybrid"
    if cfg.n_routed_experts and not (layer_idx == 0 and cfg.first_layer_dense):
        return "moe"
    return "dense"


def first_stacked_layer(cfg) -> int:
    """1 when layer 0 is carried apart as ``block0`` (a dense first layer
    before MoE layers), else 0."""
    return 1 if (cfg.n_routed_experts and cfg.first_layer_dense) else 0


def init_block(generator, cfg, layer_idx: int, *, lead: tuple = (),
               cross_attention: bool = False, device=None) -> Params:
    """One attention block's parameters (``lead`` stacks them);
    ``cross_attention`` adds ``cross_norm`` and ``cross`` (an
    encoder-decoder's decoder block)."""
    kind = block_kind(cfg, layer_idx)

    def norm(kind_=cfg.norm_kind):
        return init_norm(generator, cfg.d_model, kind_, cfg.dtype, lead=lead,
                         device=device)

    p: Params = {"attn_norm": norm()}
    p["attn"] = (init_mla if cfg.use_mla else init_attention)(
        generator, cfg, lead=lead, device=device)
    if kind == "hybrid":
        p["ssm"] = ssm.init_mamba(generator, cfg, lead=lead, device=device)
        p["attn_out_norm"] = norm("rmsnorm")
        p["ssm_out_norm"] = norm("rmsnorm")
    if cross_attention:
        p["cross_norm"] = norm()
        p["cross"] = init_attention(generator, cfg, lead=lead, device=device)
    p["mlp_norm"] = norm()
    if kind == "moe":
        p["mlp"] = init_moe(generator, cfg, lead=lead, device=device)
    else:
        width = cfg.d_ff if cfg.d_ff else cfg.d_expert * (
            cfg.moe_top_k + cfg.n_shared_experts)
        p["mlp"] = init_mlp(generator, cfg, d_ff=width, lead=lead,
                            device=device)
    return p


def init_blocks(generator, cfg, *, device=None):
    """The decoder blocks after ``block0``: stacked on a leading layers axis
    (``scan_layers``), or a per-layer list (hymba, xLSTM); with cross
    attention in an encoder-decoder."""
    if cfg.family == "ssm":
        return [init_xlstm_block(generator, cfg, i, device=device)
                for i in range(cfg.n_layers)]
    start = first_stacked_layer(cfg)
    cross = cfg.encoder_layers > 0
    if cfg.scan_layers:
        return init_block(generator, cfg, start,
                          lead=(cfg.n_layers - start,),
                          cross_attention=cross, device=device)
    return [init_block(generator, cfg, i, cross_attention=cross,
                       device=device)
            for i in range(start, cfg.n_layers)]


def encoder_config(cfg):
    """The encoder's config: the decoder's without MoE, hybrid, SSM or MLA
    layers, as the reference builds it."""
    return dataclasses.replace(cfg, n_routed_experts=0, hybrid=False,
                               ssm_kind="", use_mla=False)


def init_xlstm_block(generator, cfg, layer_idx: int, *, device=None) -> Params:
    init = (ssm.init_mlstm if block_kind(cfg, layer_idx) == "mlstm"
            else ssm.init_slstm)
    return {"norm": init_norm(generator, cfg.d_model, cfg.norm_kind,
                              cfg.dtype, device=device),
            "mix": init(generator, cfg, device=device)}


def layer_params(stacked: Params, i: int) -> Params:
    """Layer ``i``'s parameters (or cache): views into the stacked tree."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


# ---------------------------------------------------------------------------------
# Block apply
# ---------------------------------------------------------------------------------

def layer_window(cfg, layer_idx: int) -> Optional[int]:
    """The sliding window of layer ``layer_idx`` (None: full attention)."""
    if cfg.sliding_window and layer_idx not in cfg.global_layers:
        return cfg.sliding_window
    return None


def layer_cap(max_len: int, window: Optional[int]) -> int:
    """Positions a layer's cache holds: a ring of ``window`` when that is
    shorter than ``max_len``."""
    return min(max_len, window) if window else max_len


def block_apply(p: Params, x: torch.Tensor, cfg, layer_idx: int, *,
                mode: str, positions: torch.Tensor,
                cache: Optional[dict] = None,
                cache_index: Optional[torch.Tensor] = None,
                slots: Optional[torch.Tensor] = None, max_len: int = 0,
                fused: bool = True, norm_in: Optional[torch.Tensor] = None,
                keep_f32: bool = False, causal: bool = True,
                enc_out: Optional[torch.Tensor] = None):
    """Apply one attention block (dense, MoE, MLA, hybrid, an encoder block
    or a decoder block with cross attention).  Returns (x, resid,
    new_cache): ``x`` the bf16 residual stream and, with ``keep_f32``,
    ``resid`` the same sum in f32 before its rounding (else None).  In
    train mode the third element is the block's MoE load-balancing loss
    (0 for other kinds) in place of a cache.

    mode: "train" (the whole sequence through ``layers.train_attention``,
    no cache), "encode" (the whole sequence through the flash kernel, no
    cache: the serving encoder), "prefill" (build this layer's cache for
    ``max_len`` positions) or "decode" (update ``cache`` in place at
    ``[slots, cache_index]``; ``max_len`` is the length the caller retires
    a row at, 0 if unknown: see ``decode_kv``).  ``layer_idx`` picks the
    block kind and the window; a scan-stacked layer passes the stack's
    first index, as the reference's ``scan_blocks`` does.  ``causal`` is
    False for an encoder block.  A block with cross attention (``"cross"``
    in ``p``) attends over ``enc_out`` (B, F, D) projected through
    ``cross.wk`` / ``cross.wv`` in train and prefill mode, keeping the
    projections as ``cross_k`` / ``cross_v`` in its prefill cache, and over
    those cached rows at decode (``cross_attention``).

    ``fused``: the reference's compiled block (a scan body, a jitted
    decode) feeds the MLP norm the f32 residual sum before it is rounded
    to bf16 (XLA's default excess precision removes that round trip); an
    eagerly run block (an unrolled prefill, ``block0``'s prefill) rounds
    it first.  (Its hybrid combine rounds every step either way.)  With
    cross attention the same holds for the cross norm, which reads the
    attention residual sum.  ``norm_in`` is what the attention norm reads
    (default ``x``): an unrolled compiled decode passes the previous
    block's f32 ``resid``."""
    kind = block_kind(cfg, layer_idx)
    window = layer_window(cfg, layer_idx)
    h = apply_norm(p["attn_norm"], x if norm_in is None else norm_in,
                   cfg.norm_kind).to(x.dtype)
    new_cache: dict = {}
    if mode in ("train", "encode"):
        train = mode == "train"
        if cfg.use_mla:
            y, _ = mla_block(p["attn"], h, cfg, positions=positions,
                             train=train)
        else:
            y, _ = attention_block(p["attn"], h, cfg, positions=positions,
                                   window=window, causal=causal, train=train)
    elif mode == "prefill":
        if cfg.use_mla:
            y, latents = mla_block(p["attn"], h, cfg, positions=positions,
                                   return_kv=True)
            new_cache["kv"] = assemble_mla_cache(
                latents, layer_cap(max_len, window), positions, cfg.dtype)
        else:
            y, kv = attention_block(p["attn"], h, cfg, positions=positions,
                                    window=window, causal=causal,
                                    return_kv=True)
            new_cache["kv"] = assemble_kv_cache(
                kv, layer_cap(max_len, window), positions, cfg.dtype)
    else:
        y = decode_kv(p["attn"], h, cfg, positions=positions,
                      cache=cache["kv"], cache_index=cache_index,
                      slots=slots, window=window, max_len=max_len)
        new_cache = cache

    if kind == "hybrid":
        if mode == "decode":
            ys = _step_rows(ssm.mamba_step, p["ssm"], h, cfg, cache["ssm"],
                            slots)
        else:
            ys, state = ssm.mamba_chunked(p["ssm"], h, cfg)
            if mode == "prefill":
                new_cache["ssm"] = state
        y = 0.5 * (apply_norm(p["attn_out_norm"], y, "rmsnorm")
                   + apply_norm(p["ssm_out_norm"], ys, "rmsnorm"))

    # GSPMD reduces a row-parallel product's partial sums where a consumer
    # needs them; DTensor would carry them into the residual sum and the
    # norm, so each sublayer's output is hinted (identity off a mesh)
    y = shard_hint(y, ("batch", "seq", "embed"))
    resid = x.float() + y.float()
    if "cross" in p:
        x = resid.to(x.dtype)
        hc = apply_norm(p["cross_norm"], resid if fused else x,
                        cfg.norm_kind).to(x.dtype)
        yc = cross_attention(p["cross"], hc, cfg, mode=mode,
                             positions=positions, enc_out=enc_out,
                             cache=cache, slots=slots, new_cache=new_cache)
        resid = x.float() + shard_hint(yc, ("batch", "seq", "embed")).float()
    if fused:
        h = apply_norm(p["mlp_norm"], resid, cfg.norm_kind).to(x.dtype)
        x = resid.to(x.dtype)
    else:
        x = resid.to(x.dtype)
        h = apply_norm(p["mlp_norm"], x, cfg.norm_kind)
    aux = None
    if kind == "moe":
        y, aux = moe_block(p["mlp"], h, cfg,
                           capacity_factor=cfg.capacity_factor,
                           no_drop=(mode == "decode"))
    else:
        y = mlp_block(p["mlp"], h, cfg)
    y = shard_hint(y, ("batch", "seq", "embed"))
    if mode == "train":
        new_cache = aux if aux is not None else x.new_zeros((), dtype=torch.float32)
    if not keep_f32:
        return shard_hint(x + y, ("batch", "seq", "embed")), None, new_cache
    resid = x.float() + y.float()
    return (shard_hint(resid.to(x.dtype), ("batch", "seq", "embed")), resid,
            new_cache)


def cross_attention(p: Params, hc: torch.Tensor, cfg, *, mode: str,
                    positions, enc_out, cache, slots, new_cache: dict):
    """A decoder block's attention over the encoder output, as the
    reference's ``block_apply`` does it: K/V are ``enc_out`` projected
    through ``p["wk"]`` / ``p["wv"]`` (no RoPE), kept in ``new_cache`` as
    ``cross_k`` / ``cross_v`` at prefill, and read back from the cache
    rows ``slots`` at decode; the attention is non-causal (train:
    ``layers.train_attention``; else the flash kernel, at decode with one
    query row)."""
    if mode == "decode" and slots is None:       # the whole batch
        kv = (cache["cross_k"], cache["cross_v"])
    elif mode == "decode":
        rows = slots.to(torch.int64)
        kv = (cache["cross_k"][rows], cache["cross_v"][rows])
    else:
        ek = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"])
        ev = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"])
        kv = (ek, ev)
        if mode == "prefill":
            new_cache["cross_k"], new_cache["cross_v"] = ek, ev
    yc, _ = attention_block(p, hc, cfg, positions=positions, kv_override=kv,
                            causal=False, train=(mode == "train"))
    return yc


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for ``remat_policy="dots"``: keep
    the outputs of matrix products, recompute the rest (the reference's
    ``checkpoint_dots``)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
              torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, cfg):
    """``fn`` under the reference's ``_remat``: with ``cfg.remat`` and
    policy "nothing", every activation inside is recomputed in the backward
    pass (``torch.utils.checkpoint``, non-reentrant); "dots" keeps the
    matrix products' outputs; "full" (or no remat) returns ``fn``."""
    if not cfg.remat or cfg.remat_policy == "full":
        return fn
    kw = dict(use_reentrant=False)
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)
    return lambda *a, **k: checkpoint(fn, *a, **kw, **k)


def _step_rows(step, p, h, cfg, state: dict, slots: torch.Tensor):
    """Step the recurrent state of rows ``slots`` and write it back in place
    (slots must be distinct; None: every row, the dry run's whole-batch
    step).  Returns the step's output."""
    if slots is None:
        y, new = step(p, h, cfg, dict(state))
        for name, t in state.items():
            t.copy_(new[name].to(t.dtype))
        return y
    rows = slots.to(torch.int64)
    y, new = step(p, h, cfg, {k: t[rows] for k, t in state.items()})
    for name, t in state.items():
        t.index_copy_(0, rows, new[name].to(t.dtype))
    return y


def xlstm_block_apply(p: Params, x: torch.Tensor, cfg, layer_idx: int, *,
                      mode: str, cache: Optional[dict] = None,
                      slots: Optional[torch.Tensor] = None,
                      norm_in: Optional[torch.Tensor] = None):
    """Apply one xLSTM block.  Returns (x, resid, new_cache): ``x`` the
    bf16 residual stream and ``resid`` the same sum in f32 before its
    rounding.

    mode: "train" (the whole sequence from the empty state through the
    torch chunked scan, ``ref.mlstm_chunked_ref``, never the forward-only
    kernel; no cache, ``new_cache`` None), "prefill" (run the whole prompt
    from the empty state; the new cache is ``{"ssm": final state}``) or
    "decode" (step the rows at
    ``slots`` of ``cache`` and write their new state back in place).
    Slots must be distinct: duplicate rows in an in-place write have no
    defined winner.  ``norm_in`` is what the block's norm reads (default
    ``x``): the decode passes the previous block's f32 ``resid``, as the
    reference's compiled decode does (``_trunk``)."""
    kind = block_kind(cfg, layer_idx)
    h = apply_norm(p["norm"], x if norm_in is None else norm_in,
                   cfg.norm_kind).to(x.dtype)
    if mode == "decode":
        step = ssm.mlstm_step if kind == "mlstm" else ssm.slstm_step
        y = _step_rows(step, p["mix"], h, cfg, cache["ssm"], slots)
        new_cache = cache
    elif kind == "mlstm":
        y, state = ssm.mlstm_chunked(p["mix"], h, cfg, state=None,
                                     use_kernel=mode != "train")
        new_cache = None if mode == "train" else {"ssm": state}
    else:
        y, state = ssm.slstm_forward(p["mix"], h, cfg, state=None)
        new_cache = None if mode == "train" else {"ssm": state}
    # the mixer's output reduced as an attention block's sublayers are
    # (identity off a mesh)
    y = shard_hint(y, ("batch", "seq", "embed"))
    resid = x.float() + y.float()
    return resid.to(x.dtype), resid, new_cache


# ---------------------------------------------------------------------------------
# KV cache plumbing
# ---------------------------------------------------------------------------------

def _pos_column(positions: torch.Tensor) -> torch.Tensor:
    return (positions[0] if positions.dim() > 1 else positions).to(torch.int32)


def assemble_kv_cache(kv: tuple, cap: int, positions: torch.Tensor,
                      dtype) -> dict:
    """One-shot prefill cache write: pad computed K/V to the cache length,
    ``pos`` -1 past the prompt.  A prompt longer than a ring's ``cap``
    keeps its last ``cap`` positions in order, slot ``j`` holding position
    ``s - cap + j``, as the reference lays the ring out.  (Decode then
    writes position ``idx`` at slot ``idx % cap``: when ``s % cap != 0``
    that overwrites a position still inside the window, the reference's
    own layout fault, copied so tokens match.)"""
    k, v = kv
    b, s = k.shape[0], k.shape[1]
    pos = _pos_column(positions)
    if s > cap:
        newk, newv = k[:, -cap:].to(dtype), v[:, -cap:].to(dtype)
        newpos = pos[-cap:]
    else:
        newk = F.pad(k.to(dtype), (0, 0, 0, 0, 0, cap - s))
        newv = F.pad(v.to(dtype), (0, 0, 0, 0, 0, cap - s))
        newpos = torch.cat([pos, torch.full((cap - s,), -1, dtype=torch.int32,
                                            device=pos.device)])
    return {"k": newk.contiguous(), "v": newv.contiguous(),
            "pos": newpos.expand(b, cap).contiguous()}


def assemble_mla_cache(latents: tuple, cap: int, positions: torch.Tensor,
                       dtype) -> dict:
    """MLA's prefill cache: the latents padded to the cache length."""
    c, k_pe = latents
    b, s = c.shape[0], c.shape[1]
    if s > cap:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {cap}")
    pos = _pos_column(positions)
    newpos = torch.cat([pos, torch.full((cap - s,), -1, dtype=torch.int32,
                                        device=pos.device)])
    return {"c": F.pad(c.to(dtype), (0, 0, 0, cap - s)),
            "k_pe": F.pad(k_pe.to(dtype), (0, 0, 0, cap - s)),
            "pos": newpos.expand(b, cap).contiguous()}


def page_size_for(cap: int) -> int:
    """The page size the resident cache is viewed with: ``PAGE_SIZE``, or
    the largest power of two below it that divides ``cap``."""
    page = PAGE_SIZE
    while cap % page:
        page //= 2
    return page


def slot_block_tables(slots: torch.Tensor, cap: int,
                      page: int) -> torch.Tensor:
    """Block-table rows of the resident cache viewed as pages: slot ``s``
    owns pages ``s*(cap/page) .. s*(cap/page) + cap/page - 1``."""
    per_slot = cap // page
    return (slots.to(torch.int32)[:, None] * per_slot
            + torch.arange(per_slot, dtype=torch.int32,
                           device=slots.device)[None, :])


def uses_ring(cap: int, window: Optional[int], max_len: int) -> bool:
    """Whether a layer decodes through the ring (``ring_decode_attention``):
    its cache is a window shorter than ``max_len``, or, with ``max_len``
    unknown (0), a window at all.  Every other layer holds every position a
    row reaches, and its window cannot bite (``decode_attention``)."""
    return window is not None and cap == window and (
        max_len == 0 or cap < max_len)


def decode_kv(p, h, cfg, *, positions, cache, cache_index, slots, window,
              max_len):
    """One attention layer's decode: MLA's absorbed form, the ring, or the
    paged kernel."""
    if cfg.use_mla:
        return mla_decode(p, h, cfg, positions=positions, cache=cache,
                          cache_index=cache_index, slots=slots)
    if uses_ring(cache["k"].shape[1], window, max_len):
        return ring_decode_attention(p, h, cfg, positions=positions,
                                     cache=cache, cache_index=cache_index,
                                     slots=slots, window=window)
    return decode_attention(p, h, cfg, positions=positions, cache=cache,
                            cache_index=cache_index, slots=slots)


def decode_attention(p, h, cfg, *, positions, cache, cache_index, slots):
    """Decode attention for one new token per packed row, *in place*.

    Row ``i`` (slot ``slots[i]``, position ``cache_index[i]``) writes its
    new K/V into the resident cache at ``[slots[i], cache_index[i]]`` and
    attends over that slot's keys ``0 .. cache_index[i]`` with the paged
    kernel: the layer's (B, cap, KV, D) cache viewed as pages
    (B*cap/page, page, KV, D), block-table row ``slot*(cap/page) +
    arange(cap/page)`` and ``lengths = index + 1``.  Slots must be
    distinct: duplicate rows in an in-place write have no defined winner.

    This selects exactly the keys of the reference's
    ``_ring_decode_attention`` mask (``0 <= pos <= index``, and ``pos >
    index - window`` in a windowed layer) whenever the cache holds every
    position a row reaches: prefill sets ``pos`` to -1 past the prompt, and
    decode writes at ``index % cap == index`` because the engine retires a
    request at ``index >= max_len - 1`` and ``cap == max_len``.  In a
    windowed layer ``cap == max_len`` means ``max_len <= window``, so
    ``index - window < 0`` and the window cannot bite.  ``pos`` is kept up
    to date all the same, so cache contents compare with the reference's.
    """
    q, k, v = qkv_projections(p, h, cfg, positions)
    out = cache_step(_paged_core, (q, k, v), cache, cache_index, slots)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _paged_core(q, k, v, cache, cache_index, rows):
    b = q.shape[0]
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    n_slots, cap = ck.shape[0], ck.shape[1]
    idx = cache_index.to(torch.int64)
    rows = rows.to(torch.int64)
    ck[rows, idx] = k[:, 0].to(ck.dtype)
    cv[rows, idx] = v[:, 0].to(cv.dtype)
    cpos[rows, idx] = cache_index.to(cpos.dtype)

    page = page_size_for(cap)
    kv_heads, hd = ck.shape[2], ck.shape[3]
    k_pages = ck.view(n_slots * cap // page, page, kv_heads, hd)
    v_pages = cv.view(n_slots * cap // page, page, kv_heads, hd)
    tables = slot_block_tables(rows, cap, page)
    lengths = (cache_index.to(torch.int32) + 1)
    out = pa_ops.paged_attention(q[:, 0].contiguous(), k_pages, v_pages,
                                 tables, lengths)
    return out.view(b, 1, *out.shape[1:])


def ring_decode_attention(p, h, cfg, *, positions, cache, cache_index, slots,
                          window):
    """Decode attention against a ring cache, *in place*, as the reference's
    ``_ring_decode_attention``: row ``i`` writes position
    ``cache_index[i]`` at slot ``cache_index[i] % cap`` of cache row
    ``slots[i]`` and attends over that row's keys whose ``pos`` is written,
    not in the future and inside the window.  The attention is the
    reference's jnp arithmetic (f32 products and softmax), not a kernel."""
    q, k, v = qkv_projections(p, h, cfg, positions)
    core = functools.partial(_ring_core, window=window,
                             n_rep=cfg.n_heads // cfg.n_kv_heads,
                             head_dim=cfg.head_dim)
    out = cache_step(core, (q, k, v), cache, cache_index, slots)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _ring_core(q, k, v, cache, cache_index, rows, *, window, n_rep,
               head_dim):
    b = q.shape[0]
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    cap = ck.shape[1]
    idx = cache_index.to(torch.int64)
    rows = rows.to(torch.int64)
    slot = idx % cap
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)
    cpos[rows, slot] = cache_index.to(cpos.dtype)

    kk = ck[rows].float().repeat_interleave(n_rep, dim=2)
    vv = cv[rows].float().repeat_interleave(n_rep, dim=2)
    scale = 1.0 / math.sqrt(head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * scale
    qp = idx.view(b, 1, 1, 1)
    kp = cpos[rows][:, None, None, :].to(torch.int64)
    mask = (kp >= 0) & (kp <= qp) & (kp > qp - window)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vv).to(q.dtype)


# ---------------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------------

def init_layer_cache(cfg, layer_idx: int, batch: int, max_len: int,
                     dtype=torch.bfloat16, *, enc_len: int = 0,
                     lead: tuple = (), device=None) -> dict:
    """Zeroed decode cache of one attention layer (``lead`` stacks it),
    ``pos`` -1 everywhere; a hybrid layer adds the empty Mamba-2 state, a
    decoder layer of an encoder-decoder ``cross_k`` / ``cross_v`` of
    ``enc_len`` positions."""
    cap = layer_cap(max_len, layer_window(cfg, layer_idx))
    rows = lead + (batch, cap)

    def zeros(*tail):
        return torch.zeros(rows + tail, dtype=dtype, device=device)

    if cfg.use_mla:
        kv = {"c": zeros(cfg.kv_lora_rank), "k_pe": zeros(cfg.rope_head_dim)}
    else:
        kv = {"k": zeros(cfg.n_kv_heads, cfg.head_dim),
              "v": zeros(cfg.n_kv_heads, cfg.head_dim)}
    kv["pos"] = torch.full(rows, -1, dtype=torch.int32, device=device)
    c = {"kv": kv}
    if block_kind(cfg, layer_idx) == "hybrid":
        c["ssm"] = ssm.init_mamba_state(batch, cfg, lead=lead, device=device)
    if cfg.encoder_layers:
        cross = lead + (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
        c["cross_k"] = torch.zeros(cross, dtype=dtype, device=device)
        c["cross_v"] = torch.zeros(cross, dtype=dtype, device=device)
    return c


def init_attention_caches(cfg, batch: int, max_len: int,
                          dtype=torch.bfloat16, device=None,
                          enc_len: int = 0) -> dict:
    """``{"blocks": ..., ["block0": ...]}`` of an attention decoder
    (``enc_len``: an encoder-decoder's cross cache length)."""
    start = first_stacked_layer(cfg)
    caches: dict = {}
    if start:
        caches["block0"] = init_layer_cache(cfg, 0, batch, max_len, dtype,
                                            enc_len=enc_len, device=device)
    if cfg.scan_layers:
        # the reference stacks per-layer caches, which fails when their
        # lengths differ (a global layer among sliding ones)
        caps = {layer_cap(max_len, layer_window(cfg, i))
                for i in range(start, cfg.n_layers)}
        if len(caps) != 1:
            raise ValueError(f"{cfg.name}: a scan-stacked tree cannot hold "
                             f"caches of lengths {sorted(caps)}")
        caches["blocks"] = init_layer_cache(
            cfg, start, batch, max_len, dtype, enc_len=enc_len,
            lead=(cfg.n_layers - start,), device=device)
    else:
        caches["blocks"] = [init_layer_cache(cfg, i, batch, max_len, dtype,
                                             enc_len=enc_len, device=device)
                            for i in range(start, cfg.n_layers)]
    return caches


def init_layer_states(cfg, batch: int, device=None) -> list:
    """Empty recurrent state of every xLSTM block, one tree per layer."""
    return [{"ssm": (ssm.init_mlstm_state if block_kind(cfg, i) == "mlstm"
                     else ssm.init_slstm_state)(batch, cfg, device=device)}
            for i in range(cfg.n_layers)]
