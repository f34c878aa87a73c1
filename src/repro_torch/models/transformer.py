"""Transformer assembly: dense decoders and xLSTM stacks.

PyTorch counterpart of ``repro.models.transformer``, for the configs this
package runs: dense GQA decoders with full attention, and xLSTM's
mLSTM/sLSTM stack.  Dense layers keep the reference's scan-stacked layout
(each leaf of ``params["blocks"]`` has a leading layers axis) and are
applied in a Python loop over views; xLSTM's heterogeneous blocks are a
per-layer list, as the reference unrolls them (``scan_layers=False``).

Cache layout (decode), as the reference builds it, so cache contents
compare one to one:
  dense: one tree ``{"k", "v", "pos"}`` stacked over layers, ``k``/``v``
         (L, B, cap, KV, D) and ``pos`` (L, B, cap).  Decode updates it
         *in place* and attends over it with the paged-attention kernel.
  xLSTM: a list of per-layer ``{"ssm": state}`` trees (``models/ssm.py``).
         Decode reads the stepping rows' state at ``slots`` and writes the
         new state back into those rows in place (``index_copy_``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.paged_attention import ops as pa_ops

from . import ssm
from .layers import (Params, apply_norm, attention_block, init_attention,
                     init_mlp, init_norm, mlp_block, qkv_projections)

#: tokens per KV page when a layer's resident cache is viewed as pages
PAGE_SIZE = 16


def check_supported(cfg) -> None:
    """Raise for a config whose layers this package cannot run yet, naming
    each missing feature.  Every arch's config loads (``get_config``) and
    prices; this is where the model refuses the families still to port."""
    missing = []
    if cfg.family == "ssm":
        if cfg.ssm_kind != "xlstm":
            missing.append(f"ssm_kind {cfg.ssm_kind!r}")
        if cfg.scan_layers:
            missing.append("scan-stacked (scan_layers=True) xLSTM trees")
    elif cfg.family != "dense":
        missing.append(f"family {cfg.family!r}")
    if cfg.sliding_window or cfg.global_layers:
        missing.append("sliding-window ring caches")
    if cfg.hybrid:
        missing.append("hybrid attention+SSM blocks")
    if cfg.use_mla:
        missing.append("MLA")
    if cfg.n_routed_experts:
        missing.append("MoE")
    if cfg.encoder_layers or cfg.frontend:
        missing.append("encoders and frontends")
    if cfg.family == "dense" and not cfg.scan_layers:
        missing.append("unstacked (scan_layers=False) dense trees")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to PyTorch yet "
            f"(ROADMAP.md, Queue 1 item 4)")


# ---------------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------------

def block_kind(cfg, layer_idx: int) -> str:
    """"mlstm" / "slstm" for xLSTM blocks (every ``slstm_every``-th is
    sLSTM), "dense" otherwise."""
    if cfg.family == "ssm":
        if cfg.slstm_every and (layer_idx % cfg.slstm_every
                                == cfg.slstm_every - 1):
            return "slstm"
        return "mlstm"
    return "dense"


def init_blocks(generator, cfg, *, device=None):
    """All decoder blocks' parameters: stacked on a leading layers axis
    (dense), or a per-layer list (xLSTM)."""
    if cfg.family == "ssm":
        return [init_xlstm_block(generator, cfg, i, device=device)
                for i in range(cfg.n_layers)]
    lead = (cfg.n_layers,)
    return {
        "attn_norm": init_norm(generator, cfg.d_model, cfg.norm_kind,
                               cfg.dtype, lead=lead, device=device),
        "attn": init_attention(generator, cfg, lead=lead, device=device),
        "mlp_norm": init_norm(generator, cfg.d_model, cfg.norm_kind,
                              cfg.dtype, lead=lead, device=device),
        "mlp": init_mlp(generator, cfg, lead=lead, device=device),
    }


def init_xlstm_block(generator, cfg, layer_idx: int, *, device=None) -> Params:
    init = (ssm.init_mlstm if block_kind(cfg, layer_idx) == "mlstm"
            else ssm.init_slstm)
    return {"norm": init_norm(generator, cfg.d_model, cfg.norm_kind,
                              cfg.dtype, device=device),
            "mix": init(generator, cfg, device=device)}


def layer_params(stacked: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked tree."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def block_apply(p: Params, x: torch.Tensor, cfg, *, mode: str,
                positions: torch.Tensor, cache: Optional[dict] = None,
                cache_index: Optional[torch.Tensor] = None,
                slots: Optional[torch.Tensor] = None,
                max_len: int = 0):
    """Apply one dense block.  Returns (x, new_cache).

    mode: "prefill" (build this layer's cache of ``max_len`` positions) or
    "decode" (update ``cache`` in place at ``[slots, cache_index]``).
    """
    h = apply_norm(p["attn_norm"], x, cfg.norm_kind)
    if mode == "prefill":
        y, kv = attention_block(p["attn"], h, cfg, positions=positions,
                                return_kv=True)
        new_cache = assemble_kv_cache(kv, max_len, positions, cfg.dtype)
    else:
        y = decode_attention(p["attn"], h, cfg, positions=positions,
                             cache=cache, cache_index=cache_index,
                             slots=slots)
        new_cache = cache
    # the reference's compiled (scanned / jitted) block feeds the MLP norm
    # the f32 residual sum before it is rounded to bf16 (XLA's default
    # excess precision removes that round trip); the stream keeps the
    # rounded sum
    resid = x.float() + y.float()
    h = apply_norm(p["mlp_norm"], resid, cfg.norm_kind).to(x.dtype)
    x = resid.to(x.dtype)
    x = x + mlp_block(p["mlp"], h, cfg)
    return x, new_cache


def xlstm_block_apply(p: Params, x: torch.Tensor, cfg, layer_idx: int, *,
                      mode: str, cache: Optional[dict] = None,
                      slots: Optional[torch.Tensor] = None,
                      norm_in: Optional[torch.Tensor] = None):
    """Apply one xLSTM block.  Returns (x, resid, new_cache): ``x`` the
    bf16 residual stream and ``resid`` the same sum in f32 before its
    rounding.

    mode: "prefill" (run the whole prompt from the empty state; the new
    cache is ``{"ssm": final state}``) or "decode" (step the rows at
    ``slots`` of ``cache`` and write their new state back in place).
    Slots must be distinct: duplicate rows in an in-place write have no
    defined winner.  ``norm_in`` is what the block's norm reads (default
    ``x``): the decode passes the previous block's f32 ``resid``, as the
    reference's compiled decode does (``_trunk``)."""
    kind = block_kind(cfg, layer_idx)
    h = apply_norm(p["norm"], x if norm_in is None else norm_in,
                   cfg.norm_kind).to(x.dtype)
    if mode == "decode":
        full = cache["ssm"]
        rows = slots.to(torch.int64)
        step = ssm.mlstm_step if kind == "mlstm" else ssm.slstm_step
        y, new = step(p["mix"], h, cfg, {k: t[rows] for k, t in full.items()})
        for name, t in full.items():
            t.index_copy_(0, rows, new[name].to(t.dtype))
        new_cache = cache
    else:
        fwd = ssm.mlstm_chunked if kind == "mlstm" else ssm.slstm_forward
        y, state = fwd(p["mix"], h, cfg, state=None)
        new_cache = {"ssm": state}
    resid = x.float() + y.float()
    return resid.to(x.dtype), resid, new_cache


# ---------------------------------------------------------------------------------
# KV cache plumbing
# ---------------------------------------------------------------------------------

def assemble_kv_cache(kv: tuple, cap: int, positions: torch.Tensor,
                      dtype) -> dict:
    """One-shot prefill cache write: pad computed K/V to the cache length,
    with ``pos`` -1 past the prompt."""
    k, v = kv
    s = k.shape[1]
    if s > cap:
        raise ValueError(f"prompt of {s} tokens does not fit a cache of {cap}")
    pos = positions[0] if positions.dim() > 1 else positions  # (S,)
    newk = F.pad(k.to(dtype), (0, 0, 0, 0, 0, cap - s))
    newv = F.pad(v.to(dtype), (0, 0, 0, 0, 0, cap - s))
    newpos = torch.cat([pos.to(torch.int32),
                        torch.full((cap - s,), -1, dtype=torch.int32,
                                   device=pos.device)])
    return {"k": newk, "v": newv,
            "pos": newpos.expand(k.shape[0], cap).contiguous()}


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


def decode_attention(p, h, cfg, *, positions, cache, cache_index, slots):
    """Decode attention for one new token per packed row, *in place*.

    Row ``i`` (slot ``slots[i]``, position ``cache_index[i]``) writes its
    new K/V into the resident cache at ``[slots[i], cache_index[i]]`` and
    attends over that slot's keys ``0 .. cache_index[i]`` with the paged
    kernel: the layer's (B, cap, KV, D) cache viewed as pages
    (B*cap/page, page, KV, D), block-table row ``slot*(cap/page) +
    arange(cap/page)`` and ``lengths = index + 1``.  Slots must be
    distinct: duplicate rows in an in-place write have no defined winner.

    For full-attention layers this selects exactly the keys of the
    reference's ``_ring_decode_attention`` ``pos`` mask (``0 <= pos <=
    index``): prefill sets ``pos`` to -1 past the prompt, and decode writes
    at ``index % cap == index`` because the engine retires a request at
    ``index >= max_len - 1``.  ``pos`` is kept up to date all the same, so
    cache contents compare with the reference's.
    """
    b = h.shape[0]
    q, k, v = qkv_projections(p, h, cfg, positions)
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    n_slots, cap = ck.shape[0], ck.shape[1]
    idx = cache_index.to(torch.int64)
    rows = slots.to(torch.int64)
    ck[rows, idx] = k[:, 0].to(ck.dtype)
    cv[rows, idx] = v[:, 0].to(cv.dtype)
    cpos[rows, idx] = cache_index.to(cpos.dtype)

    page = page_size_for(cap)
    kv_heads, hd = ck.shape[2], ck.shape[3]
    k_pages = ck.view(n_slots * cap // page, page, kv_heads, hd)
    v_pages = cv.view(n_slots * cap // page, page, kv_heads, hd)
    tables = slot_block_tables(slots, cap, page)
    lengths = (cache_index.to(torch.int32) + 1)
    out = pa_ops.paged_attention(q[:, 0].contiguous(), k_pages, v_pages,
                                 tables, lengths)
    return torch.einsum("bshk,hkd->bsd", out.view(b, 1, *out.shape[1:]),
                        p["wo"])


# ---------------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------------

def init_stacked_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                       device=None) -> dict:
    """Zeroed KV cache stacked over layers, ``pos`` -1 everywhere."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"kv": {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full(shape[:3], -1, dtype=torch.int32, device=device)}}


def init_layer_states(cfg, batch: int, device=None) -> list:
    """Empty recurrent state of every xLSTM block, one tree per layer."""
    return [{"ssm": (ssm.init_mlstm_state if block_kind(cfg, i) == "mlstm"
                     else ssm.init_slstm_state)(batch, cfg, device=device)}
            for i in range(cfg.n_layers)]
