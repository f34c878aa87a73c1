"""Plain PyTorch version of the paged-attention decode kernel.

Gathers each sequence's pages into a contiguous KV view and runs masked
single-token attention in f32, with the reference decode path's arithmetic
(logits scaled after the product, positions at or past the length masked
with -1e30, softmax, product with V).  Used for CPU tensors, by the tests,
and by ``chip_smoke.py`` to hold the kernel to it on the card.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_attention_ref(q, k_pages, v_pages, block_tables,
                        lengths) -> torch.Tensor:
    """q: (B, H, D); k_pages/v_pages: (P, page, KV, D); block_tables:
    (B, pages_max) int32; lengths: (B,) int32, each >= 1.  Returns (B, H, D)."""
    b, h, d = q.shape
    pages_max = block_tables.shape[1]
    page, kv = k_pages.shape[1], k_pages.shape[2]
    rep = h // kv
    tables = block_tables.long()
    k_seq = k_pages[tables].reshape(b, pages_max * page, kv, d)
    v_seq = v_pages[tables].reshape(b, pages_max * page, kv, d)
    k_seq = torch.repeat_interleave(k_seq, rep, dim=2)
    v_seq = torch.repeat_interleave(v_seq, rep, dim=2)
    logits = torch.einsum("bhd,bkhd->bhk", q.float(),
                          k_seq.float()) * (1.0 / math.sqrt(d))
    pos = torch.arange(pages_max * page, device=q.device)[None, :]
    mask = pos < lengths.to(q.device).long()[:, None]
    logits = torch.where(mask[:, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", probs, v_seq.float()).to(q.dtype)
