"""Paged KV page pool, block tables and packed ragged decode batches.

``PagePool`` is the reference's page pool: per layer a page store
(n_pages, page_size, kv_heads, head_dim) as torch zeros on a ``device``,
with allocation state and the metadata the reuse-aware offload policy and
the cluster's prefix-affinity routing read (per-page content hashes and
observation counts).  The cluster replica keeps one as its bookkeeping
pool at a (1, n_pages, block_tokens, 1, 1) shape, so its tensors are tiny.
``block_table_array`` and ``ragged_block_tables`` export its tables in the
paged kernel's dense and packed shapes.

``RaggedBatch`` describes one step's packed ready set: slot ids and
per-slot KV lengths, no padding.  The reference gathers those slots' cache
rows out of the resident cache and scatters them back around each step;
the port has no gather or scatter: decode writes each packed row's new K/V
in place and the paged kernel reads the resident cache directly
(``models.transformer.decode_attention``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclass
class PageMeta:
    page_id: int
    #: content hash of the token block this page holds (prefix caching key)
    token_hash: Optional[int] = None
    #: how many times this content has been observed (reuse evidence)
    seen_count: int = 0
    request_id: Optional[str] = None
    logical_index: int = -1   # position within the request's table


class PagePool:
    """One layer group's physical page pool + allocation state."""

    def __init__(self, n_pages: int, page_size: int, n_kv_heads: int,
                 head_dim: int, n_layers: int, dtype=torch.bfloat16,
                 device: DeviceLike = None):
        self.n_pages = n_pages
        self.page_size = page_size
        self.shape = (n_layers, n_pages, page_size, n_kv_heads, head_dim)
        self.device = resolve_device(device)
        self.k = torch.zeros(self.shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(self.shape, dtype=dtype, device=self.device)
        self.free: list[int] = list(range(n_pages))
        self.meta: dict[int, PageMeta] = {
            i: PageMeta(page_id=i) for i in range(n_pages)}
        #: content hash -> page id, for prefix reuse
        self.hash_index: dict[int, int] = {}
        self.seen_counts: dict[int, int] = {}

    # -- allocation ---------------------------------------------------------------------

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def allocate(self, request_id: str, n_tokens: int,
                 token_blocks: Optional[list[tuple]] = None
                 ) -> Optional[list[int]]:
        """Allocate a block table for a request; None if pool exhausted.

        token_blocks: per-page token tuples for content hashing (prefix reuse
        and offload-evidence tracking).
        """
        need = self.pages_needed(n_tokens)
        if len(self.free) < need:
            return None
        table = []
        for i in range(need):
            pid = self.free.pop()
            meta = self.meta[pid]
            meta.request_id = request_id
            meta.logical_index = i
            if token_blocks and i < len(token_blocks):
                h = hash(token_blocks[i])
                meta.token_hash = h
                self.seen_counts[h] = self.seen_counts.get(h, 0) + 1
                meta.seen_count = self.seen_counts[h]
            else:
                # page reused for unhashed content: drop the previous
                # occupant's hash or inventory() would advertise stale content
                meta.token_hash = None
                meta.seen_count = 0
            table.append(pid)
        return table

    def release(self, table: list[int]) -> None:
        for pid in table:
            meta = self.meta[pid]
            meta.request_id = None
            meta.logical_index = -1
            self.free.append(pid)

    def utilization(self) -> float:
        return 1.0 - len(self.free) / self.n_pages

    def inventory(self) -> set[int]:
        """Content hashes resident in allocated pages (the cluster router's
        prefix-affinity key: a request goes where its prompt blocks already
        are, so the prefix never re-crosses the bridge)."""
        return {m.token_hash for m in self.meta.values()
                if m.token_hash is not None and m.request_id is not None}

    # -- tensor ops -----------------------------------------------------------------------

    def write_token(self, layer: int, page_id: int, offset: int,
                    k_tok: torch.Tensor, v_tok: torch.Tensor) -> None:
        """Write one token's K/V into a page (decode append), in place."""
        self.k[layer, page_id, offset] = k_tok.to(self.k.dtype)
        self.v[layer, page_id, offset] = v_tok.to(self.v.dtype)

    def layer_views(self, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
        return self.k[layer], self.v[layer]


def block_table_array(tables: dict[str, list[int]], order: list[str],
                      pages_max: int) -> np.ndarray:
    """Dense (B, pages_max) int32 block-table batch for the kernel."""
    out = np.zeros((len(order), pages_max), np.int32)
    for i, rid in enumerate(order):
        t = tables[rid][:pages_max]
        out[i, :len(t)] = t
    return out


def ragged_block_tables(tables: dict[str, list[int]],
                        order: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """Packed (non-padded) block-table batch: one flat int32 page-id vector
    plus (B+1,) int32 row offsets (CSR-style), the paged-kernel shape of a
    ragged batch.  Total size is the pages actually allocated."""
    flat: list[int] = []
    offsets = np.zeros(len(order) + 1, np.int32)
    for i, rid in enumerate(order):
        t = tables[rid]
        flat.extend(t)
        offsets[i + 1] = offsets[i] + len(t)
    return np.asarray(flat, np.int32), offsets


@dataclass(frozen=True)
class RaggedBatch:
    """One packed decode step's ready set: slot ids + per-slot KV lengths.

    No padding anywhere: ``size`` is exactly the number of rows the forward
    executes, ``kv_lens`` are the per-slot prefix depths the pricing reads
    (``ComputeModel.decode_charge_packed``), and ``total_kv_tokens`` is the
    step's KV read traffic in tokens.  Slots keep engine order
    (ascending), so row ``i`` of the packed batch is slot ``slots[i]`` — the
    in-place cache write and the per-row token drain both key on that.
    """

    slots: tuple[int, ...]
    kv_lens: tuple[int, ...]

    def __post_init__(self):
        if len(self.slots) != len(self.kv_lens):
            raise ValueError(
                f"ragged batch needs one kv_len per slot: "
                f"{len(self.slots)} slots vs {len(self.kv_lens)} lens")

    @classmethod
    def from_slots(cls, pairs: Sequence[tuple[int, int]]) -> "RaggedBatch":
        """Build from (slot, kv_len) pairs, preserving caller order."""
        return cls(slots=tuple(int(s) for s, _ in pairs),
                   kv_lens=tuple(int(k) for _, k in pairs))

    @property
    def size(self) -> int:
        return len(self.slots)

    @property
    def total_kv_tokens(self) -> int:
        return int(sum(self.kv_lens))

    def offsets(self) -> np.ndarray:
        """CSR-style (size+1,) cumulative KV offsets of the packed rows."""
        out = np.zeros(self.size + 1, np.int64)
        np.cumsum(np.asarray(self.kv_lens, np.int64), out=out[1:])
        return out

    def slot_array(self) -> np.ndarray:
        return np.asarray(self.slots, np.int32)
