"""Packed ragged decode batches (the reference's DESIGN.md §10).

``RaggedBatch`` describes one step's packed ready set: slot ids and
per-slot KV lengths, no padding.  The reference gathers those slots' cache
rows out of the resident cache and scatters them back around each step;
the port has no gather or scatter: decode writes each packed row's new K/V
in place and the paged kernel reads the resident cache directly
(``models.transformer.decode_attention``).  The reference's page pool
(``PagePool``), which serves its paged mode and feeds evictions to the
offload manager, is still to port; the port's ``serving/offload.py`` takes
its payloads from the caller.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass(frozen=True)
class RaggedBatch:
    """One packed decode step's ready set: slot ids + per-slot KV lengths.

    No padding anywhere: ``size`` is exactly the number of rows the forward
    executes and ``kv_lens`` are the per-slot prefix depths the pricing
    reads (``ComputeModel.decode_charge_packed``).  Slots keep engine order
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

    def slot_array(self) -> np.ndarray:
        return np.asarray(self.slots, np.int32)
