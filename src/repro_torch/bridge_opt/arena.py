"""StagingArena — persistent, budgeted pinned staging (paper §5.2 / §8 rule 2).

The 44x op class exists because the default runtime allocates a *fresh*
pinned staging buffer per small crossing (§5.2: 1,138 `aten::_to_copy` calls
x 1,357 us).  The recovery is not "register everything forever" — pinned
host memory is a real, bounded resource — but a persistent arena: a
size-class slab allocator of registered staging buffers with a byte budget,
LRU eviction, and observable hit/miss economics.

The arena replaces the TransferGateway's ad-hoc `_staging_registered`
shape-set.  FRESH -> REGISTERED promotion becomes a modeled, budgeted
decision:

  * a crossing whose size class already holds a pinned slot stages
    REGISTERED (warm toll only) and refreshes the slot's LRU position;
  * a first touch of a size class pins a new slot (the crossing itself pays
    the FRESH toll — allocation + registration happen on its critical path),
    evicting least-recently-used slots if the budget is exhausted;
  * a crossing larger than the whole budget can never be pinned and stages
    FRESH every time (`oversize`);
  * `prewarm()` pins expected classes *before* the workload, the §6.1
    prewarm idiom applied to staging instead of contexts — first touches
    then hit warm slots and the FRESH class disappears from the tape.

Every decision is tagged (`arena_hit` / `arena_miss`) on the crossing
record, so tape attribution can quantify exactly how much of the
fresh-staging class the arena removed.

PyTorch counterpart of ``repro.bridge_opt.arena`` (framework-free: the same
code).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import asdict, dataclass
from typing import Iterable

from repro_torch.core.bridge import StagingKind
from repro_torch.trace import opclasses as oc


@dataclass
class ArenaSlot:
    """One pinned, registered staging buffer of a fixed size class."""

    class_bytes: int
    hits: int = 0
    prewarmed: bool = False


@dataclass
class ArenaStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    #: misses that could never be pinned (size class exceeds the whole budget)
    oversize: int = 0
    pinned_bytes: int = 0
    high_water_bytes: int = 0
    prewarmed_slots: int = 0

    @property
    def hit_rate(self) -> float:
        """1.0 with no traffic: an idle arena is missing nothing."""
        total = self.hits + self.misses
        return self.hits / total if total else 1.0


class StagingArena:
    """Size-class slab allocator of persistent registered staging buffers."""

    def __init__(self, capacity_bytes: int, *, min_class_bytes: int = 64):
        if capacity_bytes <= 0:
            raise ValueError(f"arena needs a positive byte budget, got {capacity_bytes}")
        if min_class_bytes <= 0:
            raise ValueError(f"min_class_bytes must be positive, got {min_class_bytes}")
        self.capacity_bytes = int(capacity_bytes)
        self.min_class_bytes = int(min_class_bytes)
        #: size class -> slot, in LRU order (first = least recently used)
        self._slots: "OrderedDict[int, ArenaSlot]" = OrderedDict()
        self.stats = ArenaStats()

    # -- size classes ------------------------------------------------------------------

    def size_class(self, nbytes: int) -> int:
        """Smallest power-of-two class >= nbytes (floored at min_class_bytes)."""
        c = self.min_class_bytes
        n = max(int(nbytes), 1)
        while c < n:
            c <<= 1
        return c

    # -- the staging decision ----------------------------------------------------------

    def acquire(self, nbytes: int) -> tuple[StagingKind, str]:
        """Stage one crossing: returns (staging kind, arena tag).

        REGISTERED on a slab hit; FRESH on a miss (the crossing pays the
        allocation+registration toll and the class is pinned for next time,
        evicting LRU slots if the budget requires it).
        """
        cls = self.size_class(nbytes)
        if cls > self.capacity_bytes:
            self.stats.oversize += 1
            self.stats.misses += 1
            return StagingKind.FRESH, oc.ARENA_MISS
        slot = self._slots.get(cls)
        if slot is not None:
            slot.hits += 1
            self.stats.hits += 1
            self._slots.move_to_end(cls)
            return StagingKind.REGISTERED, oc.ARENA_HIT
        self._reserve(cls)
        self.stats.misses += 1
        return StagingKind.FRESH, oc.ARENA_MISS

    def _reserve(self, cls: int) -> ArenaSlot:
        while self.stats.pinned_bytes + cls > self.capacity_bytes:
            evicted_cls, _ = self._slots.popitem(last=False)
            self.stats.pinned_bytes -= evicted_cls
            self.stats.evictions += 1
        slot = ArenaSlot(cls)
        self._slots[cls] = slot
        self.stats.pinned_bytes += cls
        self.stats.high_water_bytes = max(self.stats.high_water_bytes,
                                          self.stats.pinned_bytes)
        return slot

    # -- prewarm (§6.1 idiom applied to staging) ---------------------------------------

    def prewarm(self, sizes: Iterable[int]) -> int:
        """Pin slots for the given buffer sizes before the workload starts.

        Registration cost is paid off the critical path (by contract, like
        SecureChannelPool.prewarm); subsequent first touches of these
        classes are warm hits.  Returns the number of slots newly pinned.
        """
        pinned = 0
        for nbytes in sizes:
            cls = self.size_class(nbytes)
            if cls > self.capacity_bytes or cls in self._slots:
                continue
            self._reserve(cls).prewarmed = True
            self.stats.prewarmed_slots += 1
            pinned += 1
        return pinned

    # -- inventory ---------------------------------------------------------------------

    def registered_classes(self) -> list[int]:
        """Pinned size classes in LRU order (first = next eviction victim)."""
        return list(self._slots)

    def stats_dict(self) -> dict:
        d = asdict(self.stats)
        d["hit_rate"] = self.stats.hit_rate
        d["capacity_bytes"] = self.capacity_bytes
        d["slots"] = len(self._slots)
        return d
