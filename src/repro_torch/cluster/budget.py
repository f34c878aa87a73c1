"""Cluster-wide secure-context and pinned-memory budgets (paper §4 L4 at
fleet scale).

Under GPU-CC, bridge bandwidth is bought with secure copy contexts, and the
context count is a *system-wide* limit (`BridgeProfile.max_secure_contexts`),
not a per-process one.  At cluster scale that makes contexts a shared,
schedulable resource: every replica's channel pool draws a lease from one
budget, so adding replicas *redistributes* bridge bandwidth across the fleet
rather than multiplying it.  CC-off there is no secure channel and the budget
is unconstrained — the CC-mode asymmetry every other layer of this repo
models, surfacing at the resource-allocation layer.

Pinned host memory is the same shape one resource over (`PinnedBudget`):
each replica's StagingArena pins `staging_arena_bytes` of host memory, and
pinned pages are a host-wide commodity the kernel will not overcommit —
bounce buffers, the secure channels' staging slots and every arena slab all
draw from it.  The cluster therefore plans both L4 resources: contexts from
`SecureContextBudget` (partial grants shrink), arena bytes from
`PinnedBudget` (over-subscription is *rejected* at replica spawn — a
shrunken arena silently changes hit rates, so the planner must resize the
fleet explicitly instead).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Optional, Union

from repro_torch.core.bridge import BridgeProfile


class BudgetExhausted(RuntimeError):
    """No secure contexts left in the system-wide pool."""


@dataclass(frozen=True)
class ContextLease:
    """A replica's claim on part of the system-wide secure-context pool."""

    lease_id: int
    holder: str
    n_contexts: int


class SecureContextBudget:
    """Tracks secure-context leases against the system-wide channel limit.

    `limit is None` means unconstrained (CC-off: no secure channels exist,
    so the pool size is a tuning knob, not a scarce resource).
    """

    def __init__(self, profile: BridgeProfile, *, cc_on: bool = True,
                 limit: Optional[int] = None):
        self.profile = profile
        self.cc_on = cc_on
        if limit is not None:
            self.limit: Optional[int] = limit
        else:
            self.limit = profile.max_secure_contexts if cc_on else None
        self._leases: dict[str, ContextLease] = {}
        self._ids = itertools.count()

    # -- accounting ------------------------------------------------------------------

    def allocated(self) -> int:
        return sum(l.n_contexts for l in self._leases.values())

    def available(self) -> Union[int, float]:
        if self.limit is None:
            return math.inf
        return self.limit - self.allocated()

    def utilization(self) -> float:
        if self.limit is None:
            return 0.0
        return self.allocated() / self.limit

    def leases(self) -> dict[str, ContextLease]:
        return dict(self._leases)

    # -- lease lifecycle -------------------------------------------------------------

    def acquire(self, holder: str, requested: int) -> ContextLease:
        """Grant up to `requested` contexts; partial grants shrink to what is
        left in the pool.  Raises BudgetExhausted when nothing is left."""
        if requested < 1:
            raise ValueError(f"lease needs at least one context, got {requested}")
        if holder in self._leases:
            raise ValueError(f"{holder!r} already holds a lease; release it first")
        if self.limit is None:
            grant = requested
        else:
            avail = self.limit - self.allocated()
            if avail < 1:
                raise BudgetExhausted(
                    f"system-wide secure-context limit ({self.limit}) exhausted "
                    f"by {len(self._leases)} leaseholders")
            grant = min(requested, avail)
        lease = ContextLease(next(self._ids), holder, grant)
        self._leases[holder] = lease
        return lease

    def release(self, holder: str) -> None:
        self._leases.pop(holder, None)

    # -- fleet planning --------------------------------------------------------------

    def fair_share(self, n_holders: int, requested: int) -> list[int]:
        """Per-holder grants for a fleet of `n_holders` each wanting
        `requested` contexts: even split of the system-wide limit, capped by
        the request.  This is the redistribution law — grow the fleet past
        limit/requested and every member's bridge bandwidth shrinks.
        """
        if n_holders < 1:
            raise ValueError("need at least one holder")
        if self.limit is None:
            return [requested] * n_holders
        if n_holders > self.limit:
            raise BudgetExhausted(
                f"{n_holders} replicas cannot each hold a secure context "
                f"under the system-wide limit ({self.limit})")
        base, extra = divmod(self.limit, n_holders)
        shares = [base + (1 if i < extra else 0) for i in range(n_holders)]
        return [min(requested, s) for s in shares]


# ---------------------------------------------------------------------------------
# Pinned host memory: the second host-wide L4 resource the cluster plans
# ---------------------------------------------------------------------------------

#: pinned staging slot each secure channel context owns (bounce buffer the
#: channel encrypts out of) — leased per context alongside the arena bytes
CHANNEL_SLOT_BYTES = 1 << 20

#: pinned flush buffer the small-crossing coalescer accumulates into when a
#: replica opts in to coalesce_small_crossings
COALESCER_FLUSH_BYTES = 32 << 10


def replica_pinned_bytes(arena_bytes: int, n_contexts: int,
                         coalescer_watermark_bytes: int = 0) -> int:
    """Total pinned bytes one replica holds from the host pool.

    Everything a replica pins draws from the same host-wide commodity: the
    staging arena's slabs, one `CHANNEL_SLOT_BYTES` slot per leased secure
    context, and the coalescer's flush buffer when small-crossing fusion is
    on.  The cluster leases this sum — not just the arena — so a fleet that
    widens its channel pools sees the pinned budget tighten accordingly.
    """
    if arena_bytes < 0 or n_contexts < 0 or coalescer_watermark_bytes < 0:
        raise ValueError(
            f"pinned components cannot be negative: arena={arena_bytes} "
            f"contexts={n_contexts} coalescer={coalescer_watermark_bytes}")
    return (int(arena_bytes) + int(n_contexts) * CHANNEL_SLOT_BYTES
            + int(coalescer_watermark_bytes))


@dataclass(frozen=True)
class PinnedLease:
    """A replica's claim on the host-wide pinned-memory pool (arena bytes)."""

    lease_id: int
    holder: str
    nbytes: int


class PinnedBudget:
    """Host-wide pinned-byte budget for replica staging arenas.

    Sibling to `SecureContextBudget` with one deliberate asymmetry: context
    leases shrink to what is left (fewer channels = less bandwidth, still
    correct), but an arena lease is **full grant or rejection** — a replica
    spawned with a silently smaller arena than its config asked for would
    evict slabs the deployment was sized around, so over-subscription
    surfaces at spawn time as `BudgetExhausted` instead of as a runtime
    hit-rate regression.  ``limit_bytes is None`` means unconstrained (the
    operator has not declared a host pinned budget).
    """

    def __init__(self, limit_bytes: Optional[int] = None):
        if limit_bytes is not None and limit_bytes < 0:
            raise ValueError(f"pinned budget cannot be negative: {limit_bytes}")
        self.limit_bytes = limit_bytes
        self._leases: dict[str, PinnedLease] = {}
        self._ids = itertools.count()

    # -- accounting ------------------------------------------------------------------

    def allocated(self) -> int:
        return sum(l.nbytes for l in self._leases.values())

    def available(self) -> Union[int, float]:
        if self.limit_bytes is None:
            return math.inf
        return self.limit_bytes - self.allocated()

    def utilization(self) -> float:
        if self.limit_bytes is None or self.limit_bytes == 0:
            return 0.0
        return self.allocated() / self.limit_bytes

    def leases(self) -> dict[str, PinnedLease]:
        return dict(self._leases)

    # -- lease lifecycle -------------------------------------------------------------

    def acquire(self, holder: str, nbytes: int) -> PinnedLease:
        """Lease exactly `nbytes` of pinned memory; raises BudgetExhausted
        when the host pool cannot cover it (no partial grants — see class
        docstring).  A zero-byte lease is legal: a replica running with the
        legacy unbudgeted staging holds a recorded, empty claim."""
        if nbytes < 0:
            raise ValueError(f"lease cannot be negative: {nbytes}")
        if holder in self._leases:
            raise ValueError(f"{holder!r} already holds a pinned lease; "
                             f"release it first")
        if self.limit_bytes is not None and nbytes > self.available():
            raise BudgetExhausted(
                f"pinned budget over-subscribed: {holder!r} wants {nbytes} B "
                f"but only {self.available()} of {self.limit_bytes} B remain "
                f"({len(self._leases)} leaseholders)")
        lease = PinnedLease(next(self._ids), holder, int(nbytes))
        self._leases[holder] = lease
        return lease

    def release(self, holder: str) -> None:
        self._leases.pop(holder, None)

    # -- fleet planning --------------------------------------------------------------

    def max_replicas(self, arena_bytes: int) -> Union[int, float]:
        """How many replicas of `arena_bytes` each the host pool can pin —
        the arena-side sibling of `SecureContextBudget.fair_share`."""
        if self.limit_bytes is None:
            return math.inf
        if arena_bytes <= 0:
            return math.inf
        return (self.limit_bytes - self.allocated()) // arena_bytes
