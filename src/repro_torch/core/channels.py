"""Secure-context pool and virtual clock.

The bridge law (bridge.py L4) says bandwidth lives in *contexts*, and contexts
have an expensive secure lifecycle (paper §6.1: 5.2 s cuCtxCreate + 3.9 s
cuCtxDestroy + 0.3 s pinned-slot allocation per 8-worker pool).  The paper's
loader result is that pooling + prewarming + async teardown moves that cost off
the critical path entirely.  This module is the reusable form of that idea:

  * ``VirtualClock``   — simulated time source so policies can be costed
                         deterministically on CPU (no sleeping).
  * ``SecureContext``  — one secure copy channel endpoint with lifecycle cost.
  * ``SecureChannelPool`` — pooled contexts: acquire/release, prewarm,
                         asynchronous teardown, lifecycle accounting.

The pool is deliberately runtime-agnostic: the loader drives it with shard
transfers, the gateway with per-step crossings, and the simulator with
synthetic schedules.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from .bridge import BridgeModel, Crossing, Direction

#: channel id stamped on ``kind="p2p"`` tape records (DESIGN.md §12).  Fabric
#: P2P is the one movement class CC does not serialize: it rides NVLink
#: inside the tenant's partition, never acquires a secure copy channel, and
#: therefore never competes with bridge crossings for the L4 context budget.
#: The sentinel keeps that structural fact machine-checkable — conformance
#: rejects any p2p record claiming a real (>= 0) channel.
P2P_CHANNEL = -1


class VirtualClock:
    """Deterministic simulated-time source.

    All bridge costs are *charged* to this clock rather than slept, so the
    whole serving/loading stack can be costed in microseconds of real time.
    A monotonic `now` plus an `advance_to` lets event-driven consumers (the
    simulator) and sequential consumers (the gateway) share one clock.
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._lock = threading.Lock()

    @property
    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance clock by negative dt={dt}")
        with self._lock:
            self._now += dt
            return self._now

    def advance_to(self, t: float) -> float:
        with self._lock:
            self._now = max(self._now, t)
            return self._now


@dataclass
class SecureContext:
    """One secure copy channel endpoint (CUDA-context analogue)."""

    ctx_id: int
    created_at: float
    #: time at which the channel next becomes free (serialization point, L1)
    busy_until: float = 0.0
    crossings: int = 0
    bytes_moved: int = 0
    destroyed: bool = False

    def submit(self, when: float, duration: float, nbytes: int) -> float:
        """Serialize a crossing onto this channel; returns completion time."""
        start = max(when, self.busy_until)
        self.busy_until = start + duration
        self.crossings += 1
        self.bytes_moved += nbytes
        return self.busy_until


@dataclass
class PoolStats:
    created: int = 0
    destroyed: int = 0
    create_time: float = 0.0
    destroy_time: float = 0.0
    pinned_alloc_time: float = 0.0
    critical_path_lifecycle: float = 0.0   # lifecycle cost paid on the critical path
    crossings: int = 0
    bytes_moved: int = 0
    #: fault-recovery context replacements (resilience.FaultInjector); the
    #: setup toll is charged by the injector's chan_reestablish record, not
    #: by the pool, so created/destroyed counters stay lifecycle-accurate
    #: while critical_path_lifecycle excludes the recovery path
    reestablished: int = 0


class SecureChannelPool:
    """Pool of secure contexts with explicit lifecycle economics.

    Modes (paper §6.1 loader ladder):
      * ``persistent=False`` — naive per-use contexts: every acquire pays
        create (and release pays destroy) on the critical path.  This is the
        253.66 s loader variant.
      * ``persistent=True``  — contexts created once, reused: lifecycle paid
        once per pool (the 19.99 s variant).
      * ``prewarm()``        — pay creation *before* the workload starts;
        ``teardown(async_=True)`` destroys off the critical path (8.36 s).
    """

    def __init__(
        self,
        bridge: BridgeModel,
        n_workers: int,
        clock: Optional[VirtualClock] = None,
        *,
        persistent: bool = True,
    ):
        if n_workers < 1:
            raise ValueError("pool needs at least one worker context")
        limit = bridge.profile.max_secure_contexts
        if bridge.cc_on and n_workers > limit:
            raise ValueError(
                f"{n_workers} contexts exceeds the system-wide secure copy "
                f"channel limit ({limit}) on {bridge.profile.name}"
            )
        self.bridge = bridge
        self.n_workers = n_workers
        self.clock = clock or VirtualClock()
        self.persistent = persistent
        self.stats = PoolStats()
        self._contexts: list[SecureContext] = []
        self._ids = itertools.count()
        self._prewarmed = False

    # -- lifecycle -------------------------------------------------------------------

    def _create_context(self, *, on_critical_path: bool) -> SecureContext:
        p = self.bridge.profile
        cost = p.context_create + p.pinned_slot_alloc
        self.stats.created += 1
        self.stats.create_time += p.context_create
        self.stats.pinned_alloc_time += p.pinned_slot_alloc
        if on_critical_path:
            self.clock.advance(cost)
            self.stats.critical_path_lifecycle += cost
        ctx = SecureContext(ctx_id=next(self._ids), created_at=self.clock.now)
        self._contexts.append(ctx)
        return ctx

    def _destroy_context(self, ctx: SecureContext, *, on_critical_path: bool) -> None:
        p = self.bridge.profile
        ctx.destroyed = True
        self.stats.destroyed += 1
        self.stats.destroy_time += p.context_destroy
        if on_critical_path:
            self.clock.advance(p.context_destroy)
            self.stats.critical_path_lifecycle += p.context_destroy

    def prewarm(self) -> float:
        """Create the whole pool before the workload starts (off critical path).

        Returns the wall time the prewarm itself takes (contexts are created
        concurrently by worker threads; creation is host-side and parallelizes
        across workers, so prewarm wall time ~= one create).
        """
        if self._prewarmed:
            return 0.0
        for _ in range(self.n_workers):
            self._create_context(on_critical_path=False)
        self._prewarmed = True
        p = self.bridge.profile
        return p.context_create + p.pinned_slot_alloc

    def ensure_ready(self) -> None:
        """Make the pool usable, paying creation on the critical path if needed."""
        if not self.persistent:
            return  # per-use contexts created in submit()
        while len(self.active_contexts()) < self.n_workers:
            self._create_context(on_critical_path=not self._prewarmed)

    def reestablish(self) -> int:
        """Fault recovery: replace one secure context after session loss.

        The oldest active context is torn down and a fresh one created in
        its place.  Both legs run ``on_critical_path=False`` — the caller
        (resilience.FaultInjector) charges the setup toll explicitly as a
        ``chan_reestablish`` tape record, which keeps the toll visible to
        stall attribution instead of buried in pool lifecycle accounting.
        Returns the new context id.
        """
        active = self.active_contexts()
        if active:
            victim = min(active, key=lambda c: c.created_at)
            self._destroy_context(victim, on_critical_path=False)
        ctx = self._create_context(on_critical_path=False)
        self.stats.reestablished += 1
        return ctx.ctx_id

    def teardown(self, *, async_: bool = True) -> float:
        """Destroy all contexts; async teardown keeps it off the critical path.

        Returns the critical-path time charged.
        """
        charged = 0.0
        for ctx in self.active_contexts():
            before = self.clock.now
            self._destroy_context(ctx, on_critical_path=not async_)
            charged += self.clock.now - before
        self._prewarmed = False
        return charged

    def active_contexts(self) -> list[SecureContext]:
        return [c for c in self._contexts if not c.destroyed]

    # -- transfer submission -----------------------------------------------------------

    def submit(self, crossing: Crossing, *, when: Optional[float] = None) -> float:
        """Schedule one crossing onto the least-busy channel; returns completion time.

        Under CC the channel serializes (L1): if every channel is busy, the
        crossing queues.  CC-off, channels are effectively unconstrained.
        """
        return self.submit_ex(crossing, when=when)[2]

    def submit_ex(self, crossing: Crossing, *,
                  when: Optional[float] = None) -> tuple[int, float, float]:
        """`submit` plus placement: returns ``(ctx_id, start, done)`` so the
        caller (the gateway's tape recorder) can attribute the crossing to the
        secure channel it actually serialized on."""
        if crossing.direction is Direction.P2P:
            # structural invariant, not a pricing choice: fabric P2P never
            # acquires a secure copy channel (it is the path CC does not
            # serialize) — route it through TransferGateway.p2p() instead
            raise ValueError(
                "P2P crossings do not ride secure copy channels "
                "(TransferGateway.p2p is the fabric path)")
        t = self.clock.now if when is None else when
        if not self.persistent:
            # naive variant: pay full lifecycle per crossing, serialized.
            # the returned interval covers the transfer only — the destroy
            # cost hits the clock but is lifecycle, not crossing time
            ctx = self._create_context(on_critical_path=True)
            dur = self.bridge.crossing_time(crossing, n_contexts=1)
            start = max(self.clock.now, ctx.busy_until)
            done = ctx.submit(self.clock.now, dur, crossing.nbytes)
            self.clock.advance_to(done)
            self._destroy_context(ctx, on_critical_path=True)
            self._count(crossing)
            return ctx.ctx_id, start, done

        self.ensure_ready()
        ctx = min(self.active_contexts(), key=lambda c: c.busy_until)
        # per-channel bandwidth: each context owns one secure channel
        dur = self.bridge.crossing_time(crossing, n_contexts=1)
        start = max(t, ctx.busy_until)
        done = ctx.submit(t, dur, crossing.nbytes)
        self._count(crossing)
        return ctx.ctx_id, start, done

    def drain(self) -> float:
        """Advance the clock until all in-flight crossings complete."""
        if self._contexts:
            self.clock.advance_to(max(c.busy_until for c in self.active_contexts() or self._contexts))
        return self.clock.now

    def _count(self, crossing: Crossing) -> None:
        self.stats.crossings += 1
        self.stats.bytes_moved += crossing.nbytes

    # -- aggregate view -----------------------------------------------------------------

    def aggregate_bandwidth(self, direction: Direction) -> float:
        return self.bridge.aggregate_bandwidth(direction, len(self.active_contexts()) or self.n_workers)
