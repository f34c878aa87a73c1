"""CrossingCoalescer — queue sub-threshold crossings, flush them fused.

§8 rule 1 says small crossings must be batched; the engine's `batch_h2d`
does that eagerly *within* one call site.  The coalescer generalizes it
across call sites and steps: sub-threshold crossings queue per direction
and flush as ONE fused REGISTERED crossing when any trigger fires:

  * watermark  — queued bytes reach `watermark_bytes` (the flush buffer
                 is full),
  * deadline   — the oldest queued crossing has waited `deadline_s` on the
                 virtual clock (latency bound).  With the engine charging
                 decode compute to the clock (core.compute, DESIGN.md §7)
                 this trigger is live in steady-state serving: every step's
                 forward moves time, so queued drains age and flush within
                 the deadline instead of waiting for the queue cap.  Call
                 sites that charge non-crossing time must `poll()` after
                 the charge so aged queues flush promptly,
  * queue cap  — the coalescer's index table is full (`max_queued`
                 entries; a backstop — with compute charged the deadline
                 fires first, which is why the cap is tight),
  * barrier    — an explicit flush (engine run end / close / caller sync).

Data still moves immediately (a real upload to the gateway's device, a
real copy back to the host — callers get real values); what is deferred is
the *bridge charge*: one toll for N
crossings instead of N tolls.  This is the modeled form of vLLM-style
drain buffering: sampled tokens stay usable on-device for the next step
while their host drain is amortized.

Flush staging follows the same first-touch economics as everything else:
the flush buffer is a persistent watermark-sized slab — acquired from the
gateway's StagingArena when one is attached (a stable size class, so both
directions share one slab), otherwise FRESH on the first flush per
direction and REGISTERED after.

Conservation invariants (property-tested): flushes conserve total bytes
and crossing count, and no queued crossing is ever dropped — a barrier or
close always drains both queues.

PyTorch counterpart of ``repro.bridge_opt.coalescer``; the degradation
ladder's coalescer-bypass rung calls ``set_bypass``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Optional

import numpy as np
import torch

from repro_torch.core.bridge import Crossing, Direction, StagingKind
from repro_torch.core.gateway import _to_device
from repro_torch.trace import opclasses as oc

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.gateway import TransferGateway


@dataclass
class _Pending:
    nbytes: int
    op_class: str
    enqueued_t: float


@dataclass
class CoalescerStats:
    queued: int = 0
    queued_bytes: int = 0
    passthrough: int = 0
    passthrough_bytes: int = 0
    #: source crossings fused into flushed crossings so far
    fused_crossings: int = 0
    fused_bytes: int = 0
    #: flush count per trigger ("watermark"/"deadline"/"queue_cap"/"barrier")
    flushes: dict = field(default_factory=dict)
    max_queue_depth: int = 0
    #: D2H flushes taken by the worker channel instead of the engine clock
    #: (worker-drain x coalescer composition)
    worker_flushes: int = 0
    #: engine-clock seconds charged for worker flush handoffs
    worker_handoff_s: float = 0.0
    #: degradation-ladder bypass entries (each entry barrier-flushed first)
    bypass_entries: int = 0
    #: poll() calls by source ("clock" = ordinary after-charge polls;
    #: "deferral" = slot-masked decode polling after a step deferred slots,
    #: so a deferred slot's queued flushes keep aging — DESIGN.md §8)
    polls: dict = field(default_factory=dict)

    @property
    def n_flushes(self) -> int:
        return sum(self.flushes.values())

    @property
    def deadline_flushes(self) -> int:
        return self.flushes.get("deadline", 0)

    @property
    def crossings_saved(self) -> int:
        """Tolls avoided: N queued crossings became n_flushes fused ones."""
        return self.fused_crossings - self.n_flushes


class CrossingCoalescer:
    OP_CLASS = {Direction.H2D: oc.COALESCED_H2D, Direction.D2H: oc.COALESCED_D2H}

    def __init__(self, gateway: "TransferGateway", *,
                 threshold_bytes: int = 4096,
                 watermark_bytes: int = 32 << 10,
                 deadline_s: float = 500e-6,
                 max_queued: int = 32,
                 worker_flush: bool = False,
                 worker_handoff_s: float = 20e-6):
        if threshold_bytes <= 0 or watermark_bytes <= 0 or max_queued < 1:
            raise ValueError("coalescer thresholds must be positive")
        if worker_handoff_s < 0:
            raise ValueError("worker handoff cost cannot be negative")
        self.gateway = gateway
        self.threshold_bytes = int(threshold_bytes)
        self.watermark_bytes = int(watermark_bytes)
        self.deadline_s = float(deadline_s)
        self.max_queued = int(max_queued)
        #: worker-drain x coalescer composition: D2H flushes serialize on a
        #: secure channel (the worker thread's seat) instead of the engine
        #: clock; the engine pays only a small handoff per flush.  H2D
        #: flushes gate the next forward's inputs and stay on the engine.
        self.worker_flush = bool(worker_flush)
        self.worker_handoff_s = float(worker_handoff_s)
        self._q: dict[Direction, list[_Pending]] = {
            Direction.H2D: [], Direction.D2H: []}
        #: directions whose flush buffer exists (no-arena staging machine)
        self._flush_buffer_registered: set[Direction] = set()
        #: degradation-ladder bypass (DESIGN.md §11): while set, every
        #: submission takes the passthrough path — a fused flush is one
        #: ciphertext, so under MAC-reject pressure any constituent failure
        #: re-pays the whole flush; bypassed crossings retry only themselves
        self.bypass = False
        self.stats = CoalescerStats()

    def set_bypass(self, on: bool) -> float:
        """Enter/leave coalescer bypass; entering drains both queues with a
        barrier flush first so no queued crossing is stranded un-aged."""
        charged = 0.0
        if on and not self.bypass:
            charged = self.barrier()
            self.stats.bypass_entries += 1
        self.bypass = bool(on)
        return charged

    # -- queue views -------------------------------------------------------------------

    def pending(self, direction: Optional[Direction] = None) -> int:
        if direction is not None:
            return len(self._q[direction])
        return sum(len(q) for q in self._q.values())

    def pending_bytes(self, direction: Direction) -> int:
        return sum(p.nbytes for p in self._q[direction])

    # -- submission --------------------------------------------------------------------

    def h2d(self, host_array: Any, *, op_class: str = "h2d") -> torch.Tensor:
        """Host-to-device: real transfer now, bridge charge deferred if small."""
        arr = np.asarray(host_array)
        nbytes = int(arr.nbytes)
        if self.bypass or nbytes > self.threshold_bytes:
            self.stats.passthrough += 1
            self.stats.passthrough_bytes += nbytes
            dev = self.gateway.h2d(arr, op_class=op_class, reuse_staging=True)
            self.poll()   # the passthrough charge moved the clock
            return dev
        dev = _to_device(arr, self.gateway.device)
        self._enqueue(nbytes, Direction.H2D, op_class)
        return dev

    def d2h(self, device_array: torch.Tensor, *,
            op_class: str = "d2h") -> np.ndarray:
        """Device-to-host: values are available immediately (the engine needs
        them to continue); the drain's toll joins the fused flush."""
        # size from the device-side metadata: the actual copy happens once,
        # on whichever path the threshold picks
        nbytes = int(device_array.nbytes)
        if self.bypass or nbytes > self.threshold_bytes:
            self.stats.passthrough += 1
            self.stats.passthrough_bytes += nbytes
            host = self.gateway.d2h(device_array, op_class=op_class)
            self.poll()   # the passthrough charge moved the clock
            return host
        host = device_array.cpu().numpy()
        self._enqueue(nbytes, Direction.D2H, op_class)
        return host

    def charge(self, nbytes: int, direction: Direction, *, op_class: str) -> None:
        """Metadata-only submission (offload spills): no payload moves here."""
        nbytes = int(nbytes)
        if self.bypass or nbytes > self.threshold_bytes:
            self.stats.passthrough += 1
            self.stats.passthrough_bytes += nbytes
            self.gateway.charge_crossing(nbytes, direction, op_class=op_class)
            self.poll()   # the passthrough charge moved the clock
            return
        self._enqueue(nbytes, direction, op_class)

    def _enqueue(self, nbytes: int, direction: Direction, op_class: str) -> None:
        self.poll()                 # aged queues flush before the append
        q = self._q[direction]
        q.append(_Pending(nbytes, op_class, self.gateway.clock.now))
        self.stats.queued += 1
        self.stats.queued_bytes += nbytes
        self.stats.max_queue_depth = max(self.stats.max_queue_depth, len(q))
        if self.pending_bytes(direction) >= self.watermark_bytes:
            self.flush(direction, trigger="watermark")
        elif len(q) >= self.max_queued:
            self.flush(direction, trigger="queue_cap")

    def poll(self, *, source: str = "clock") -> float:
        """Fire the deadline trigger against the current virtual clock.

        Submissions check the deadline themselves; any call site that moves
        the clock *without* submitting — above all the engine's per-step
        compute charge — polls afterwards so queued crossings flush within
        `deadline_s` of enqueue under any interleaving of charges (the
        property the hypothesis suite pins).  `source` labels why the caller
        polled (slot-masked decode polls with "deferral" when a step masks
        slots out, so a deferred slot's queued flushes still age instead of
        waiting for that slot to submit again).  Returns the bridge time
        charged to the engine clock.
        """
        self.stats.polls[source] = self.stats.polls.get(source, 0) + 1
        charged = 0.0
        now = self.gateway.clock.now
        for d, q in self._q.items():
            if q and now - q[0].enqueued_t >= self.deadline_s:
                charged += self.flush(d, trigger="deadline")
        return charged

    # -- flush -------------------------------------------------------------------------

    def _flush_staging(self, direction: Direction) -> tuple[StagingKind, tuple[str, ...]]:
        arena = self.gateway.arena
        if arena is not None:
            kind, tag = arena.acquire(self.watermark_bytes)
            return kind, (tag,)
        if direction in self._flush_buffer_registered:
            return StagingKind.REGISTERED, ()
        self._flush_buffer_registered.add(direction)
        return StagingKind.FRESH, ()

    def flush(self, direction: Optional[Direction] = None, *,
              trigger: str = "barrier") -> float:
        """Flush queued crossings as one fused crossing per direction;
        returns the bridge time charged."""
        dirs = [direction] if direction is not None else list(self._q)
        charged = 0.0
        for d in dirs:
            q = self._q[d]
            if not q:
                continue
            total = sum(p.nbytes for p in q)
            n = len(q)
            # v3 provenance: the fused record re-lists its constituents so
            # attribution/replay can un-fuse it, and names the trigger that
            # fired — the stall attributor prices deadline flushes as
            # coalescer-injected latency, not useful batching
            sources = tuple((p.op_class, p.nbytes) for p in q)
            q.clear()
            staging, tags = self._flush_staging(d)
            tags = tags + (f"flush_{trigger}",)
            if self.worker_flush and d is Direction.D2H:
                # composition (ROADMAP "worker drain x coalescer"): the
                # worker thread owns the fused drain — it serializes on a
                # secure channel (L1 holds there) while the engine pays only
                # the handoff; token values were already materialized at
                # d2h() time, so nothing downstream waits on the flush.
                self.gateway.pooled_crossing(
                    Crossing(total, d, staging),
                    op_class=self.OP_CLASS[d], tags=tags, sources=sources)
                self.gateway.clock.advance(self.worker_handoff_s)
                self.stats.worker_flushes += 1
                self.stats.worker_handoff_s += self.worker_handoff_s
                charged += self.worker_handoff_s
            else:
                charged += self.gateway.charge_crossing(
                    total, d, staging=staging, op_class=self.OP_CLASS[d],
                    tags=tags, sources=sources)
            self.stats.fused_crossings += n
            self.stats.fused_bytes += total
            self.stats.flushes[trigger] = self.stats.flushes.get(trigger, 0) + 1
        if charged > 0:
            # the flush charge itself moved the clock: re-check every queue
            # so no queued crossing silently outlives its deadline
            # (recursion terminates — a flushed queue is empty)
            charged += self.poll()
        return charged

    def barrier(self) -> float:
        """Explicit barrier: drain both queues (never drops a crossing)."""
        return self.flush(trigger="barrier")

    def close(self) -> float:
        return self.barrier()
