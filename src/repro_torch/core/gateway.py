"""TransferGateway — runtime host<->device crossing discipline (paper §8 rule 1).

"A CC-aware runtime should treat bridge crossings as a scheduled, scarce
resource — batched, drained, and kept off the critical path."

The gateway is the single choke point through which the serving engine, the
loader and the KV-offload policy move bytes across the bridge.  It

  * executes the *real* transfer (``torch.from_numpy(a).to(device)`` up,
    a blocking ``tensor.cpu().numpy()`` down),
  * charges the bridge-law cost of the crossing to a virtual clock (so CC
    economics are measurable deterministically on CPU),
  * records a ``CopyRecord`` per crossing for the accounting loop (§5.2),
  * implements the CC-aware disciplines: small-crossing batching, drained
    submission, and context-pooled bulk transfers.

On the card every crossing is a real copy over the host link; the
virtual-clock charge beside it prices the same crossing under the bridge
law, so every policy can be costed whatever link the run actually had.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

from .accounting import CopyRecord
from .bridge import BridgeModel, Crossing, Direction, StagingKind
from .channels import P2P_CHANNEL, SecureChannelPool, VirtualClock
from .policy import RuntimeDefaults, SchedulingPolicy


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """The real upload: a host array copied onto ``device``."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _nbytes(x: Any) -> int:
    if hasattr(x, "nbytes"):
        return int(x.nbytes)
    return int(np.asarray(x).nbytes)


@dataclass
class GatewayStats:
    h2d_crossings: int = 0
    d2h_crossings: int = 0
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    batched_crossings_saved: int = 0
    bridge_time_s: float = 0.0
    # ---- device-local compute (core.compute.ComputeModel charges) -------------
    compute_charges: int = 0
    compute_time_s: float = 0.0
    # ---- in-tenant fabric P2P (never the bridge; DESIGN.md §12) ---------------
    p2p_crossings: int = 0
    p2p_bytes: int = 0
    p2p_time_s: float = 0.0
    p2p_fallback_crossings: int = 0


class TransferGateway:
    """All host<->device movement goes through here."""

    def __init__(
        self,
        bridge: BridgeModel,
        defaults: RuntimeDefaults,
        *,
        clock: Optional[VirtualClock] = None,
        pool_workers: int = 1,
        device: DeviceLike = None,
        arena: Optional[Any] = None,
    ):
        self.bridge = bridge
        self.defaults = defaults
        self.clock = clock or VirtualClock()
        #: where uploads land: the card unless the caller passes "cpu"
        self.device = resolve_device(device)
        self.pool = SecureChannelPool(
            bridge, n_workers=max(1, pool_workers), clock=self.clock)
        self.stats = GatewayStats()
        self.records: list[CopyRecord] = []
        #: emit hooks: every finished crossing is pushed to each subscriber
        #: (trace.TraceRecorder attaches here to build a BridgeTape)
        self.on_record: list[Callable[[CopyRecord], None]] = []
        #: optional bridge_opt.StagingArena — when attached, staging is a
        #: budgeted slab resource instead of the unbounded registered set
        self.arena = arena
        #: optional resilience.FaultInjector — when attached (via its own
        #: ``attach``), every charged crossing routes through the injector's
        #: submit-path hook (brownout scaling, teardown, MAC-reject retries).
        #: None means the fault-free fast path: zero extra work, golden tapes
        #: unchanged.
        self.faults: Optional[Any] = None
        #: optional fabric.FabricTransport — when attached, ``p2p`` prices
        #: in-tenant device-to-device movement against the tenant's live
        #: fabric state (full P2P rate when healthy+attested, TCP fallback
        #: otherwise).  None means no fabric view: ``p2p`` assumes the
        #: profile's fabric is up (single-tenant bench paths).
        self.fabric: Optional[Any] = None
        self._staging_registered: set[tuple] = set()

    def _faulted_cost(self, op_class: str, crossing: Crossing, cost: float, *,
                      n_units: int = 1) -> float:
        """Route a charged crossing through the fault injector, if any."""
        if self.faults is None:
            return cost
        return self.faults.on_crossing(op_class, crossing, cost,
                                       n_units=n_units)

    # -- staging discipline -----------------------------------------------------------

    def _staging_kind(self, shape: tuple[int, ...], dtype: Any, nbytes: int, *,
                      reuse_staging: bool) -> tuple[StagingKind, tuple[str, ...]]:
        """Resolve a crossing's staging path; returns (kind, record tags).

        With a StagingArena attached, *every* crossing stages through the
        persistent slab pool — the arena replaces per-call fresh allocation
        even on the non-reuse (async) path, which is exactly the fix for
        the 44x class.  Without one, the legacy machine applies: FRESH on
        first sight of a (shape, dtype) buffer unless the caller drains and
        reuses staging (the sync/worker pattern); REGISTERED afterwards.
        Keying on (shape, dtype) — not shape alone — keeps two buffers of
        equal shape but different element width from sharing a slot.
        """
        if self.arena is not None:
            kind, tag = self.arena.acquire(nbytes)
            return kind, (tag,)
        key = (tuple(shape), str(dtype))
        if reuse_staging and key in self._staging_registered:
            return StagingKind.REGISTERED, ()
        if reuse_staging:
            self._staging_registered.add(key)
            return StagingKind.FRESH, ()  # first touch registers the slot
        return StagingKind.FRESH, ()

    # -- crossings ---------------------------------------------------------------------

    def h2d(self, host_array: np.ndarray, *, op_class: str = "h2d",
            reuse_staging: bool = True) -> torch.Tensor:
        """One host-to-device crossing: real device_put + bridge-law charge."""
        arr = np.asarray(host_array)
        staging, tags = self._staging_kind(arr.shape, arr.dtype, int(arr.nbytes),
                                           reuse_staging=reuse_staging)
        crossing = Crossing(int(arr.nbytes), Direction.H2D, staging)
        cost = self.bridge.crossing_time(crossing, n_contexts=self.pool.n_workers)
        cost = self._faulted_cost(op_class, crossing, cost)
        end = self.clock.advance(cost)
        self._record(crossing, cost, op_class, t_end=end, tags=tags)
        return _to_device(arr, self.device)

    def d2h(self, device_array: torch.Tensor, *, op_class: str = "d2h",
            tags: tuple = (), raw_bytes: int = 0,
            codec: str = "") -> np.ndarray:
        """One device-to-host crossing (the drain).  Blocking under CC (L2).

        Drain staging follows the same economics as uploads: with a
        StagingArena attached the bounce buffer is a budgeted slab (first
        touch of a size class pays the FRESH toll exactly once, then warm
        hits), so D2H first-touch is priced like H2D instead of assuming a
        pre-registered buffer the runtime never paid for.  Without an arena
        the legacy model applies — the engine owns one persistent output
        staging buffer, so drains stay REGISTERED.
        """
        nbytes = _nbytes(device_array)
        if self.arena is not None:
            staging, tag = self.arena.acquire(nbytes)
            tags = tuple(tags) + (tag,)
        else:
            staging = StagingKind.REGISTERED
        crossing = Crossing(nbytes, Direction.D2H, staging)
        cost = self.bridge.crossing_time(crossing, n_contexts=self.pool.n_workers)
        cost = self._faulted_cost(op_class, crossing, cost)
        end = self.clock.advance(cost)
        self._record(crossing, cost, op_class, t_end=end, tags=tags,
                     raw_bytes=raw_bytes, codec=codec)
        return device_array.cpu().numpy()

    def batch_h2d(self, host_arrays: Sequence[np.ndarray], *,
                  op_class: str = "batch_h2d") -> list[torch.Tensor]:
        """§8 rule 1: batch small crossings into one staged crossing.

        With batching enabled, N small arrays are packed into one staging
        buffer and pay ONE toll; without, each pays its own.
        """
        if not host_arrays:
            return []
        if not self.defaults.batch_small_crossings:
            # unbatched baseline still follows the staging discipline:
            # repeated (shape, dtype) buffers reuse registered staging
            # rather than paying FRESH per array per call, so comparing
            # against the batched path measures *batching*, not staging abuse
            return [self.h2d(a, op_class=op_class, reuse_staging=True)
                    for a in host_arrays]
        total = sum(_nbytes(a) for a in host_arrays)
        if self.arena is not None:
            staging, tag = self.arena.acquire(total)
            tags: tuple[str, ...] = (tag,)
        else:
            staging, tags = StagingKind.REGISTERED, ()
        crossing = Crossing(total, Direction.H2D, staging)
        cost = self.bridge.crossing_time(crossing, n_contexts=self.pool.n_workers)
        # one fused ciphertext: any constituent MAC reject re-pays the batch
        cost = self._faulted_cost(op_class, crossing, cost,
                                  n_units=len(host_arrays))
        end = self.clock.advance(cost)
        self._record(crossing, cost, op_class, t_end=end, tags=tags)
        self.stats.batched_crossings_saved += len(host_arrays) - 1
        return [_to_device(np.asarray(a), self.device) for a in host_arrays]

    def bulk_h2d_pooled(self, host_arrays: Sequence[np.ndarray], *,
                        op_class: str = "bulk_h2d", tags: tuple = (),
                        raw_bytes: Optional[Sequence[int]] = None,
                        codec: str = "") -> list[torch.Tensor]:
        """Bulk movement over the context pool (loader / KV restore path).

        ``raw_bytes`` (parallel to ``host_arrays``) marks quantized payloads:
        the arrays already hold *wire* bytes — the pool prices what crosses —
        while each record additionally carries the full-width byte count and
        codec id for the un-quantize replay counterfactual (DESIGN.md §13).
        """
        self.pool.ensure_ready()
        out = []
        before = self.clock.now
        for i, a in enumerate(host_arrays):
            crossing = Crossing(_nbytes(a), Direction.H2D, StagingKind.REGISTERED)
            ctx_id, start, done = self.pool.submit_ex(crossing)
            raw_i = raw_bytes[i] if raw_bytes else 0
            # per-crossing record carries its single-channel duration; the
            # wall-clock charge comes from the drain below
            self._record(crossing, done - start, op_class, charge=False,
                         channel=ctx_id, t_end=done, tags=tags,
                         raw_bytes=raw_i, codec=codec if raw_i else "")
            out.append(_to_device(np.asarray(a), self.device))
        self.pool.drain()
        self.stats.bridge_time_s += self.clock.now - before
        return out

    def pooled_crossing(self, crossing: Crossing, *, op_class: str,
                        tags: tuple = (), sources: tuple = (),
                        raw_bytes: int = 0,
                        codec: str = "") -> tuple[int, float, float]:
        """Submit one crossing to the channel pool, recorded *uncharged*.

        Returns ``(ctx_id, start, done)``.  The caller owns the
        critical-path charge — the pipelined KV restore uses this to block
        only for its pipeline fill while later chunks overlap engine work,
        and the worker-composed coalescer flushes its D2H queue here so the
        drain serializes on a worker channel instead of the engine clock.
        """
        ctx_id, start, done = self.pool.submit_ex(crossing)
        self._record(crossing, done - start, op_class, charge=False,
                     channel=ctx_id, t_end=done, tags=tags, sources=sources,
                     raw_bytes=raw_bytes, codec=codec)
        return ctx_id, start, done

    def charge_crossing(self, nbytes: int, direction: Direction, *,
                        staging: StagingKind = StagingKind.REGISTERED,
                        op_class: str, tags: tuple = (),
                        sources: tuple = (), raw_bytes: int = 0,
                        codec: str = "") -> float:
        """Price + record a metadata-only crossing (no tensor moves).

        Call sites that account a crossing without materializing its payload
        (the offload manager's metadata-only spill, the loader's modeled
        shard transfers, the coalescer's fused flushes) use this instead of
        hand-rolling stats so the crossing still lands in the tape with a
        consistent interval.
        """
        crossing = Crossing(int(nbytes), direction, staging)
        cost = self.bridge.crossing_time(crossing, n_contexts=self.pool.n_workers)
        # a coalesced flush is one ciphertext over len(sources) constituents
        cost = self._faulted_cost(op_class, crossing, cost,
                                  n_units=max(1, len(sources)))
        end = self.clock.advance(cost)
        self._record(crossing, cost, op_class, t_end=end, tags=tags,
                     sources=sources, raw_bytes=raw_bytes, codec=codec)
        return cost

    def record_modeled(self, nbytes: int, direction: Direction, cost: float, *,
                       op_class: str,
                       staging: StagingKind = StagingKind.REGISTERED,
                       tags: tuple = (), raw_bytes: int = 0,
                       codec: str = "") -> None:
        """Record a crossing whose cost an external model already computed.

        The pooled loader prices its ladder variants with its own calibrated
        component model (§6.1); this lets it charge that exact cost while the
        crossing still lands on the tape with direction/staging/bytes.  The
        charge always advances the clock — that is what keeps consecutive
        modeled crossings on non-overlapping intervals (L1/L2).
        """
        crossing = Crossing(int(nbytes), direction, staging)
        end = self.clock.advance(cost)
        self._record(crossing, cost, op_class, t_end=end, tags=tags,
                     raw_bytes=raw_bytes, codec=codec)

    # -- device-local compute ----------------------------------------------------------

    def charge_compute(self, seconds: float, *, op_class: str,
                       tags: tuple = (), bound: str = "") -> float:
        """Charge device-local compute (prefill/decode forward) to the clock.

        Compute is a first-class interval on the engine's virtual clock —
        without it the coalescer's deadline trigger never comes due and every
        overlap window is fictional.  The charge is NOT a crossing: nothing
        moves over the bridge, so it lands on the tape as a ``kind="compute"``
        record (direction/staging empty, channel -1 — the engine-serial path)
        and is counted in ``stats.compute_time_s``, never ``bridge_time_s``.
        Pricing belongs to the caller (core.compute.ComputeModel); so does
        ``bound`` ("compute"/"memory": which roofline term won — replay uses
        it to pick the matching CC parity factor when repricing).
        """
        if seconds < 0:
            raise ValueError(f"cannot charge negative compute {seconds}")
        end = self.clock.advance(seconds)
        self.stats.compute_charges += 1
        self.stats.compute_time_s += seconds
        rec = CopyRecord(
            op_class, 0, seconds, self.bridge.cc_on,
            direction="", staging="", channel=-1,
            t_start=end - seconds, t_end=end, charged=True,
            tags=tuple(tags), kind="compute", bound=bound)
        self.records.append(rec)
        for hook in self.on_record:
            hook(rec)
        return seconds

    # -- in-tenant fabric P2P (DESIGN.md §12) --------------------------------------------

    def p2p(self, nbytes: int, *, op_class: str, tags: tuple = (),
            extra_s: float = 0.0) -> float:
        """Charge an in-tenant fabric-P2P transfer (never the bridge).

        P2P is the one data path CC does not serialize: no host staging, no
        per-channel queueing, no toll floors — just bytes over the tenant
        fabric at ``fabric.p2p_bandwidth``.  The charge still advances the
        engine's virtual clock (a TP allreduce is on the step critical path)
        but lands on the tape as a ``kind="p2p"`` record on channel -1 with
        empty staging, counted in ``stats.p2p_*`` — never in
        ``bridge_time_s`` or the h2d/d2h crossing stats.

        The fabric decision is re-evaluated per call: a tenant whose
        partition went STALE or whose attestation evidence lapsed is priced
        at the CC-compatible TCP fallback rate and tagged FABRIC_FALLBACK,
        so degradation shows up in the tape as a pricing step, not a hidden
        slowdown.

        ``extra_s`` adds straggler time on top of the bandwidth term — the
        per-device clock-skew spread a ring collective waits out
        (``ComputeModel.allreduce_skew_s``).  Zero by default, so skew-free
        tapes (all goldens) are byte-identical to before.
        """
        from .fabric import FabricTransport, p2p_bandwidth
        if nbytes < 0:
            raise ValueError(f"cannot move negative bytes {nbytes}")
        if extra_s < 0:
            raise ValueError(f"cannot add negative straggler time {extra_s}")
        transport = self.fabric or FabricTransport(self.bridge.profile)
        up = transport.fabric_up()
        bw = p2p_bandwidth(self.bridge.profile, fabric_up=up)
        cost = (nbytes / bw if nbytes else 0.0) + extra_s
        if not up:
            tags = tuple(tags) + ("fabric_fallback",)
            self.stats.p2p_fallback_crossings += 1
        end = self.clock.advance(cost)
        self.stats.p2p_crossings += 1
        self.stats.p2p_bytes += int(nbytes)
        self.stats.p2p_time_s += cost
        rec = CopyRecord(
            op_class, int(nbytes), cost, self.bridge.cc_on,
            direction=Direction.P2P.value, staging="", channel=P2P_CHANNEL,
            t_start=end - cost, t_end=end, charged=True,
            tags=tuple(tags), kind="p2p")
        self.records.append(rec)
        for hook in self.on_record:
            hook(rec)
        return cost

    # -- bookkeeping -------------------------------------------------------------------

    def _record(self, crossing: Crossing, cost: float, op_class: str, *,
                charge: bool = True, channel: int = -1,
                t_end: Optional[float] = None, tags: tuple = (),
                sources: tuple = (), raw_bytes: int = 0,
                codec: str = "") -> None:
        """`charge=False` keeps the per-crossing duration in the records (for
        op-class attribution) without adding it to bridge_time_s — used when
        the wall-clock charge is accounted elsewhere (pooled drain).

        `channel` is the secure-context id the crossing serialized on (-1 for
        the engine-serial path); `t_end` overrides the completion timestamp
        for pool-scheduled crossings whose interval the pool computed.
        """
        if crossing.direction is Direction.H2D:
            self.stats.h2d_crossings += 1
            self.stats.h2d_bytes += crossing.nbytes
        else:
            self.stats.d2h_crossings += 1
            self.stats.d2h_bytes += crossing.nbytes
        if charge:
            self.stats.bridge_time_s += cost
        end = self.clock.now if t_end is None else t_end
        rec = CopyRecord(
            op_class, crossing.nbytes, cost, self.bridge.cc_on,
            direction=crossing.direction.value, staging=crossing.staging.value,
            channel=channel, t_start=end - cost, t_end=end, charged=charge,
            tags=tuple(tags), sources=tuple(sources),
            raw_bytes=int(raw_bytes), codec=codec)
        self.records.append(rec)
        for hook in self.on_record:
            hook(rec)
