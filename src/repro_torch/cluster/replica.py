"""One serving replica: engine + scheduler + gateway + offload on a fabric
tenant partition.

A replica is the unit the cluster schedules.  It owns

  * a fabric `Tenant` (its partition of the 1/2/4/8 vocabulary, §7.1) — the
    devices it may see, with in-tenant P2P the bridge law never touches,
  * a `ContextLease` from the cluster-wide `SecureContextBudget` — its share
    of the system-wide secure copy channels (§4 L4), sizing its gateway's
    channel pool and therefore its bridge bandwidth,
  * the full single-node serving stack: `ServingEngine` + `Scheduler` behind
    one `TransferGateway`, an `OffloadManager` for reuse-aware KV spill
    (§6.2), and a `PagePool` tracking resident prompt blocks by content hash.

Every crossing is priced on the replica's own virtual clock; replicas run on
disjoint devices, so cluster makespan is the max over replica clocks.  The
page pool and host store export content-hash inventories that the router's
prefix-affinity policy consumes; prompt admission restores warm prefixes from
the host store (bulk, pooled) and charges prefill compute only for the cold
tail — the cluster-level form of the §6.2 warm-TTFT recovery.

PyTorch counterpart of ``repro.cluster.replica``.  The replica runs where
its model lies: its gateway uploads there, its engine serves there and its
bookkeeping ``PagePool`` is allocated there.  Replicas of one cluster share
one model (the reference's share the model object too; each of its engines
draws its own weights from its seed, where the port's model owns them).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.bridge_opt import StagingArena
from repro_torch.core.bridge import (BridgeModel, Crossing, Direction,
                                     StagingKind)
from repro_torch.obs import Observatory
from repro_torch.core.channels import VirtualClock
from repro_torch.core.compute import ComputeModel
from repro_torch.core.fabric import FabricTransport, Tenant
from repro_torch.core.gateway import TransferGateway
from repro_torch.core.policy import cc_aware_defaults
from repro_torch.resilience import FaultInjector, FaultPlan
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.kv_cache import PagePool
from repro_torch.serving.offload import OffloadManager
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
from repro_torch.trace import opclasses as oc
from repro_torch.trace.recorder import TraceRecorder
from repro_torch.trace.tape import BridgeTape

from .budget import (COALESCER_FLUSH_BYTES, BudgetExhausted, ContextLease,
                     PinnedLease, replica_pinned_bytes)

MS = 1e-3


def prompt_blocks(prompt: list, block_tokens: int) -> list[tuple]:
    """Full `block_tokens`-sized token blocks of a prompt (tail excluded) —
    the content units prefix caching, offload evidence, and routing share."""
    n_full = len(prompt) // block_tokens
    return [tuple(prompt[i * block_tokens:(i + 1) * block_tokens])
            for i in range(n_full)]


def prompt_prefix_hashes(prompt: list, block_tokens: int) -> list[int]:
    """Content hashes of a prompt's full prefix blocks (routing key)."""
    return [hash(b) for b in prompt_blocks(prompt, block_tokens)]


@dataclass
class ReplicaConfig:
    max_batch: int = 4
    max_len: int = 96
    #: secure contexts the replica would like (the budget may grant fewer)
    contexts_requested: int = 8
    #: tensor-parallel degree (DESIGN.md §12): the replica's model shards
    #: across this many of its tenant's devices — must fit the partition
    #: (tp_degree <= partition size).  Per-step allreduces and shard
    #: exchanges ride the tenant fabric as kind="p2p" records; only CVM
    #: ingress pays the bridge toll.  1 = the classic single-device replica.
    tp_degree: int = 1
    #: reuse-evidence threshold for the offload policy (§6.2)
    store_threshold: int = 2
    #: tokens per prefix block (page size of the bookkeeping pool)
    block_tokens: int = 8
    #: bookkeeping page-pool capacity (pages)
    n_pages: int = 64
    #: modeled prefill compute per prompt token, charged to the virtual
    #: clock at admission (restored prefix tokens skip this charge)
    prefill_ms_per_token: float = 0.5
    #: KV payload bytes per token (prices spill/restore crossings)
    kv_bytes_per_token: int = 8192
    # ---- bridge_opt (DESIGN.md §6) ---------------------------------------
    #: pinned staging budget for the replica's arena (0 = legacy staging)
    staging_arena_bytes: int = 32 << 20
    #: chunk + double-buffer prefix restores across the leased channels
    pipelined_restore: bool = True
    #: restore chunk size (0 = two KV blocks per chunk)
    restore_chunk_bytes: int = 0
    #: fuse sub-threshold crossings (off by default: the engine's sync
    #: batching already covers the per-step prep; opt in per deployment)
    coalesce_small_crossings: bool = False
    # ---- quantized crossings (DESIGN.md §13) -----------------------------
    #: KV codec for spill/restore crossings ("" = full-width bf16 payloads)
    kv_quant: str = ""
    #: max per-block relative round-trip error a codec may exhibit; spawn
    #: fails (AccuracyBudgetError) if the named codec measures worse
    accuracy_budget: float = 0.05

    @property
    def block_bytes(self) -> int:
        return self.block_tokens * self.kv_bytes_per_token

    @property
    def effective_restore_chunk_bytes(self) -> int:
        return self.restore_chunk_bytes or 2 * self.block_bytes

    def pinned_bytes(self, n_contexts: int) -> int:
        """Pinned host bytes this replica needs leased: arena slabs plus the
        channel pool's per-context slots plus the coalescer flush buffer."""
        return replica_pinned_bytes(
            self.staging_arena_bytes, n_contexts,
            COALESCER_FLUSH_BYTES if self.coalesce_small_crossings else 0)


@dataclass
class ReplicaMetrics:
    """What the autoscaler reads: virtual-clock delay + crossing accounting."""

    replica_id: str
    queued: int
    active: int
    queue_delay_s: float
    virtual_time_s: float
    bridge_time_s: float
    op_class_seconds: dict[str, float] = field(default_factory=dict)
    #: staging-arena hit rate (1.0 when no arena: nothing is missing)
    arena_hit_rate: float = 1.0
    # ---- slot-masked decode / overlap economics (DESIGN.md §8) -----------
    #: slot-steps deferred by slot-masked decode (restoring slots that sat
    #: a step out while the rest of the batch kept decoding)
    deferred_slots: int = 0
    #: restore barriers that found the pipeline already drained — the
    #: restore window was filled with useful decode work
    barrier_noops: int = 0
    #: barrier_noops / (barrier_noops + barrier_waits): the router's
    #: overlap-aware routing signal (1.0 when no barriers resolved yet —
    #: an untested replica is neutral, not maximally cold)
    overlap_noop_share: float = 1.0
    #: same signal over the last DEFAULT_BARRIER_WINDOW barriers only —
    #: *current* warmth rather than lifetime history (a replica warm an
    #: hour of virtual time ago no longer looks warm); same neutral 1.0
    #: before any barrier enters the window
    overlap_noop_share_windowed: float = 1.0


class Replica:
    #: router-visible health states (DESIGN.md §11)
    HEALTHY = "healthy"
    QUARANTINED = "quarantined"

    def __init__(self, replica_id: str, model, tenant: Tenant,
                 lease: ContextLease, bridge: BridgeModel,
                 cfg: Optional[ReplicaConfig] = None, *, seed: int = 0,
                 pinned_lease: Optional[PinnedLease] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 tenant_manager=None,
                 context_budget=None, pinned_budget=None):
        self.replica_id = replica_id
        self.tenant = tenant
        self.lease = lease
        #: claim on the host-wide pinned pool covering this replica's arena
        #: (None = legacy: the operator declared no host pinned budget)
        self.pinned_lease = pinned_lease
        self.bridge = bridge
        self.cfg = cfg or ReplicaConfig()
        if lease.n_contexts < 1:
            # a 0-context lease means the L4 budget granted nothing: spawn
            # must fail on the budget path, not silently run a one-worker
            # pool the budget never paid for (the old max(1, ...) clamp)
            raise BudgetExhausted(
                f"replica {replica_id}: lease for {lease.holder!r} granted "
                f"{lease.n_contexts} secure contexts; a replica needs at "
                f"least one")
        if self.cfg.tp_degree > tenant.partition.size:
            raise ValueError(
                f"replica {replica_id}: tp_degree={self.cfg.tp_degree} does "
                f"not fit tenant {tenant.tenant_id!r}'s "
                f"{tenant.partition.size}-device partition")
        if pinned_lease is not None:
            # the lease must cover everything the replica pins, not just the
            # arena: each leased secure context owns a pinned staging slot,
            # and the coalescer's flush buffer is pinned too (§4 L4 — the
            # host pool is one commodity; slots unaccounted for here would
            # be pinned bytes the fleet planner never saw)
            need = self.cfg.pinned_bytes(lease.n_contexts)
            if pinned_lease.nbytes < need:
                raise ValueError(
                    f"pinned lease {pinned_lease.nbytes} B cannot cover the "
                    f"replica's pinned footprint {need} B (arena "
                    f"{self.cfg.staging_arena_bytes} B + "
                    f"{lease.n_contexts} channel slots"
                    f"{' + coalescer flush buffer' if self.cfg.coalesce_small_crossings else ''})")
        self.clock = VirtualClock()
        defaults = dataclasses.replace(
            cc_aware_defaults(bridge.cc_on, concurrency=self.cfg.max_batch),
            staging_arena_bytes=self.cfg.staging_arena_bytes,
            pipelined_restore=self.cfg.pipelined_restore,
            coalesce_small_crossings=self.cfg.coalesce_small_crossings,
            kv_quant=self.cfg.kv_quant,
            accuracy_budget=self.cfg.accuracy_budget)
        self.arena = (StagingArena(self.cfg.staging_arena_bytes)
                      if self.cfg.staging_arena_bytes else None)
        #: where the replica runs: its model's device
        self.device = model.device
        self.gateway = TransferGateway(
            bridge, defaults, clock=self.clock,
            pool_workers=lease.n_contexts, device=self.device,
            arena=self.arena)
        # in-tenant fabric transport (DESIGN.md §12): p2p crossings consult
        # the tenant's fabric-manager health and this replica's attestation
        # standing per crossing — lapsed evidence reprices the same bytes at
        # the TCP fallback rate, tape-visibly (the "fabric_fallback" tag)
        self.gateway.fabric = FabricTransport(
            bridge.profile, tenant, attested=lambda: self.attested)
        # §6.1 discipline: pay channel-pool creation at provisioning, next to
        # the tenant's 10-20 s fmpm activation, never on the serving path —
        # and pin the staging classes serving will touch (prompt/prep/KV)
        self.prewarm_seconds = self.gateway.pool.prewarm()
        if self.arena is not None:
            self.arena.prewarm([64, 128, 256, self.cfg.block_bytes,
                                self.cfg.effective_restore_chunk_bytes])
        # every replica records its crossing stream: the cluster's evidence
        # for routing/autoscaling decisions is the same tape the replayer
        # and conformance checker consume
        self.recorder = TraceRecorder(
            self.gateway, policy=defaults.scheduling.value,
            label=f"replica-{replica_id}",
            extra={"tenant": tenant.tenant_id,
                   "leased_contexts": lease.n_contexts}).attach()
        #: replica-labeled observatory: every metric/span it emits carries
        #: (replica, tenant) labels so cluster-merged snapshots stay
        #: attributable.  None when observability is off (REPRO_OBS=0).
        self.obs: Optional[Observatory] = (
            Observatory(replica=replica_id, tenant=tenant.tenant_id)
            if defaults.observability else None)
        # TP-aware step pricing: per-device FLOPs/HBM divide by tp_degree
        # and the engine charges the ring allreduce as p2p_allreduce records
        # through this replica's fabric transport (TP=1 is the classic model)
        compute_model = (ComputeModel(model.cfg, bridge,
                                      tp_degree=self.cfg.tp_degree)
                         if defaults.charge_compute else None)
        self.engine = ServingEngine(
            model, max_batch=self.cfg.max_batch, max_len=self.cfg.max_len,
            gateway=self.gateway, policy=defaults.scheduling, bridge=bridge,
            defaults=defaults, seed=seed, obs=self.obs,
            compute_model=compute_model, device=self.device)
        self.scheduler = Scheduler(self.engine, SchedulerConfig())
        self.offload = OffloadManager(
            self.gateway, defaults.offload,
            store_threshold=max(1, self.cfg.store_threshold
                                or defaults.store_threshold),
            block_bytes=self.cfg.block_bytes,
            coalescer=self.engine.coalescer,
            pipelined_restore=defaults.pipelined_restore,
            restore_chunk_bytes=self.cfg.effective_restore_chunk_bytes,
            obs=self.obs,
            kv_quant=defaults.kv_quant,
            accuracy_budget=defaults.accuracy_budget,
            compute_model=compute_model)
        # restore completions flow to the engine's slot-granular read sets
        # (OverlapScheduler) through the offload layer's own callback — the
        # admission path no longer hand-plumbs done_t per call site
        self.offload.on_restore_done.append(self.engine.mark_restore)
        self.pages = PagePool(
            n_pages=self.cfg.n_pages, page_size=self.cfg.block_tokens,
            n_kv_heads=1, head_dim=1, n_layers=1, device=self.device)
        self._tables: dict[str, list[int]] = {}
        self._hashes: dict[str, list[int]] = {}
        self._reaped = 0
        self.warm_blocks_restored = 0
        self.untracked_requests = 0
        # ---- resilience (DESIGN.md §11) ----------------------------------
        #: router-visible health: only HEALTHY + attested replicas are
        #: eligible for new placements; quarantined replicas keep serving
        #: what they already hold (no request is ever stranded by a state
        #: flip — failover explicitly drains instead)
        self.health = self.HEALTHY
        self.health_reason = ""
        #: attestation standing; provisioning already gated on it, so a
        #: fresh replica starts attested with the TTL window opening now
        self.attested = True
        self.attested_at = self.clock.now
        self.reattests = 0
        self.quarantines = 0
        #: control plane that re-verifies expired attestation (optional)
        self.tenant_manager = tenant_manager
        #: budgets to return this replica's leases to at close(); the router
        #: also releases (release is idempotent) — belt and braces so a
        #: replica closed outside a router still frees fleet resources
        self.context_budget = context_budget
        self.pinned_budget = pinned_budget
        self.closed = False
        #: seeded fault injection: hooks the gateway's charged submit paths
        #: (None / empty plan = fault-free fast path, golden tapes unchanged)
        self.faults: Optional[FaultInjector] = None
        if fault_plan is not None and fault_plan.any_faults():
            self.faults = FaultInjector(fault_plan).attach(self.gateway)

    # -- admission -------------------------------------------------------------------

    def submit(self, req: Request,
               prefix_hashes: Optional[list[int]] = None) -> bool:
        """Admit a request: restore its warm prefix from the host store,
        charge cold prefill compute, and register its blocks in the pool.

        `prefix_hashes` lets the router pass the hashes it already computed
        for placement; recomputed here otherwise.
        """
        # shed before charging: a rejected request must not touch the clock,
        # the reuse evidence, or the restore stats
        if len(self.engine.queue) >= self.scheduler.cfg.max_queue:
            self.scheduler.rejected += 1
            return False
        t0 = self.clock.now
        blocks = prompt_blocks(req.prompt, self.cfg.block_tokens)
        hashes = (prefix_hashes if prefix_hashes is not None
                  else [hash(b) for b in blocks])
        for h in hashes:
            self.offload.observe(h)
        warm = [h for h in hashes if h in self.offload.host_store]
        if warm:
            # keyed restore: the offload layer notifies the engine's restore
            # barrier itself (on_restore_done -> mark_restore).  Pipelined
            # restores land after clock.now: the engine barriers before the
            # request's first KV read, and — overlap preference on — fills
            # the drain window with other decode work; slot-masked decode
            # keeps the rest of the batch stepping if the request is already
            # resident when a later restore lands.
            hits, _ = self.offload.restore(warm, key=req.request_id)
            self.warm_blocks_restored += hits
        warm_tokens = len(warm) * self.cfg.block_tokens
        cold_tokens = max(0, len(req.prompt) - warm_tokens)
        if cold_tokens:
            # the replica owns admission-time prompt pricing (its coarse
            # per-token model); tape-visible as a compute record so replay
            # attribution sees the full admission anatomy
            self.gateway.charge_compute(
                cold_tokens * self.cfg.prefill_ms_per_token * MS,
                op_class=oc.PREFILL_COMPUTE)
        # the engine charges compute only for tokens not priced here
        req.warm_tokens = len(req.prompt)
        self.scheduler.submit(req)
        # TTFT window starts at arrival, before the admission-path charges
        req.enqueue_t = t0
        if self.obs is not None:
            # the engine's submit stamped the span with post-admission time;
            # re-stamp with the true arrival (on_enqueue is last-wins) so
            # span TTFT/queue-wait match the request fields above
            self.obs.spans.on_enqueue(req.request_id, t0)
        self._track_pages(req, blocks, hashes)
        return True

    def _track_pages(self, req: Request, blocks: list[tuple],
                     hashes: list[int]) -> None:
        table = self.pages.allocate(req.request_id, len(req.prompt),
                                    token_blocks=blocks)
        if table is None:
            # pool exhausted: newest requests yield pages first (LIFO);
            # victims lose their page tracking and will serve untracked
            victims = self.scheduler.preempt_for_pool(
                self.pages, len(req.prompt), self._tables)
            for v in victims:
                self._hashes.pop(v, None)
                self.untracked_requests += 1
            table = self.pages.allocate(req.request_id, len(req.prompt),
                                        token_blocks=blocks)
        if table is not None:
            self._tables[req.request_id] = table
            self._hashes[req.request_id] = hashes
        else:
            # request serves without page bookkeeping: invisible to
            # prefix-affinity and reuse evidence — count, don't hide it
            self.untracked_requests += 1

    # -- serving loop ----------------------------------------------------------------

    def tick(self) -> int:
        self._check_attestation()
        stepped = self.scheduler.tick()
        self._reap()
        return stepped

    # -- resilience: health + attestation (DESIGN.md §11) ------------------------------

    def routable(self) -> bool:
        """Eligible for NEW placements (the router's health gate)."""
        return self.health == self.HEALTHY and self.attested

    def quarantine(self, reason: str) -> None:
        """Mark the replica ineligible for new placements.

        In-flight and queued work keeps serving — quarantine gates routing,
        not execution, so a state flip can never hang a request.  Expired
        attestation additionally drops ``attested`` until re-verification.
        """
        if self.health != self.QUARANTINED:
            self.quarantines += 1
        self.health = self.QUARANTINED
        self.health_reason = reason
        if reason == "attestation_expired":
            self.attested = False

    def mark_healthy(self) -> None:
        """Operator/router recovery: re-admit the replica for placements."""
        self.health = self.HEALTHY
        self.health_reason = ""

    def _check_attestation(self) -> None:
        """Attestation TTL: expire -> quarantine -> re-attest -> healthy.

        The re-attestation round trip is charged on the serving clock as a
        tape-visible ``reattest`` record (the FaultInjector's emission), so
        the toll shows up in stall attribution rather than vanishing into
        control-plane accounting.  It only moves the clock — token streams
        are unchanged, which keeps the chaos byte-identity invariant.
        """
        if self.faults is None:
            return
        if (self.health == self.HEALTHY
                and self.faults.reattest_due(self.clock.now, self.attested_at)):
            self.quarantine("attestation_expired")
        if (self.health == self.QUARANTINED
                and self.health_reason == "attestation_expired"):
            self.faults.charge_reattest()
            ok = True
            if self.tenant_manager is not None:
                ok = bool(self.tenant_manager.reattest(self.tenant)["ok"])
            if ok:
                self.attested = True
                self.attested_at = self.clock.now
                self.reattests += 1
                self.mark_healthy()

    def drain_requests(self) -> list[Request]:
        """Failover: hand every queued + active request back to the caller.

        Active requests go through the engine's preemption path (slot
        freed, outputs cleared); the target replica re-runs prefill and
        re-decodes greedily, so a moved request's *final* tokens match what
        it would have produced here.  Source-side page tables and pending
        restore completions are released — nothing leaks for a request that
        left.
        """
        for slot in sorted(self.engine.active):
            self.engine._release(self.engine.active[slot], state="queued")
        drained = list(self.engine.queue)
        self.engine.queue.clear()
        for req in drained:
            table = self._tables.pop(req.request_id, None)
            if table is not None:
                self.pages.release(table)
            self._hashes.pop(req.request_id, None)
            self.engine.overlap.pending.pop(req.request_id, None)
            req.slot = -1
            req.index = 0
            req.first_token_t = None
            req.warm_tokens = 0
            req.state = "queued"
        return drained

    def _reap(self) -> None:
        """Release finished requests' pages and evict their blocks through
        the reuse-aware offload policy (the §6.2 churn path)."""
        done = self.engine.finished
        for req in done[self._reaped:]:
            table = self._tables.pop(req.request_id, None)
            hashes = self._hashes.pop(req.request_id, [])
            if table is not None:
                self.pages.release(table)
            for h in hashes:
                self.offload.evict(h, payload_bytes=self.cfg.block_bytes)
        self._reaped = len(done)

    def pending(self) -> int:
        return len(self.engine.queue) + len(self.engine.active)

    def close(self) -> None:
        """Release everything this replica holds from shared pools.

        Idempotent.  Besides detaching the recorder and closing the engine,
        this returns the page tables still tracked for live requests and
        hands the context/pinned leases back to their budgets (when the
        budgets were provided at spawn) — a spawn/close loop must leave the
        fleet budgets at their initial high-water marks, or replacement
        spawns eventually starve (the §4 L4 leak).
        """
        if self.closed:
            return
        self.closed = True
        self.recorder.detach()
        self.engine.close()
        for table in self._tables.values():
            self.pages.release(table)
        self._tables.clear()
        self._hashes.clear()
        if self.context_budget is not None:
            self.context_budget.release(self.lease.holder)
        if self.pinned_budget is not None and self.pinned_lease is not None:
            self.pinned_budget.release(self.pinned_lease.holder)
        # leak audit: after release, neither budget may still show a lease
        # under this replica's holders — a stale entry is exactly the §4 L4
        # leak that starves replacement spawns, so it fails loudly here
        if self.context_budget is not None \
                and self.lease.holder in self.context_budget.leases():
            raise RuntimeError(
                f"replica {self.replica_id}: context lease "
                f"{self.lease.holder!r} still held after close()")
        if self.pinned_budget is not None and self.pinned_lease is not None \
                and self.pinned_lease.holder in self.pinned_budget.leases():
            raise RuntimeError(
                f"replica {self.replica_id}: pinned lease "
                f"{self.pinned_lease.holder!r} still held after close()")

    def tape(self) -> BridgeTape:
        """This replica's crossing trace (replayable, conformance-checkable)."""
        return self.recorder.tape()

    # -- exports the cluster consumes -------------------------------------------------

    def kv_inventory(self) -> set[int]:
        """Content hashes this replica can serve warm: resident pages plus
        the offload host store (the router's prefix-affinity key)."""
        return self.pages.inventory() | self.offload.inventory()

    def bridge_block_cost(self) -> float:
        """Modeled cost of moving one KV block over this replica's leased
        channels — the bridge-cost weight in least-loaded routing."""
        return self.bridge.crossing_time(
            Crossing(self.cfg.block_bytes, Direction.H2D,
                     StagingKind.REGISTERED),
            n_contexts=self.gateway.pool.n_workers)

    def load_score(self) -> float:
        """Bridge-cost-aware load: pending work weighted by what one unit of
        it costs here (replicas with smaller leases look more loaded)."""
        per_req = (self.cfg.prefill_ms_per_token * MS * self.cfg.block_tokens
                   + self.bridge_block_cost())
        return self.pending() * per_req

    def queue_delay_s(self) -> float:
        waits = [self.clock.now - r.enqueue_t for r in self.engine.queue]
        return float(np.mean(waits)) if waits else 0.0

    def overlap_noop_share(self) -> float:
        """Fraction of resolved restore barriers that were no-ops — the
        restore windows this replica already fills with decode work.  The
        router's overlap-aware preference reads this (high share = adding a
        restored request here is likely free).  1.0 when no barriers have
        resolved yet: an untested replica is not penalized."""
        ov = self.engine.overlap.stats
        resolved = ov.barrier_noops + ov.barrier_waits
        if resolved == 0:
            return 1.0
        return ov.barrier_noops / resolved

    def overlap_noop_share_windowed(self) -> float:
        """`overlap_noop_share` over the scheduler's recent-barrier window
        only (last DEFAULT_BARRIER_WINDOW outcomes) — the *current* warmth
        signal routers should prefer: a replica that stopped hiding restore
        drains shows up within ~one wave of requests instead of being
        flattered by lifetime history.  Neutral 1.0 while the window is
        empty, matching the lifetime share's untested-replica semantics."""
        overlap = self.engine.overlap
        if not overlap.recent_barriers:
            return 1.0
        return overlap.windowed_noop_share()

    def metrics(self) -> ReplicaMetrics:
        per_op = self.tape().op_class_seconds()
        ov = self.engine.overlap.stats
        if self.obs is not None:
            # raw + windowed noop shares as gauges: snapshot-time values in
            # the same registry the crossing counters live in, so a merged
            # cluster snapshot carries the routing signal per replica
            self.obs.registry.gauge("replica/overlap_noop_share").set(
                self.overlap_noop_share())
            self.obs.registry.gauge(
                "replica/overlap_noop_share_windowed").set(
                    self.overlap_noop_share_windowed())
        return ReplicaMetrics(
            replica_id=self.replica_id,
            queued=len(self.engine.queue),
            active=len(self.engine.active),
            queue_delay_s=self.queue_delay_s(),
            virtual_time_s=self.clock.now,
            bridge_time_s=self.gateway.stats.bridge_time_s,
            op_class_seconds=per_op,
            arena_hit_rate=(self.arena.stats.hit_rate
                            if self.arena is not None else 1.0),
            deferred_slots=ov.deferred_slots,
            barrier_noops=ov.barrier_noops,
            overlap_noop_share=self.overlap_noop_share(),
            overlap_noop_share_windowed=self.overlap_noop_share_windowed(),
        )

    def stats(self) -> dict:
        s = self.engine.stats()
        s.update(
            replica_id=self.replica_id,
            tenant_id=self.tenant.tenant_id,
            devices=self.tenant.visible_devices(),
            leased_contexts=self.lease.n_contexts,
            tp_degree=self.cfg.tp_degree,
            p2p_bytes=self.gateway.stats.p2p_bytes,
            p2p_fallback_crossings=self.gateway.stats.p2p_fallback_crossings,
            preemptions=self.scheduler.preemptions,
            warm_blocks_restored=self.warm_blocks_restored,
            untracked_requests=self.untracked_requests,
            # resilience (DESIGN.md §11)
            health=self.health,
            attested=self.attested,
            reattests=self.reattests,
            quarantines=self.quarantines,
            faults=(self.faults.stats.snapshot()
                    if self.faults is not None else None),
            offload=self.offload.stats,
            # staging economics: the cluster-level inventory of what the
            # persistent arena bought this replica (bridge_opt)
            arena=(self.arena.stats_dict() if self.arena is not None else None),
            # unified telemetry (DESIGN.md §9): metric rows + request spans,
            # labeled (replica, tenant); None when REPRO_OBS=0
            obs=(self.obs.snapshot() if self.obs is not None else None),
        )
        return s
