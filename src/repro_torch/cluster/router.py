"""Cluster front end: admission control + prefix-affinity routing.

The router is the fleet-level form of §8 rule 1 ("treat bridge crossings as
a scheduled, scarce resource"): the most expensive crossing is the one a
different placement would have avoided entirely.  Routing policies:

  LEAST_LOADED     bridge-cost-aware least-loaded dispatch: pending work
                   weighted by each replica's per-block bridge cost (smaller
                   context leases => costlier blocks => higher load), ties
                   broken round-robin.
  PREFIX_AFFINITY  route a request to the replica whose KV/offload inventory
                   (content hashes exported by PagePool and OffloadManager,
                   §6.2) overlaps its prompt's prefix blocks; fall back to
                   least-loaded when nothing matches.  Keeps reuse evidence
                   concentrated, so warm prefixes restore instead of
                   recomputing — the cluster-level warm-TTFT lever.

Orthogonal to the policy, `prefer_overlap_filled` (off by default) breaks
load ties by each replica's barrier-noop share (`overlap_noop_share`,
exported from `engine.stats()["overlap"]`): a replica whose restore windows
are already being filled with decode work (high noop share) absorbs another
restore-heavy request nearly for free, while one paying idle barrier waits
will serialize it — the fleet-level face of the §5.5 overlap scheduler.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from repro_torch.core.bridge import TPU_V5E, BridgeModel, BridgeProfile
from repro_torch.obs import Observatory
from repro_torch.resilience import FaultPlan
from repro_torch.serving.engine import Request

from .budget import PinnedBudget, SecureContextBudget
from .replica import Replica, ReplicaConfig, prompt_prefix_hashes
from .tenant_manager import TenantManager


class RoutingPolicy(enum.Enum):
    LEAST_LOADED = "least_loaded"
    PREFIX_AFFINITY = "prefix_affinity"


class ClusterRouter:
    def __init__(self, replicas: list[Replica], *,
                 routing: RoutingPolicy = RoutingPolicy.PREFIX_AFFINITY,
                 max_cluster_queue: int = 4096,
                 tenant_manager: Optional[TenantManager] = None,
                 budget: Optional[SecureContextBudget] = None,
                 pinned_budget: Optional[PinnedBudget] = None,
                 prefer_overlap_filled: bool = False):
        if not replicas:
            raise ValueError("cluster needs at least one replica")
        self.replicas = replicas
        self.routing = routing
        self.max_cluster_queue = max_cluster_queue
        self.tenant_manager = tenant_manager
        self.budget = budget
        self.pinned_budget = pinned_budget
        #: overlap-aware preference: break load ties toward replicas whose
        #: restore windows are already being filled (high barrier-noop share)
        self.prefer_overlap_filled = prefer_overlap_filled
        self.block_tokens = replicas[0].cfg.block_tokens
        self.rejected = 0
        self.affinity_hits = 0
        #: per accepted request: {request, replica_id, affinity, warm_blocks}
        self.request_log: list[dict] = []
        self._rr = 0
        # ---- resilience (DESIGN.md §11) ----------------------------------
        #: fail_replica() invocations (drain-and-re-route failovers)
        self.failovers = 0
        #: drained requests re-placed on an eligible peer (KV re-restored
        #: there via the normal warm-admission path)
        self.failover_moved = 0
        #: drained requests with no eligible peer, requeued on the source —
        #: they serve after it recovers; a failover never loses a request
        self.failover_requeued = 0

    # -- admission + dispatch ---------------------------------------------------------

    def queue_depth(self) -> int:
        return sum(r.pending() for r in self.replicas)

    def _eligible(self) -> list[Replica]:
        """Replicas the health gate admits for NEW placements: healthy and
        attested.  Quarantined replicas keep serving what they hold but
        receive nothing new until they recover (DESIGN.md §11).  Replicas
        that export no health state (test doubles) count as eligible."""
        return [r for r in self.replicas
                if not callable(getattr(r, "routable", None)) or r.routable()]

    def submit(self, req: Request) -> Optional[Replica]:
        """Admit and place one request; None when the cluster sheds load."""
        if self.queue_depth() >= self.max_cluster_queue:
            self.rejected += 1
            return None
        hashes = prompt_prefix_hashes(req.prompt, self.block_tokens)
        replica, affinity, warm = self._route(hashes)
        if replica is None or not replica.submit(req, prefix_hashes=hashes):
            self.rejected += 1
            return None
        if affinity:
            self.affinity_hits += 1
        self.request_log.append({
            "request": req, "replica_id": replica.replica_id,
            "affinity": affinity, "warm_blocks": warm,
        })
        return replica

    def _route(self, prefix_hashes: list[int]
               ) -> tuple[Optional[Replica], bool, int]:
        """Returns (replica, affinity_hit, warm_blocks at the chosen one);
        (None, False, 0) when no replica is currently eligible."""
        candidates = self._eligible()
        if not candidates:
            return None, False, 0
        want = set(prefix_hashes)
        if self.routing is RoutingPolicy.PREFIX_AFFINITY and want:
            overlaps = [len(want & r.kv_inventory()) for r in candidates]
            best = max(overlaps)
            if best > 0:
                tied = [r for r, o in zip(candidates, overlaps) if o == best]
                # among equally-warm replicas, pick the least loaded
                return min(tied, key=lambda r: r.load_score()), True, best
        replica = self._least_loaded(candidates)
        warm = len(want & replica.kv_inventory()) if want else 0
        return replica, False, warm

    def _overlap_share(self, replica) -> float:
        """Barrier-noop share of a replica (1.0 when it exports none).

        Prefers the *windowed* share (last DEFAULT_BARRIER_WINDOW barrier
        outcomes) when the replica exports one: routing reacts to current
        warmth, not lifetime history — a replica that stopped hiding
        restore drains loses its preference within one window instead of
        coasting on an hour-old record.  Falls back to the lifetime share,
        then to a neutral 1.0.
        """
        windowed = getattr(replica, "overlap_noop_share_windowed", None)
        if callable(windowed):
            return float(windowed())
        share = getattr(replica, "overlap_noop_share", None)
        return float(share()) if callable(share) else 1.0

    def _least_loaded(self, candidates: Optional[list[Replica]] = None
                      ) -> Replica:
        pool = candidates if candidates is not None else self.replicas
        scores = [r.load_score() for r in pool]
        best = min(scores)
        tied = [r for r, s in zip(pool, scores) if s <= best + 1e-12]
        if self.prefer_overlap_filled and len(tied) > 1:
            # overlap-aware preference: equally-loaded replicas are NOT
            # equal if one is already hiding restore drains under decode
            # work — send the next request where the window is being filled
            shares = [self._overlap_share(r) for r in tied]
            top = max(shares)
            tied = [r for r, s in zip(tied, shares) if s >= top - 1e-12]
        pick = tied[self._rr % len(tied)]
        self._rr += 1
        return pick

    # -- failover (DESIGN.md §11) -----------------------------------------------------

    def _replica(self, replica_id: str) -> Replica:
        for r in self.replicas:
            if r.replica_id == replica_id:
                return r
        raise KeyError(f"no replica {replica_id!r} in this cluster")

    def fail_replica(self, replica_id: str, *,
                     reason: str = "failure") -> dict:
        """Quarantine a replica and drain-and-re-route its in-flight work.

        Every drained request is re-placed through the normal routing +
        admission path, so its warm prefix re-restores (KV re-restore on
        the target) and its prefill re-prices there.  A request no eligible
        peer will take is requeued on the source — it serves once the
        replica recovers.  Either way, zero requests are lost.
        """
        source = self._replica(replica_id)
        source.quarantine(reason)
        drained = source.drain_requests()
        moved = requeued = 0
        for req in drained:
            hashes = prompt_prefix_hashes(req.prompt, self.block_tokens)
            target, affinity, warm = self._route(hashes)
            if target is not None and target.submit(req, prefix_hashes=hashes):
                if affinity:
                    self.affinity_hits += 1
                # re-point the request's log entry at its new home (one
                # entry per request — ttfts() must not double-count movers)
                for entry in reversed(self.request_log):
                    if entry["request"] is req:
                        entry.update(replica_id=target.replica_id,
                                     affinity=affinity, warm_blocks=warm,
                                     failover_from=replica_id)
                        break
                moved += 1
            else:
                # engine-level requeue bypasses the scheduler's shed gate:
                # a failed-over request must never be dropped by its own
                # rescue path
                source.engine.submit(req)
                requeued += 1
        self.failovers += 1
        self.failover_moved += moved
        self.failover_requeued += requeued
        return {"replica_id": replica_id, "reason": reason,
                "drained": len(drained), "moved": moved,
                "requeued": requeued}

    def add_replica(self, replica: Replica) -> None:
        """Join a replacement replica (autoscaler spawn) to the fleet."""
        if replica.cfg.block_tokens != self.block_tokens:
            raise ValueError(
                "replacement replica's block_tokens "
                f"({replica.cfg.block_tokens}) must match the fleet's "
                f"({self.block_tokens}) — routing keys would diverge")
        self.replicas.append(replica)

    def remove_replica(self, replica_id: str) -> Replica:
        """Retire a replica from the fleet (drain + quarantine first via
        fail_replica; the caller owns close())."""
        replica = self._replica(replica_id)
        if replica.pending():
            raise ValueError(
                f"replica {replica_id!r} still holds {replica.pending()} "
                "requests; fail_replica() first")
        self.replicas.remove(replica)
        return replica

    # -- serving loop -----------------------------------------------------------------

    def run(self, max_rounds: int = 100_000) -> dict:
        """Drive every replica round-robin until the cluster drains."""
        rounds = 0
        while any(r.pending() for r in self.replicas) and rounds < max_rounds:
            for r in self.replicas:
                r.tick()
            rounds += 1
        return self.stats()

    def close(self) -> None:
        for r in self.replicas:
            r.close()
            if self.budget is not None:
                self.budget.release(r.replica_id)
            if self.pinned_budget is not None:
                self.pinned_budget.release(r.replica_id)
            if self.tenant_manager is not None:
                self.tenant_manager.decommission(r.tenant.tenant_id)

    # -- fleet metrics ----------------------------------------------------------------

    def ttfts(self) -> list[dict]:
        """Per accepted request: TTFT on the virtual clock + placement."""
        out = []
        for entry in self.request_log:
            req = entry["request"]
            if req.first_token_t is None:
                continue
            out.append({
                "request_id": req.request_id,
                "replica_id": entry["replica_id"],
                "affinity": entry["affinity"],
                "warm_blocks": entry["warm_blocks"],
                "ttft_s": req.first_token_t - req.enqueue_t,
            })
        return out

    def stats(self) -> dict:
        per_replica = [r.stats() for r in self.replicas]
        makespan = max(r.clock.now for r in self.replicas)
        total_tokens = sum(s["total_tokens"] for s in per_replica)
        iso = (self.tenant_manager.isolation_report()
               if self.tenant_manager is not None else None)
        # fleet-merged telemetry: per-replica registries merge losslessly
        # (counters add, histogram samples pool) because every series
        # carries (replica, tenant) labels — percentiles in the merged
        # snapshot are exact over the pooled samples, not averaged p99s
        observatories = [r.obs for r in self.replicas
                         if getattr(r, "obs", None) is not None]
        merged_obs = (Observatory.merge(observatories).snapshot()
                      if observatories else None)
        return {
            "routing": self.routing.value,
            "n_replicas": len(self.replicas),
            "finished": sum(s["finished"] for s in per_replica),
            "total_tokens": total_tokens,
            "makespan_s": makespan,
            "tokens_per_s": total_tokens / makespan if makespan > 0 else 0.0,
            "bridge_time_s": sum(s["bridge_time_s"] for s in per_replica),
            "rejected": self.rejected,
            "affinity_hits": self.affinity_hits,
            "failovers": self.failovers,
            "failover_moved": self.failover_moved,
            "failover_requeued": self.failover_requeued,
            "health": {r.replica_id: r.health for r in self.replicas},
            "warm_blocks_restored": sum(s["warm_blocks_restored"]
                                        for s in per_replica),
            "leased_contexts": [s["leased_contexts"] for s in per_replica],
            "isolation": iso,
            "obs": merged_obs,
            "replicas": per_replica,
        }


def build_cluster(model, *, profile: BridgeProfile = TPU_V5E,
                  cc_on: bool = True, n_replicas: int = 2,
                  partition_size: int = 2,
                  routing: RoutingPolicy = RoutingPolicy.PREFIX_AFFINITY,
                  replica_cfg: Optional[ReplicaConfig] = None,
                  max_cluster_queue: int = 4096,
                  require_attestation: bool = True,
                  host_pinned_bytes: Optional[int] = None,
                  prefer_overlap_filled: bool = False,
                  fault_plan: Optional[FaultPlan] = None,
                  seed: int = 0) -> ClusterRouter:
    """Provision a cluster: fabric tenants, fair-share context leases,
    pinned-arena leases from the host-wide pool, and one replica per tenant
    behind a routing front end.

    `host_pinned_bytes` declares the host's pinned-memory budget: each
    replica's full pinned footprint (`ReplicaConfig.pinned_bytes` — arena
    slabs + per-context channel slots + coalescer flush buffer) is leased
    from it at spawn, and a fleet that over-subscribes the pool fails *here*
    (BudgetExhausted) instead of degrading at runtime.  None = unconstrained
    (legacy).

    Every replica runs where ``model`` lies (the card unless the model was
    built on the CPU).

    `fault_plan` arms seeded fault injection (DESIGN.md §11) on every
    replica; replica i draws from an independent stream at
    ``seed = fault_plan.seed + i`` so a fleet's faults decorrelate the way
    independent channels do.  None = fault-free (the default fast path).
    """
    cfg = replica_cfg or ReplicaConfig()
    if cfg.tp_degree > partition_size:
        # fail before any tenant is provisioned: a TP group must fit inside
        # one tenant's partition (in-tenant P2P is the only cheap path —
        # cross-tenant traffic would both break isolation and ride the
        # bridge), so the operator must size partitions to the TP degree
        raise ValueError(
            f"tp_degree={cfg.tp_degree} does not fit partition_size="
            f"{partition_size}: a tensor-parallel replica shards across its "
            f"own tenant's devices only (DESIGN.md §12)")
    tm = TenantManager(profile, cc_on=cc_on)
    budget = SecureContextBudget(profile, cc_on=cc_on)
    pinned = PinnedBudget(host_pinned_bytes)
    grants = budget.fair_share(n_replicas, cfg.contexts_requested)
    replicas = []
    for i in range(n_replicas):
        tenant = tm.provision(f"tenant-{i}", partition_size,
                              require_attestation=require_attestation)
        lease = budget.acquire(f"replica-{i}", grants[i])
        # lease the replica's FULL pinned footprint: arena slabs plus the
        # granted contexts' channel slots plus the coalescer flush buffer —
        # the channel pool pins host memory just like the arena does
        pinned_lease = pinned.acquire(f"replica-{i}",
                                      cfg.pinned_bytes(lease.n_contexts))
        bridge = BridgeModel(profile, cc_on=cc_on)
        plan_i = (dataclasses.replace(fault_plan, seed=fault_plan.seed + i)
                  if fault_plan is not None else None)
        replicas.append(Replica(f"replica-{i}", model, tenant, lease, bridge,
                                cfg, seed=seed + i, pinned_lease=pinned_lease,
                                fault_plan=plan_i, tenant_manager=tm,
                                context_budget=budget, pinned_budget=pinned))
    return ClusterRouter(replicas, routing=routing,
                         max_cluster_queue=max_cluster_queue,
                         tenant_manager=tm, budget=budget,
                         pinned_budget=pinned,
                         prefer_overlap_filled=prefer_overlap_filled)
