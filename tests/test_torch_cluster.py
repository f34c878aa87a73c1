"""The port's cluster layer against the reference.

The cases of ``tests/test_cluster.py`` and ``tests/test_chaos_cluster.py``
run against ``repro_torch.cluster`` on the CPU (budgets, tenant manager,
router, autoscaler, inventory exports, end-to-end serving, callback
isolation, dirty shutdown, leak audits, attestation-gated routing, spawn
backoff, failover).  With shared weights, the port's cluster gives the
reference's tokens, per-replica tapes and ``cluster.stats()`` at smoke
width, under least-loaded and prefix-affinity routing and through a
failover.
"""

import dataclasses
import enum
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import repro.cluster as j_cluster
from repro.configs.base import all_configs, smoke_config
from repro.models.model import Model as JModel
from repro.serving.engine import Request as JRequest
from repro.serving.sampler import SamplingParams as JSampling

from repro_torch.cluster import (Autoscaler, AutoscalerConfig,
                                 BudgetExhausted, PinnedBudget,
                                 ReplicaConfig, ReplicaMetrics,
                                 RoutingPolicy, ScaleDecision,
                                 SecureContextBudget, build_cluster,
                                 prompt_prefix_hashes)
import repro_torch.cluster as t_cluster
from repro_torch.cluster.replica import Replica
from repro_torch.cluster.router import ClusterRouter
from repro_torch.cluster.tenant_manager import (AttestationError,
                                                TenantManager)
from repro_torch.configs.base import get_config, smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.bridge import TPU_V5E, BridgeModel
from repro_torch.core.fabric import AttestationEvidence
from repro_torch.core.gateway import TransferGateway
from repro_torch.core.policy import (OffloadPolicy, SchedulingPolicy,
                                     cc_aware_defaults)
from repro_torch.models.model import Model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.kv_cache import (PagePool, block_table_array,
                                          ragged_block_tables)
from repro_torch.serving.offload import OffloadManager
from repro_torch.serving.sampler import SamplingParams
from repro_torch.trace import ReplaySpec, TraceReplayer, check_tape

torch.set_num_threads(1)

J = types.SimpleNamespace(cluster=j_cluster, Request=JRequest,
                          Sampling=JSampling)
T = types.SimpleNamespace(cluster=t_cluster, Request=Request,
                          Sampling=SamplingParams)


def plain(x):
    """A package-neutral value: dataclasses as dicts, enums as values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, set):
        return sorted(plain(v) for v in x)
    if isinstance(x, np.generic):
        return x.item()
    return x


def _gateway(workers=2):
    return TransferGateway(BridgeModel(TPU_V5E, cc_on=True),
                           cc_aware_defaults(True), pool_workers=workers,
                           device="cpu")


def _req(rid, prompt, n_tokens=2):
    return Request(rid, prompt=prompt,
                   sampling=SamplingParams(max_new_tokens=n_tokens))


@pytest.fixture(scope="module")
def models():
    """The reference's smoke olmo-1b with every engine drawing the same
    weights (seed 0), and the port's model on the CPU holding them."""
    jcfg = smoke_config(all_configs()["olmo-1b"])
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jmodel.init = lambda key: jparams
    tcfg = t_smoke(get_config("olmo-1b"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return jmodel, Model(tcfg, params=tparams, device="cpu")


@pytest.fixture(scope="module")
def tiny_model(models):
    return models[1]


# ---------------------------------------------------------------------------------
# budgets, tenant manager
# ---------------------------------------------------------------------------------

class TestSecureContextBudget:
    def test_limit_comes_from_profile(self):
        b = SecureContextBudget(TPU_V5E, cc_on=True)
        assert b.limit == TPU_V5E.max_secure_contexts

    def test_cc_off_is_unconstrained(self):
        b = SecureContextBudget(TPU_V5E, cc_on=False)
        assert b.acquire("r0", 999).n_contexts == 999
        assert b.available() == float("inf")

    def test_partial_grant_then_exhaustion(self):
        b = SecureContextBudget(TPU_V5E, cc_on=True)   # limit 16
        assert b.acquire("r0", 12).n_contexts == 12
        assert b.acquire("r1", 12).n_contexts == 4
        with pytest.raises(BudgetExhausted):
            b.acquire("r2", 1)
        b.release("r1")
        assert b.acquire("r2", 2).n_contexts == 2

    def test_double_lease_rejected(self):
        b = SecureContextBudget(TPU_V5E, cc_on=True)
        b.acquire("r0", 2)
        with pytest.raises(ValueError):
            b.acquire("r0", 2)

    @pytest.mark.parametrize("n,want", [(2, [8, 8]), (4, [4] * 4),
                                        (8, [2] * 8)])
    def test_fair_share_redistributes_not_multiplies(self, n, want):
        b = SecureContextBudget(TPU_V5E, cc_on=True)
        assert b.fair_share(n, 8) == want
        assert sum(b.fair_share(n, 8)) <= b.limit

    def test_fair_share_over_limit_raises(self):
        b = SecureContextBudget(TPU_V5E, cc_on=True, limit=4)
        with pytest.raises(BudgetExhausted):
            b.fair_share(5, 1)

    def test_pinned_budget_is_full_grant_or_rejection(self):
        p = PinnedBudget(100)
        assert p.acquire("a", 60).nbytes == 60
        with pytest.raises(BudgetExhausted):
            p.acquire("b", 41)
        assert p.max_replicas(20) == 2
        p.release("a")
        assert p.allocated() == 0


class TestTenantManager:
    def test_provision_two_isolated_tenants(self):
        tm = TenantManager(TPU_V5E, cc_on=True)
        a, b = tm.provision("a", 2), tm.provision("b", 2)
        assert not (set(a.visible_devices()) & set(b.visible_devices()))
        assert tm.isolation_report()["isolated"]
        assert all(rec.attested for rec in tm.records)

    def test_capacity_by_partition_vocabulary(self):
        tm = TenantManager(TPU_V5E, cc_on=True)
        assert tm.capacity(2) == 4
        tm.provision("a", 2)
        assert tm.capacity(2) == 3
        assert tm.capacity(8) == 0

    def test_attestation_gate_blocks_bad_evidence(self):
        tm = TenantManager(TPU_V5E, cc_on=True)
        with pytest.raises(AttestationError):
            tm.provision("a", 2,
                         evidence=AttestationEvidence(device_cc_mode=False))
        assert "a" not in tm.fm.active

    def test_attestation_gap_is_reported_not_trusted(self):
        tm = TenantManager(TPU_V5E, cc_on=True)
        report = tm.attest(tm.provision("a", 2))
        assert report["ok"]
        assert "fabric_manager_identity" in report["gap"]
        assert "switch_routing_tables" in report["gap"]

    def test_stale_partition_health_gate(self):
        tm = TenantManager(TPU_V5E, cc_on=True)
        for p in tm.fm.partitions:
            tm.fm.mark_stale(p.partition_id)
        with pytest.raises(RuntimeError):
            tm.provision("a", 2)

    def test_control_plane_timing_and_reattest(self):
        tm = TenantManager(TPU_V5E, cc_on=True)
        t = tm.provision("a", 2)
        after = tm.control_plane_seconds
        assert 10.0 <= after <= 20.0
        assert tm.reattest(t)["ok"] and tm.reattests == 1
        tm.decommission("a")
        assert tm.control_plane_seconds > after


# ---------------------------------------------------------------------------------
# router (stub replicas), autoscaler
# ---------------------------------------------------------------------------------

class _StubReplica:
    """Routing surface, with the health gate."""

    def __init__(self, replica_id, inventory=(), load=0.0, *, attested=True,
                 health="healthy"):
        self.replica_id = replica_id
        self.cfg = ReplicaConfig()
        self._inventory = set(inventory)
        self._load = load
        self.attested = attested
        self.health = health
        self.submitted = []

    def routable(self):
        return self.health == "healthy" and self.attested

    def kv_inventory(self):
        return self._inventory

    def load_score(self):
        return self._load

    def pending(self):
        return 0

    def submit(self, req, prefix_hashes=None):
        self.submitted.append(req)
        return True


class TestRouterRouting:
    def test_prefix_affinity_prefers_inventory_overlap(self):
        prompt = list(range(16)) + [99] * 4
        warm = _StubReplica("warm", prompt_prefix_hashes(prompt, 8), 100.0)
        cold = _StubReplica("cold", [], 0.0)
        router = ClusterRouter([cold, warm],
                               routing=RoutingPolicy.PREFIX_AFFINITY)
        assert router.submit(_req("r0", prompt)) is warm
        assert router.affinity_hits == 1

    def test_affinity_falls_back_to_least_loaded(self):
        busy, idle = _StubReplica("busy", [], 5.0), _StubReplica("idle", [],
                                                                 1.0)
        router = ClusterRouter([busy, idle],
                               routing=RoutingPolicy.PREFIX_AFFINITY)
        assert router.submit(_req("r0", list(range(16)))) is idle
        assert router.affinity_hits == 0

    def test_least_loaded_breaks_ties_round_robin(self):
        a, b = _StubReplica("a", [], 1.0), _StubReplica("b", [], 1.0)
        router = ClusterRouter([a, b], routing=RoutingPolicy.LEAST_LOADED)
        picks = [router.submit(_req(f"r{i}", list(range(16)))).replica_id
                 for i in range(4)]
        assert picks == ["a", "b", "a", "b"]

    def test_admission_control_sheds_load(self):
        class Backed(_StubReplica):
            def pending(self):
                return 10

        router = ClusterRouter([Backed("a", [], 1.0)],
                               routing=RoutingPolicy.LEAST_LOADED,
                               max_cluster_queue=5)
        assert router.submit(_req("r0", [1, 2, 3])) is None
        assert router.rejected == 1

    @pytest.mark.parametrize("bad", [dict(attested=False),
                                     dict(health="quarantined")])
    def test_unroutable_replica_receives_nothing(self, bad):
        sick, good = _StubReplica("sick", **bad), _StubReplica("good")
        for routing in RoutingPolicy:
            router = ClusterRouter([sick, good], routing=routing)
            for i in range(3):
                assert router.submit(_req(f"r{i}", list(range(16)))) is good
        assert sick.submitted == []

    def test_no_eligible_replica_sheds_instead_of_misplacing(self):
        bad = _StubReplica("bad", attested=False)
        router = ClusterRouter([bad], routing=RoutingPolicy.LEAST_LOADED)
        assert router.submit(_req("r0", list(range(16)))) is None
        assert router.rejected == 1 and bad.submitted == []


def _metrics(rid, delay, vt=10.0, bridge=0.0):
    return ReplicaMetrics(replica_id=rid, queued=1, active=1,
                          queue_delay_s=delay, virtual_time_s=vt,
                          bridge_time_s=bridge,
                          op_class_seconds={"drain_d2h": bridge})


class TestAutoscaler:
    CFG = AutoscalerConfig(high_queue_delay_s=0.1, low_queue_delay_s=0.01,
                           min_replicas=1, max_replicas=4,
                           bridge_bound_fraction=0.5)

    @pytest.mark.parametrize("delays,exhaust,bridge,want,target", [
        ((0.5, 0.3), False, 0.0, ScaleDecision.SCALE_UP, 3),
        ((0.0, 0.0), False, 0.0, ScaleDecision.SCALE_DOWN, 1),
        ((0.05,), False, 0.0, ScaleDecision.HOLD, 1),
        ((0.0,), False, 0.0, ScaleDecision.HOLD, 1),
        ((0.5,), True, 8.0, ScaleDecision.BRIDGE_BOUND, 1),
        ((0.5,), False, 8.0, ScaleDecision.SCALE_UP, 2),
    ])
    def test_decisions(self, delays, exhaust, bridge, want, target):
        budget = SecureContextBudget(TPU_V5E, cc_on=True)
        if exhaust:
            budget.acquire("fleet", budget.limit)
        out = Autoscaler(budget, self.CFG).evaluate(
            [_metrics(f"r{i}", d, bridge=bridge)
             for i, d in enumerate(delays)])
        assert out["decision"] is want
        assert out["target_replicas"] == target

    def test_rejected_spawn_backs_off_instead_of_hammering(self):
        budget = SecureContextBudget(TPU_V5E, cc_on=True, limit=1)
        budget.acquire("existing", 1)
        calls = []

        def spawn_fn():
            calls.append(1)
            return budget.acquire(f"rep{len(calls)}", 1)

        scaler = Autoscaler(budget, AutoscalerConfig(spawn_backoff_s=1.0))
        assert scaler.try_spawn(spawn_fn, now=0.0) is None
        for t in (0.1, 0.5, 0.9):
            assert scaler.try_spawn(spawn_fn, now=t) is None
        assert len(calls) == 1 and scaler.spawn_skipped == 3
        assert scaler.try_spawn(spawn_fn, now=1.0) is None
        assert len(calls) == 2
        assert scaler.spawn_backoff_until == pytest.approx(3.0)
        budget.release("existing")
        assert scaler.try_spawn(lambda: budget.acquire("rep", 1),
                                now=3.0) is not None
        assert scaler.spawns == 1 and scaler.spawn_backoff_until == 0.0


# ---------------------------------------------------------------------------------
# page pool, inventories, restore callbacks, engine shutdown
# ---------------------------------------------------------------------------------

class TestPagePoolAndInventories:
    def test_page_pool_inventory_tracks_allocated_hashes(self):
        pool = PagePool(16, 8, 2, 16, 2, device="cpu")
        blocks = [(1, 2, 3), (4, 5, 6)]
        table = pool.allocate("a", 16, token_blocks=blocks)
        assert pool.inventory() == {hash(b) for b in blocks}
        pool.release(table)
        assert pool.inventory() == set()

    def test_page_reuse_drops_stale_hashes(self):
        pool = PagePool(2, 8, 2, 16, 2, device="cpu")
        pool.release(pool.allocate("a", 16, token_blocks=[(1, 2), (3, 4)]))
        pool.allocate("b", 16)
        assert pool.inventory() == set()

    def test_page_pool_tensors_and_tables(self):
        pool = PagePool(4, 8, 2, 16, 3, device="cpu")
        assert pool.k.shape == (3, 4, 8, 2, 16)
        assert pool.k.dtype == torch.bfloat16 and pool.k.device.type == "cpu"
        assert pool.allocate("x", 40) is None        # exhausted: 5 pages
        t = {"a": pool.allocate("a", 17), "b": pool.allocate("b", 3)}
        pool.write_token(1, t["a"][0], 2, torch.ones(2, 16),
                         torch.full((2, 16), 2.0))
        k, v = pool.layer_views(1)
        assert float(k[t["a"][0], 2].sum()) == 32.0
        assert float(v[t["a"][0], 2].sum()) == 64.0
        dense = block_table_array(t, ["a", "b"], 4)
        assert dense.tolist() == [t["a"] + [0], t["b"] + [0, 0, 0]]
        flat, offsets = ragged_block_tables(t, ["a", "b"])
        assert flat.tolist() == t["a"] + t["b"]
        assert offsets.tolist() == [0, 3, 4]
        assert pool.utilization() == 1.0

    def test_offload_inventory_is_host_store(self):
        mgr = OffloadManager(_gateway(4), OffloadPolicy.REUSE_AWARE,
                             store_threshold=2)
        h = hash(("p", 0))
        mgr.observe(h)
        mgr.observe(h)
        mgr.evict(h, payload_bytes=512)
        assert mgr.inventory() == {h}

    def test_raising_restore_subscriber_does_not_poison_peers(self):
        mgr = OffloadManager(_gateway(), OffloadPolicy.REUSE_AWARE,
                             store_threshold=1, block_bytes=512)
        h = hash(("p", 0))
        mgr.observe(h)
        mgr.evict(h, payload_bytes=512)
        got = []

        def boom(key, done_t):
            raise RuntimeError("subscriber bug")

        mgr.on_restore_done.append(boom)
        mgr.on_restore_done.append(lambda key, t: got.append((key, t)))
        assert mgr.restore([h], key="r0") == (1, 512)
        assert got and got[0][0] == "r0"
        assert mgr.stats.callback_errors == 1

    def test_wedged_drain_thread_warns_and_marks_dirty(self, tiny_model):
        eng = ServingEngine(tiny_model, max_batch=2, max_len=32,
                            policy=SchedulingPolicy.SYNC_DRAIN, cc_on=True,
                            device="cpu")
        wedged = threading.Thread(target=time.sleep, args=(10,), daemon=True)
        wedged.start()
        eng._worker = wedged
        eng.drain_join_timeout_s = 0.05
        with pytest.warns(RuntimeWarning, match="wedged"):
            eng.close()
        assert eng.closed_dirty and eng.stats()["closed_dirty"] is True


# ---------------------------------------------------------------------------------
# replicas and clusters end to end
# ---------------------------------------------------------------------------------

class TestReplicaLifecycle:
    def test_spawn_close_loop_returns_all_leases_and_pages(self, tiny_model):
        budget = SecureContextBudget(TPU_V5E, cc_on=True)
        pinned = PinnedBudget(8 << 30)
        tm = TenantManager(TPU_V5E, cc_on=True)
        cfg = ReplicaConfig(max_batch=2, max_len=64)
        for i in range(3):
            tenant = tm.provision(f"t{i}", 2)
            lease = budget.acquire(f"rep{i}", 4)
            please = pinned.acquire(f"rep{i}",
                                    cfg.pinned_bytes(lease.n_contexts))
            rep = Replica(f"rep{i}", tiny_model, tenant, lease,
                          BridgeModel(TPU_V5E, cc_on=True), cfg,
                          pinned_lease=please, context_budget=budget,
                          pinned_budget=pinned)
            assert rep.device == tiny_model.device
            assert rep.pages.k.device == tiny_model.device
            assert rep.submit(_req(f"r{i}", list(range(1, 17))))
            assert len(rep.pages.free) < cfg.n_pages
            rep.close()
            rep.close()
            assert len(rep.pages.free) == cfg.n_pages
            assert budget.allocated() == 0 and pinned.allocated() == 0
            tm.decommission(tenant.tenant_id)

    def test_zero_context_lease_refused(self, tiny_model):
        from repro_torch.cluster import ContextLease
        tm = TenantManager(TPU_V5E, cc_on=True)
        with pytest.raises(BudgetExhausted):
            Replica("r", tiny_model, tm.provision("t", 2),
                    ContextLease(0, "r", 0), BridgeModel(TPU_V5E, cc_on=True))

    def test_cluster_runs_where_its_model_lies(self, tiny_model,
                                               monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cluster = build_cluster(tiny_model, n_replicas=1)
        assert cluster.replicas[0].engine.device.type == "cpu"
        cluster.close()
        with pytest.raises(RuntimeError, match="CUDA"):
            Model(tiny_model.cfg, seed=0)


def serve(pkg, model, routing, *, per_request_run=False, fail=False,
          seed=0):
    """One cluster run; returns tokens, normalized stats, tapes, ttfts."""
    cluster = pkg.cluster.build_cluster(
        model, cc_on=True, n_replicas=2, partition_size=2,
        routing=routing, seed=seed,
        replica_cfg=pkg.cluster.ReplicaConfig(max_batch=2, max_len=64))
    prefix = list(range(1, 17))
    report = None
    for i in range(5):
        assert cluster.submit(pkg.Request(
            f"r{i}", prompt=prefix + [40 + i] * 8,
            sampling=pkg.Sampling(max_new_tokens=3))) is not None
        if per_request_run:
            cluster.run()
    if fail:
        for r in cluster.replicas:
            r.tick()
        loaded = max(cluster.replicas, key=lambda r: r.pending())
        report = cluster.fail_replica(loaded.replica_id, reason="injected")
    stats = cluster.run()
    out = dict(
        tokens={e["request"].request_id: tuple(e["request"].output_tokens)
                for e in cluster.request_log},
        stats=plain(stats), tapes=[r.tape() for r in cluster.replicas],
        ttfts=cluster.ttfts(), report=report,
        metrics=[plain(r.metrics()) for r in cluster.replicas],
        placement=[e["replica_id"] for e in cluster.request_log])
    cluster.close()
    return out


SCENARIOS = {
    "least_loaded": dict(routing="least_loaded"),
    "prefix_affinity_warm": dict(routing="prefix_affinity",
                                 per_request_run=True),
    "failover": dict(routing="least_loaded", fail=True),
}


@pytest.fixture(scope="module")
def reference_runs(models):
    return {name: serve(J, models[0], j_cluster.RoutingPolicy(s["routing"]),
                        **{k: v for k, v in s.items() if k != "routing"})
            for name, s in SCENARIOS.items()}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_cluster_is_the_references(models, reference_runs, name):
    s = SCENARIOS[name]
    got = serve(T, models[1], RoutingPolicy(s["routing"]),
                **{k: v for k, v in s.items() if k != "routing"})
    want = reference_runs[name]
    assert got["tokens"] == want["tokens"]
    assert got["placement"] == want["placement"]
    assert got["report"] == want["report"]
    assert got["ttfts"] == want["ttfts"]
    assert got["metrics"] == want["metrics"]
    assert got["stats"] == want["stats"]
    for tt, jt in zip(got["tapes"], want["tapes"]):
        assert tt.meta.to_dict() == jt.meta.to_dict()
        assert [r.to_dict() for r in tt.records] == \
            [r.to_dict() for r in jt.records]
    assert got["stats"]["finished"] == 5


class TestClusterEndToEnd:
    def test_two_tenants_serve_concurrently_and_stay_isolated(self,
                                                              tiny_model):
        cluster = build_cluster(tiny_model, cc_on=True, n_replicas=2,
                                routing=RoutingPolicy.LEAST_LOADED)
        for i in range(4):
            cluster.submit(_req(f"r{i}", list(range(1, 17)) + [50 + i] * 8,
                                3))
        for r in cluster.replicas:
            r.tick()
        assert all(r.engine.active or r.engine.queue
                   for r in cluster.replicas)
        st = cluster.run()
        assert st["finished"] == 4 and st["isolation"]["isolated"]
        assert sum(st["leased_contexts"]) <= TPU_V5E.max_secure_contexts
        cluster.close()
        assert cluster.tenant_manager.isolation_report()["tenants"] == {}
        assert cluster.budget.allocated() == 0
        assert cluster.pinned_budget.allocated() == 0

    def test_prefix_affinity_restores_warm_prefix(self, tiny_model):
        cluster = build_cluster(tiny_model, cc_on=True, n_replicas=2,
                                routing=RoutingPolicy.PREFIX_AFFINITY)
        for i in range(5):
            cluster.submit(_req(f"r{i}", list(range(1, 17)) + [90 + i] * 8))
            cluster.run()
        st = cluster.stats()
        assert st["affinity_hits"] >= 1 and st["warm_blocks_restored"] >= 2
        ttfts = {t["request_id"]: t for t in cluster.ttfts()}
        assert ttfts["r4"]["warm_blocks"] > 0
        assert ttfts["r4"]["ttft_s"] < ttfts["r0"]["ttft_s"]
        cluster.close()

    def test_replica_tapes_are_conformant_and_reprice(self, tiny_model):
        cluster = build_cluster(tiny_model, cc_on=True, n_replicas=2,
                                routing=RoutingPolicy.PREFIX_AFFINITY)
        for i in range(4):
            cluster.submit(_req(f"r{i}", list(range(1, 17)) + [40 + i] * 8))
            cluster.run()
        served = [t for t in (r.tape() for r in cluster.replicas)
                  if t.n_crossings()]
        assert served
        for replica in cluster.replicas:
            tape = replica.tape()
            assert tape.meta.label == f"replica-{replica.replica_id}"
            assert check_tape(tape).ok
            assert replica.metrics().op_class_seconds == \
                tape.op_class_seconds()
        assert "kv_spill_d2h" in served[0].op_class_mix()
        assert TraceReplayer(served[0]).reprice(
            ReplaySpec(cc_on=False)).gap_s > 0
        cluster.close()

    def test_failover_requeues_on_source_when_no_peer(self, tiny_model):
        cluster = build_cluster(tiny_model, n_replicas=1,
                                replica_cfg=ReplicaConfig(max_batch=2,
                                                          max_len=64))
        for i in range(2):
            assert cluster.submit(_req(f"r{i}", list(range(1, 17))))
        report = cluster.fail_replica("replica-0", reason="injected")
        assert report["requeued"] == report["drained"] == 2
        assert cluster.run()["finished"] == 2
        cluster.replicas[0].mark_healthy()
        assert cluster.replicas[0].routable()
        cluster.close()

    def test_tensor_parallel_replica_is_not_ported(self, tiny_model):
        """TP replicas are ported now (pricing only): a TP=2 replica serves
        and charges its allreduces; a degree over the partition raises."""
        cluster = build_cluster(tiny_model, n_replicas=1,
                                replica_cfg=ReplicaConfig(tp_degree=2))
        assert cluster.submit(_req("r0", list(range(1, 17)), 3))
        assert cluster.run()["finished"] == 1
        assert cluster.replicas[0].stats()["p2p_bytes"] > 0
        cluster.close()
        with pytest.raises(ValueError, match="does not fit partition_size"):
            build_cluster(tiny_model, n_replicas=1, partition_size=2,
                          replica_cfg=ReplicaConfig(tp_degree=4))
