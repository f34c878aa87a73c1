"""The port's fabric tenancy, fabric P2P, TP pricing and shard exchange
against the reference.

Every case of ``tests/test_tp_fabric.py`` and
``tests/test_fabric_accounting.py`` runs against ``repro_torch`` on the
CPU (cases that repeat over a parameter are parametrised; the two loader
cases run in ``tests/test_torch_loader.py``).  With shared
weights, the port's TP engine and TP cluster give the reference's tokens,
tapes, ``stats()`` and ``cluster.stats()`` at TP 1/2/4/8: the allreduce is
charged after each cold prefill, each packed step (on its real rows) and
each dense step, with the skew spread as straggler time, and one device
runs the whole model at every degree.
"""

import dataclasses
import enum
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="property tests need hypothesis")
import hypothesis.strategies as st
from hypothesis import given, settings

import jax

import repro.cluster as j_cluster
from repro.configs.base import all_configs, smoke_config
from repro.core.bridge import BridgeModel as JBridge, TPU_V5E as J_TPU_V5E
from repro.core.compute import ComputeModel as JCompute
from repro.core.policy import SchedulingPolicy as JPolicy
from repro.core.policy import cc_aware_defaults as j_defaults
from repro.models.model import Model as JModel
from repro.serving.engine import Request as JRequest, ServingEngine as JEngine
from repro.serving.sampler import SamplingParams as JSampling

import repro_torch.cluster as t_cluster
from repro_torch.cluster import ReplicaConfig, RoutingPolicy, build_cluster
from repro_torch.configs.base import get_config, smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.accounting import CopyRecord, attribute
from repro_torch.core.bridge import (B300, RTX_PRO_6000, TPU_V5E,
                                     BridgeModel, Crossing, Direction,
                                     StagingKind)
from repro_torch.core.channels import (P2P_CHANNEL, SecureChannelPool,
                                       VirtualClock)
from repro_torch.core.compute import ComputeModel
from repro_torch.core.fabric import (AttestationEvidence, FabricManager,
                                     FabricState, FabricTransport,
                                     enumerate_partitions, p2p_bandwidth)
from repro_torch.core.gateway import TransferGateway
from repro_torch.core.policy import (OffloadPolicy, SchedulingPolicy,
                                     cc_aware_defaults)
from repro_torch.models.model import Model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.offload import OffloadManager
from repro_torch.serving.sampler import SamplingParams
from repro_torch.trace import TraceRecorder, check_tape
from repro_torch.trace import opclasses as oc
from repro_torch.trace.replay import ReplaySpec, TraceReplayer

torch.set_num_threads(1)

TP_DEGREES = (1, 2, 4, 8)


def _gateway(*, profile=TPU_V5E, cc_on=True, workers=2):
    return TransferGateway(BridgeModel(profile, cc_on=cc_on),
                           cc_aware_defaults(cc_on), pool_workers=workers,
                           device="cpu")


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
    if isinstance(x, np.generic):
        return x.item()
    return x


def _records(tape) -> list:
    return [r.to_dict() for r in tape.records]


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
# tests/test_fabric_accounting.py
# ---------------------------------------------------------------------------------

class TestFabric:
    def test_partition_vocabulary_15(self):
        parts = enumerate_partitions(8)
        sizes = sorted(p.size for p in parts)
        assert len(parts) == 15
        assert sizes.count(8) == 1 and sizes.count(4) == 2
        assert sizes.count(2) == 4 and sizes.count(1) == 8

    def test_only_vocab_shapes_allocatable(self):
        with pytest.raises(ValueError):
            FabricManager(B300).find_partition(3)

    def test_concurrent_tenants_disjoint(self):
        fm = FabricManager(B300)
        a = fm.activate("a", 2)
        b = fm.activate("b", 2)
        assert not (set(a.visible_devices()) & set(b.visible_devices()))
        assert fm.check_isolation()["isolated"]

    def test_capacity_exhaustion(self):
        fm = FabricManager(B300)
        fm.activate("a", 8)
        with pytest.raises(RuntimeError):
            fm.activate("b", 1)

    def test_p2p_two_orders_above_bridge(self):
        bridge_bw = BridgeModel(B300, cc_on=True).aggregate_bandwidth(
            Direction.H2D, 1)
        assert p2p_bandwidth(B300, fabric_up=True) > 40 * bridge_bw
        assert p2p_bandwidth(B300, fabric_up=False) == pytest.approx(10e6)

    def test_attestation_gap_is_explicit(self):
        assert set(AttestationEvidence().gap()) == {
            "fabric_manager_identity", "fabric_manager_config",
            "switch_routing_tables"}


class TestAccounting:
    def test_paper_profile_closes(self):
        rows = [("alloc_h2d", 1138, 31.7e-6, 1389e-6),
                ("prealloc", 2628, 25.1e-6, 31.0e-6),
                ("prep", 260, 18.2e-6, 18.4e-6),
                ("attn", 192, 27.0e-6, 27.8e-6)]
        off = [CopyRecord(n, 64, t, False) for n, c, t, _ in rows
               for _ in range(c)]
        on = [CopyRecord(n, 64, t, True) for n, c, _, t in rows
              for _ in range(c)]
        attr = attribute(off, on, total_gap_s=1.56)
        assert attr.closure == pytest.approx(0.99, abs=0.03)
        assert attr.dominant().op_class == "alloc_h2d"
        assert attr.dominant().per_call_slowdown == pytest.approx(43.8,
                                                                  rel=0.02)

    def test_unpaired_profiles_rejected(self):
        off = [CopyRecord("x", 64, 1e-5, False)] * 100
        on = [CopyRecord("x", 64, 1e-5, True)] * 90
        with pytest.raises(ValueError, match="unpaired"):
            attribute(off, on, 1.0)

    @given(calls=st.integers(1, 500), off_us=st.floats(1.0, 100.0),
           slow=st.floats(1.0, 100.0))
    @settings(max_examples=30, deadline=None)
    def test_closure_exact_when_profile_is_whole_story(self, calls, off_us,
                                                       slow):
        on_us = off_us * slow
        off = [CopyRecord("op", 64, off_us * 1e-6, False)] * calls
        on = [CopyRecord("op", 64, on_us * 1e-6, True)] * calls
        gap = calls * (on_us - off_us) * 1e-6
        if gap <= 0:
            return
        assert attribute(off, on, gap).closure == pytest.approx(1.0,
                                                                rel=1e-6)


class TestChannelPool:
    def test_pool_respects_system_channel_limit(self):
        with pytest.raises(ValueError, match="channel limit"):
            SecureChannelPool(BridgeModel(B300, cc_on=True), n_workers=25)

    def test_prewarm_keeps_lifecycle_off_critical_path(self):
        clock = VirtualClock()
        pool = SecureChannelPool(BridgeModel(B300, cc_on=True), 8,
                                 clock=clock)
        pool.prewarm()
        assert clock.now == 0.0
        pool.submit(Crossing(1 << 20, Direction.H2D, StagingKind.REGISTERED))
        pool.drain()
        t_transfer = clock.now
        pool.teardown(async_=True)
        assert clock.now == t_transfer
        assert pool.stats.critical_path_lifecycle == 0.0

    def test_non_persistent_pays_lifecycle_per_use(self):
        on = BridgeModel(B300, cc_on=True)
        clock = VirtualClock()
        pool = SecureChannelPool(on, 1, clock=clock, persistent=False)
        pool.submit(Crossing(1024, Direction.H2D, StagingKind.REGISTERED))
        assert clock.now > on.profile.context_create + \
            on.profile.context_destroy

    def test_parallel_channels_beat_single(self):
        on = BridgeModel(B300, cc_on=True)
        done = {}
        for n in (1, 8):
            pool = SecureChannelPool(on, n, clock=VirtualClock())
            pool.prewarm()
            t = 0.0
            for _ in range(16):
                t = max(t, pool.submit(Crossing(256 << 20, Direction.H2D,
                                                StagingKind.REGISTERED)))
            done[n] = t
        assert done[8] < done[1] / 3


# ---------------------------------------------------------------------------------
# tests/test_tp_fabric.py: partitions, leases, the fabric transport
# ---------------------------------------------------------------------------------

class TestHealthGate:
    def test_stale_partition_0_does_not_shadow_healthy_partition_1(self):
        fm = FabricManager(B300)
        fours = [p for p in fm.partitions if p.size == 4]
        fm.mark_stale(fours[0].partition_id)
        tenant = fm.activate("t", 4)
        assert tenant.partition.partition_id == fours[1].partition_id
        assert tenant.fabric_state is FabricState.HEALTHY
        assert fm.check_isolation()["isolated"]

    def test_all_free_partitions_stale_still_raises_health_gate(self):
        fm = FabricManager(B300)
        eight = next(p for p in fm.partitions if p.size == 8)
        fm.mark_stale(eight.partition_id)
        with pytest.raises(RuntimeError, match="health gate"):
            fm.activate("t", 8)

    def test_capacity_exhaustion_still_distinct_from_health_gate(self):
        fm = FabricManager(B300)
        fm.activate("a", 8)
        with pytest.raises(RuntimeError, match="no free"):
            fm.activate("b", 1)

    def test_find_partition_gate_is_opt_in(self):
        fm = FabricManager(B300)
        eight = next(p for p in fm.partitions if p.size == 8)
        fm.mark_stale(eight.partition_id)
        assert fm.find_partition(8) is not None
        assert fm.find_partition(8, require_healthy=True) is None


class TestZeroContextLease:
    @pytest.mark.parametrize("n_contexts", [0, 1])
    def test_lease_size(self, tiny_model, n_contexts):
        from repro_torch.cluster.budget import BudgetExhausted, ContextLease
        from repro_torch.cluster.replica import Replica
        from repro_torch.cluster.tenant_manager import TenantManager
        tenant = TenantManager(TPU_V5E).provision("t0", 1)
        lease = ContextLease(lease_id=0, holder="replica-0",
                             n_contexts=n_contexts)
        if n_contexts == 0:
            with pytest.raises(BudgetExhausted, match="0 secure contexts"):
                Replica("replica-0", tiny_model, tenant, lease,
                        BridgeModel(TPU_V5E, cc_on=True))
            return
        r = Replica("replica-0", tiny_model, tenant, lease,
                    BridgeModel(TPU_V5E, cc_on=True))
        assert r.gateway.pool.n_workers == 1
        r.close()


class TestFabricTransport:
    def test_healthy_tenant_rides_full_fabric(self):
        t = FabricManager(TPU_V5E).activate("t", 2)
        tr = FabricTransport(TPU_V5E, t)
        assert tr.fabric_up() and tr.bandwidth() == TPU_V5E.fabric_p2p_bw

    def test_stale_tenant_falls_back(self):
        t = FabricManager(TPU_V5E).activate("t", 2)
        t.fabric_state = FabricState.STALE
        tr = FabricTransport(TPU_V5E, t)
        assert not tr.fabric_up()
        assert tr.bandwidth() == TPU_V5E.fabric_fallback_bw

    def test_lapsed_attestation_falls_back(self):
        t = FabricManager(TPU_V5E).activate("t", 2)
        attested = {"ok": True}
        tr = FabricTransport(TPU_V5E, t, attested=lambda: attested["ok"])
        assert tr.fabric_up()
        attested["ok"] = False
        assert not tr.fabric_up()

    def test_fabricless_profile_always_falls_back(self):
        tr = FabricTransport(RTX_PRO_6000)
        assert not tr.fabric_up()
        assert tr.bandwidth() == RTX_PRO_6000.fabric_fallback_bw


class TestGatewayP2P:
    def test_p2p_record_shape_and_stats(self):
        gw = _gateway()
        nbytes = 64 << 20
        cost = gw.p2p(nbytes, op_class=oc.P2P_KV_MIGRATE)
        assert cost == pytest.approx(nbytes / TPU_V5E.fabric_p2p_bw)
        rec = gw.records[-1]
        assert rec.kind == "p2p" and rec.op_class == oc.P2P_KV_MIGRATE
        assert rec.direction == Direction.P2P.value
        assert rec.channel == P2P_CHANNEL and rec.staging == ""
        assert rec.charged and oc.FABRIC_FALLBACK not in rec.tags
        assert gw.stats.p2p_crossings == 1 and gw.stats.p2p_bytes == nbytes
        assert gw.stats.p2p_fallback_crossings == 0
        assert gw.stats.bridge_time_s == 0.0
        assert gw.clock.now == pytest.approx(cost)

    def test_down_fabric_prices_fallback_and_tags(self):
        gw = _gateway()
        t = FabricManager(TPU_V5E).activate("t", 2)
        t.fabric_state = FabricState.STALE
        gw.fabric = FabricTransport(TPU_V5E, t)
        cost = gw.p2p(1 << 20, op_class=oc.P2P_ALLREDUCE)
        assert cost == pytest.approx((1 << 20) / TPU_V5E.fabric_fallback_bw)
        assert oc.FABRIC_FALLBACK in gw.records[-1].tags
        assert gw.stats.p2p_fallback_crossings == 1

    @pytest.mark.parametrize("kw", [dict(nbytes=-1), dict(nbytes=1,
                                                          extra_s=-1e-6)])
    def test_negative_bytes_or_straggler_time_rejected(self, kw):
        with pytest.raises(ValueError, match="negative"):
            _gateway().p2p(kw["nbytes"], op_class=oc.P2P_KV_MIGRATE,
                           extra_s=kw.get("extra_s", 0.0))

    def test_secure_pool_refuses_p2p_crossings(self):
        pool = SecureChannelPool(BridgeModel(TPU_V5E, cc_on=True), 1,
                                 clock=VirtualClock())
        with pytest.raises(ValueError, match="secure copy channels"):
            pool.submit(Crossing(1024, Direction.P2P, StagingKind.REGISTERED))

    def test_p2p_tape_is_conformant_and_excluded_from_bridge_summaries(self):
        gw = _gateway()
        with TraceRecorder(gw) as rec:
            gw.h2d(np.zeros(4096, np.uint8), op_class=oc.PREP_BATCHED_H2D)
            gw.p2p(8 << 20, op_class=oc.P2P_SHARD_EXCHANGE)
        tape = rec.tape()
        assert check_tape(tape).ok, check_tape(tape).format()
        assert tape.n_crossings() == 1
        assert tape.p2p_bytes() == 8 << 20 and tape.bridge_bytes() == 4096
        assert tape.p2p_seconds() > 0

    def test_forged_p2p_record_on_a_channel_fails_conformance(self):
        gw = _gateway()
        with TraceRecorder(gw) as rec:
            gw.p2p(1 << 20, op_class=oc.P2P_ALLREDUCE)
        tape = rec.tape()
        tape.records[0] = dataclasses.replace(tape.records[0], channel=0)
        report = check_tape(tape)
        assert not report.ok
        assert any("P2P" in v.law for v in report.violations)


class TestFabricChurn:
    @pytest.mark.parametrize("size", [1, 2, 4, 8])
    def test_activate_deactivate_reactivate(self, size):
        fm = FabricManager(B300)
        for round_ in range(3):
            tid = f"t{size}-{round_}"
            assert fm.activate(tid, size).partition.size == size
            assert fm.check_isolation()["isolated"]
            fm.deactivate(tid)
            assert fm.check_isolation()["isolated"]
        assert not fm.active
        assert fm.find_partition(size, require_healthy=True) is not None

    def test_mixed_tenancy_churn_keeps_isolation(self):
        fm = FabricManager(B300)
        fm.activate("a", 4)
        fm.activate("b", 2)
        fm.activate("c", 2)
        assert fm.check_isolation()["isolated"]
        fm.deactivate("b")
        assert fm.check_isolation()["isolated"]
        d = fm.activate("d", 2)
        assert fm.check_isolation()["isolated"] and d.partition.size == 2

    @given(ops=st.lists(
        st.tuples(st.sampled_from(["activate", "deactivate"]),
                  st.sampled_from([1, 2, 4, 8])),
        min_size=1, max_size=40))
    @settings(max_examples=60, deadline=None)
    def test_no_device_ever_owned_by_two_active_tenants(self, ops):
        fm = FabricManager(B300)
        live: list[str] = []
        for i, (kind, size) in enumerate(ops):
            if kind == "activate":
                try:
                    fm.activate(f"t{i}", size)
                    live.append(f"t{i}")
                except RuntimeError:
                    pass
            elif live:
                fm.deactivate(live.pop(0))
            assert fm.check_isolation()["isolated"]
            owned = [d for t in fm.active.values()
                     for d in t.partition.device_ids]
            assert len(owned) == len(set(owned))
        for tid in live:
            fm.deactivate(tid)
        assert fm.find_partition(8, require_healthy=True) is not None


# ---------------------------------------------------------------------------------
# TP pricing model
# ---------------------------------------------------------------------------------

class TestTPComputeModel:
    def _cfg(self):
        return t_smoke(get_config("olmo-1b"))

    def test_tp_degree_must_be_positive(self):
        with pytest.raises(ValueError, match="tp_degree"):
            ComputeModel(self._cfg(), BridgeModel(TPU_V5E, cc_on=True),
                         tp_degree=0)

    def test_allreduce_zero_for_tp1_and_empty_batch(self):
        bridge = BridgeModel(TPU_V5E, cc_on=True)
        assert ComputeModel(self._cfg(), bridge).allreduce_bytes(4) == 0
        assert ComputeModel(self._cfg(), bridge,
                            tp_degree=4).allreduce_bytes(0) == 0

    def test_ring_allreduce_bytes_formula(self):
        cfg = self._cfg()
        cm = ComputeModel(cfg, BridgeModel(TPU_V5E, cc_on=True), tp_degree=4)
        payload = 2 * cfg.n_layers * 3 * cfg.d_model * cm.bytes_per_param
        assert cm.allreduce_bytes(3) == int(2 * 3 / 4 * payload)
        assert cm.allreduce_seconds(3, TPU_V5E.fabric_p2p_bw) == \
            pytest.approx(cm.allreduce_bytes(3) / TPU_V5E.fabric_p2p_bw)

    def test_per_device_step_divides_by_tp(self):
        cfg = get_config("nemotron-4-340b")
        bridge = BridgeModel(B300, cc_on=True)
        one = ComputeModel(cfg, bridge).decode_charge(8, kv_len=512)
        four = ComputeModel(cfg, bridge, tp_degree=4).decode_charge(
            8, kv_len=512)
        assert four.seconds == pytest.approx(one.seconds / 4)
        assert four.flops == pytest.approx(one.flops / 4)

    def test_340b_tp4_step_beats_tp1_even_with_allreduce(self):
        cfg = get_config("nemotron-4-340b")
        bridge = BridgeModel(B300, cc_on=True)
        tp1 = ComputeModel(cfg, bridge).decode_charge(8, kv_len=512)
        cm4 = ComputeModel(cfg, bridge, tp_degree=4)
        tp4 = (cm4.decode_charge(8, kv_len=512).seconds
               + cm4.allreduce_seconds(8, B300.fabric_p2p_bw))
        assert tp4 < tp1.seconds


# ---------------------------------------------------------------------------------
# KV migration rides P2P, never the bridge (the loader's shard exchange is
# in tests/test_torch_loader.py)
# ---------------------------------------------------------------------------------

class TestMigration:
    def test_kv_migrate_moves_blocks_over_fabric_only(self):
        gw = _gateway()
        mgr = OffloadManager(gw, OffloadPolicy.REUSE_AWARE,
                             store_threshold=1, block_bytes=4096)
        hashes = [hash(("p", i)) for i in range(3)]
        for h in hashes:
            mgr.observe(h)
            mgr.evict(h, payload_bytes=4096)
        with TraceRecorder(gw) as rec:
            assert mgr.migrate(hashes) == (3, 3 * 4096)
        assert mgr.stats.migrated_blocks == 3
        assert mgr.stats.migrated_bytes == 3 * 4096
        tape = rec.tape()
        assert tape.n_crossings() == 0 and tape.p2p_bytes() == 3 * 4096
        assert tape.op_class_mix().get(oc.P2P_KV_MIGRATE) == 1

    def test_migrate_unknown_hashes_is_free(self):
        gw = _gateway()
        mgr = OffloadManager(gw, OffloadPolicy.REUSE_AWARE,
                             store_threshold=1, block_bytes=4096)
        assert mgr.migrate([hash("nope")]) == (0, 0)
        assert gw.stats.p2p_crossings == 0


# ---------------------------------------------------------------------------------
# TP replica groups end to end
# ---------------------------------------------------------------------------------

def _serve(pkg, model, tp, *, seed=7, partition_size=4):
    cluster = pkg.cluster.build_cluster(
        model, cc_on=True, n_replicas=1, partition_size=partition_size,
        replica_cfg=pkg.cluster.ReplicaConfig(tp_degree=tp),
        routing=pkg.cluster.RoutingPolicy.LEAST_LOADED, seed=seed)
    for i in range(3):
        cluster.submit(pkg.Request(
            f"r{i}", prompt=list(range(1, 17)) + [30 + i],
            sampling=pkg.Sampling(max_new_tokens=4)))
    cluster.run()
    replica = cluster.replicas[0]
    out = dict(tokens={r.request_id: list(r.output_tokens)
                       for r in replica.engine.finished},
               tape=replica.tape(), stats=plain(replica.stats()),
               cluster_stats=plain(cluster.stats()))
    cluster.close()
    return out


J = types.SimpleNamespace(cluster=j_cluster, Request=JRequest,
                          Sampling=JSampling)
T = types.SimpleNamespace(cluster=t_cluster, Request=Request,
                          Sampling=SamplingParams)


@pytest.fixture(scope="module")
def reference_tp_runs(models):
    return {tp: _serve(J, models[0], tp, partition_size=8)
            for tp in TP_DEGREES}


@pytest.mark.parametrize("tp", TP_DEGREES)
def test_tp_cluster_is_the_references(models, reference_tp_runs, tp):
    """Tokens, tapes, ``stats()`` and ``cluster.stats()`` of a one-replica
    TP cluster equal the reference's, and tokens do not move with TP."""
    got = _serve(T, models[1], tp, partition_size=8)
    want = reference_tp_runs[tp]
    assert got["tokens"] == want["tokens"] == reference_tp_runs[1]["tokens"]
    assert got["tape"].meta.to_dict() == want["tape"].meta.to_dict()
    assert _records(got["tape"]) == _records(want["tape"])
    assert got["stats"] == want["stats"]
    assert got["cluster_stats"] == want["cluster_stats"]
    assert got["stats"]["tp_degree"] == tp
    assert (got["stats"]["p2p_bytes"] > 0) == (tp > 1)


class TestTPReplicaGroups:
    def test_tp4_tokens_byte_identical_to_tp1(self, tiny_model):
        one = _serve(T, tiny_model, 1)
        four = _serve(T, tiny_model, 4)
        assert one["tokens"] == four["tokens"] and one["tokens"]
        assert one["tape"].p2p_bytes() == 0
        assert four["tape"].p2p_bytes() > 0
        assert four["tape"].op_class_mix().get(oc.P2P_ALLREDUCE, 0) > 0
        assert four["stats"]["tp_degree"] == 4
        assert four["stats"]["p2p_bytes"] == four["tape"].p2p_bytes()
        assert four["tape"].bridge_bytes() == one["tape"].bridge_bytes()
        assert check_tape(four["tape"]).ok

    def test_allreduce_priced_at_fabric_rate(self, tiny_model):
        p2p = [r for r in _serve(T, tiny_model, 4)["tape"].records
               if r.is_p2p]
        assert p2p
        for r in p2p:
            assert r.duration_s == pytest.approx(
                r.nbytes / TPU_V5E.fabric_p2p_bw)
            assert oc.FABRIC_FALLBACK not in r.tags

    def test_stall_attribution_closes_with_p2p(self, tiny_model):
        from repro_torch.obs.stalls import CAUSE_P2P, attribute_stalls
        report = attribute_stalls(_serve(T, tiny_model, 4)["tape"])
        assert report.closure >= 0.99 and report.share(CAUSE_P2P) > 0

    def test_tp_must_fit_partition(self, tiny_model):
        with pytest.raises(ValueError, match="does not fit partition_size"):
            build_cluster(tiny_model, n_replicas=1, partition_size=2,
                          replica_cfg=ReplicaConfig(tp_degree=4))

    def test_replica_validates_tp_against_tenant(self, tiny_model):
        from repro_torch.cluster.budget import ContextLease
        from repro_torch.cluster.replica import Replica
        from repro_torch.cluster.tenant_manager import TenantManager
        tenant = TenantManager(TPU_V5E).provision("t0", 2)
        lease = ContextLease(lease_id=0, holder="replica-0", n_contexts=2)
        with pytest.raises(ValueError, match="does not fit"):
            Replica("replica-0", tiny_model, tenant, lease,
                    BridgeModel(TPU_V5E, cc_on=True),
                    ReplicaConfig(tp_degree=4))

    def test_unattested_replica_reprices_p2p_at_fallback(self, tiny_model):
        cluster = build_cluster(
            tiny_model, cc_on=True, n_replicas=1, partition_size=4,
            replica_cfg=ReplicaConfig(tp_degree=4),
            routing=RoutingPolicy.LEAST_LOADED, seed=7)
        replica = cluster.replicas[0]
        cluster.submit(Request("r0", prompt=list(range(1, 17)),
                               sampling=SamplingParams(max_new_tokens=3)))
        replica.attested = False
        while replica.pending():
            replica.tick()
        tape = replica.tape()
        p2p = [r for r in tape.records if r.is_p2p]
        assert p2p
        for r in p2p:
            assert oc.FABRIC_FALLBACK in r.tags
            assert r.duration_s == pytest.approx(
                r.nbytes / TPU_V5E.fabric_fallback_bw)
        assert replica.gateway.stats.p2p_fallback_crossings == len(p2p)
        assert check_tape(tape).ok
        cluster.close()


# ---------------------------------------------------------------------------------
# the engine's allreduce call sites against the reference's
# ---------------------------------------------------------------------------------

ENGINE_CASES = {
    "packed": dict(packed=True, bridge_opt=False, skew=None),
    "dense": dict(packed=False, bridge_opt=False, skew=None),
    "packed_bridge_opt_skew": dict(packed=True, bridge_opt=True,
                                   skew=(0.0, 2e-6, 1e-6, 5e-6)),
    "dense_bridge_opt": dict(packed=False, bridge_opt=True, skew=None),
}


def _engine_run(pkg, model, case, tp):
    """A standalone engine with a TP compute model (so the cold prefill's
    allreduce is charged too: no cluster prices the prompt)."""
    bridge = pkg.Bridge(pkg.V5E, cc_on=True)
    defaults = dataclasses.replace(
        pkg.defaults(True, bridge_opt=case["bridge_opt"]),
        packed_decode=case["packed"])
    skew = case["skew"][:tp] if case["skew"] and tp > 1 else None
    compute = pkg.Compute(model.cfg, bridge, tp_degree=tp, skew=skew)
    kw = {"device": "cpu"} if pkg.port else {}
    engine = pkg.Engine(model, max_batch=4, max_len=48,
                        policy=pkg.Policy.SYNC_DRAIN, bridge=bridge,
                        defaults=defaults, compute_model=compute, seed=0,
                        **kw)
    for i in range(6):
        engine.submit(pkg.Request(
            f"r{i}", prompt=[1, 2, 3 + i % 5] + [7] * i,
            sampling=pkg.Sampling(max_new_tokens=2 + i % 4)))
    recorder = pkg.Recorder(engine.gateway, label="tp-engine").attach()
    try:
        stats = engine.run()
    finally:
        recorder.detach()
        engine.close()
    tokens = {r.request_id: list(r.output_tokens) for r in engine.finished}
    return tokens, recorder.tape(), plain(stats)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_allreduce_is_the_references(models, case, tp):
    from repro.trace import TraceRecorder as JRecorder
    j = types.SimpleNamespace(
        Bridge=JBridge, V5E=J_TPU_V5E, defaults=j_defaults, Compute=JCompute,
        Engine=JEngine, Policy=JPolicy, Request=JRequest,
        Sampling=JSampling, Recorder=JRecorder, port=False)
    t = types.SimpleNamespace(
        Bridge=BridgeModel, V5E=TPU_V5E, defaults=cc_aware_defaults,
        Compute=ComputeModel, Engine=ServingEngine, Policy=SchedulingPolicy,
        Request=Request, Sampling=SamplingParams, Recorder=TraceRecorder,
        port=True)
    jtok, jtape, jstats = _engine_run(j, models[0], ENGINE_CASES[case], tp)
    ttok, ttape, tstats = _engine_run(t, models[1], ENGINE_CASES[case], tp)
    assert ttok == jtok
    assert _records(ttape) == _records(jtape)
    assert tstats == jstats
    mix = ttape.op_class_mix()
    steps = sum(mix.get(c, 0) for c in (oc.DECODE_PACKED, oc.DECODE_COMPUTE,
                                        oc.DECODE_MASKED))
    # one allreduce per cold prefill and per decode step
    assert mix[oc.P2P_ALLREDUCE] == 6 + steps
    assert check_tape(ttape).ok


# ---------------------------------------------------------------------------------
# replay: the fabric_up lever
# ---------------------------------------------------------------------------------

class TestReplayFabricLever:
    def _tape_with_p2p(self, *, down=False):
        gw = _gateway()
        if down:
            t = FabricManager(TPU_V5E).activate("t", 2)
            t.fabric_state = FabricState.STALE
            gw.fabric = FabricTransport(TPU_V5E, t)
        with TraceRecorder(gw) as rec:
            gw.p2p(32 << 20, op_class=oc.P2P_ALLREDUCE)
        return rec.tape()

    @pytest.mark.parametrize("down", [False, True])
    def test_as_recorded_replay_respects_fallback_tag(self, down):
        bw = TPU_V5E.fabric_fallback_bw if down else TPU_V5E.fabric_p2p_bw
        got = TraceReplayer(self._tape_with_p2p(down=down)).reprice(
            ReplaySpec())
        assert got.total_replayed_s == pytest.approx((32 << 20) / bw)

    def test_forcing_fabric_down_reprices_same_bytes(self):
        tape = self._tape_with_p2p()
        up = TraceReplayer(tape).reprice(ReplaySpec(fabric_up=True))
        down = TraceReplayer(tape).reprice(ReplaySpec(fabric_up=False))
        assert down.total_replayed_s == pytest.approx(
            up.total_replayed_s * TPU_V5E.fabric_p2p_bw
            / TPU_V5E.fabric_fallback_bw)

    @pytest.mark.parametrize("profile,bw", [
        ("b300-hgx", B300.fabric_p2p_bw),
        ("rtx-pro-6000", RTX_PRO_6000.fabric_fallback_bw)])
    def test_cross_profile_replay_uses_target_fabric(self, profile, bw):
        got = TraceReplayer(self._tape_with_p2p()).reprice(
            ReplaySpec(profile=profile))
        assert got.total_replayed_s == pytest.approx((32 << 20) / bw)

    def test_p2p_bandwidth_fallback_constant(self):
        assert p2p_bandwidth(TPU_V5E, fabric_up=False) == \
            TPU_V5E.fabric_fallback_bw
