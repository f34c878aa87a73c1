"""The port's resilience layer against the reference.

``unit_draw``, ``RetryPolicy``, ``RetryBudget``, ``DegradationLadder`` and
``FaultInjector`` give the reference's values, draws, tape records and
stats on the cases of ``tests/test_resilience.py`` and on seeded call
sequences.  The chaos invariant holds on the port's cluster (smoke
olmo-1b) over seeds {3, 5, 9} at rate 0.15: tokens byte-identical to the
fault-free run and to the reference cluster's (shared weights), with the
reference's tapes and fault stats.  Faulted tapes obey the bridge law and
close their stall attribution; attestation expiry quarantines and then
reattests; the ladder on and off give equal tokens; the engine's ladder
hooks and the offload manager's restore redos behave as the reference's.
"""

import dataclasses
import enum
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

import repro.cluster as j_cluster
import repro.resilience as j_res
from repro.configs.base import all_configs, smoke_config
from repro.core.bridge import (TPU_V5E as J_TPU_V5E, BridgeModel as JBridge,
                               Crossing as JCrossing,
                               Direction as JDirection,
                               StagingKind as JStaging)
from repro.core.gateway import TransferGateway as JGateway
from repro.core.policy import OffloadPolicy as JOffloadPolicy
from repro.core.policy import cc_aware_defaults as j_defaults
from repro.models.model import Model as JModel
from repro.serving.engine import Request as JRequest
from repro.serving.offload import OffloadManager as JOffload
from repro.serving.sampler import SamplingParams as JSampling
from repro.trace import opclasses as oc

import repro_torch.cluster as t_cluster
import repro_torch.resilience as t_res
from repro_torch.configs.base import get_config, smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.bridge import (TPU_V5E, BridgeModel, Crossing,
                                     Direction, StagingKind)
from repro_torch.core.gateway import TransferGateway
from repro_torch.core.policy import OffloadPolicy, cc_aware_defaults
from repro_torch.models.model import Model
from repro_torch.obs import attribute_stalls
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.offload import OffloadManager
from repro_torch.serving.sampler import SamplingParams
from repro_torch.trace import check_tape

torch.set_num_threads(1)

J = types.SimpleNamespace(
    res=j_res, cluster=j_cluster, Bridge=JBridge, Crossing=JCrossing,
    Direction=JDirection, Staging=JStaging, Gateway=JGateway,
    defaults=j_defaults, TPU_V5E=J_TPU_V5E, Request=JRequest,
    Sampling=JSampling, Offload=JOffload, OffloadPolicy=JOffloadPolicy)
T = types.SimpleNamespace(
    res=t_res, cluster=t_cluster, Bridge=BridgeModel, Crossing=Crossing,
    Direction=Direction, Staging=StagingKind, Gateway=TransferGateway,
    defaults=cc_aware_defaults, TPU_V5E=TPU_V5E, Request=Request,
    Sampling=SamplingParams, Offload=OffloadManager,
    OffloadPolicy=OffloadPolicy)


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


# ---------------------------------------------------------------------------------
# draws, retry policy, budget, ladder
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 3, 5, 7, 9, 11])
def test_unit_draw_is_the_references(seed):
    streams = ("fail:prompt_h2d", "jitter:drain_d2h", "teardown:x",
               "restore_corrupt", "s")
    got = [t_res.unit_draw(seed, s, n) for s in streams for n in range(64)]
    want = [j_res.unit_draw(seed, s, n) for s in streams for n in range(64)]
    assert got == want
    assert all(0.0 <= u < 1.0 for u in got)
    assert len(set(got)) == len(got)


@pytest.mark.parametrize("policy", [
    dict(),
    dict(backoff_base_s=1e-3, backoff_multiplier=2.0, jitter_frac=0.0),
    dict(backoff_base_s=1e-3, jitter_frac=0.25),
    dict(backoff_base_s=1e-3, jitter_frac=5.0),
    dict(max_attempts=3, backoff_base_s=500e-6, timeout_s=5.0),
])
def test_retry_policy_backoff_is_the_references(policy):
    tp, jp = t_res.RetryPolicy(**policy), j_res.RetryPolicy(**policy)
    for attempt in range(6):
        for unit in (0.0, 0.1, 0.5, 0.9, 1.0):
            assert tp.backoff_s(attempt, unit) == jp.backoff_s(attempt, unit)
    assert tp.backoff_s(0, 0.5) >= 0.0
    assert plain(t_res.DEFAULT_POLICIES) == plain(j_res.DEFAULT_POLICIES)
    assert plain(t_res.DEFAULT_POLICY) == plain(j_res.DEFAULT_POLICY)


@pytest.mark.parametrize("window", [1, 3, 8])
def test_retry_budget_is_the_references(window):
    tb, jb = t_res.RetryBudget(window), j_res.RetryBudget(window)
    assert [tb.consume() for _ in range(20)] == [jb.consume()
                                                 for _ in range(20)]
    assert (tb.consumed_total, tb.escalations) == (jb.consumed_total,
                                                   jb.escalations)
    with pytest.raises(ValueError):
        t_res.RetryBudget(events_per_escalation=0)


def _ladder_script(pkg, seed: int, enabled: bool):
    """A seeded sequence of escalations, faults and recovery checks."""
    rng = np.random.default_rng(seed)
    lad = pkg.res.DegradationLadder(enabled=enabled, recovery_quiet_s=0.1)
    t, out = 0.0, []
    for _ in range(60):
        t += float(rng.uniform(0.0, 0.08))
        op = int(rng.integers(3))
        if op == 0:
            out.append(("escalate", lad.escalate(t)))
        elif op == 1:
            lad.observe_fault(t)
        else:
            out.append(("recover", lad.maybe_recover(t)))
        out.append((lad.level, lad.sync_restore_forced,
                    lad.coalescer_bypassed, lad.dense_step_forced,
                    lad.degraded_s(t)))
    return out, plain(lad.transitions), lad.escalations_requested


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("enabled", [True, False])
def test_ladder_is_the_references(seed, enabled):
    got = _ladder_script(T, seed, enabled)
    assert got == _ladder_script(J, seed, enabled)
    if not enabled:
        assert got[1] == []


def test_ladder_cases_of_the_reference():
    lad = t_res.DegradationLadder(recovery_quiet_s=0.1)
    lad.escalate(0.0)
    lad.escalate(0.0)
    lad.observe_fault(0.0)
    assert not lad.maybe_recover(0.05)
    assert lad.maybe_recover(0.15)
    assert lad.level == t_res.RUNG_SYNC_RESTORE
    assert not lad.maybe_recover(0.16)
    assert lad.maybe_recover(0.30)
    assert lad.level == t_res.RUNG_NONE
    assert t_res.RUNG_NAMES == j_res.RUNG_NAMES
    assert t_res.REATTEST_SECONDS == j_res.REATTEST_SECONDS


# ---------------------------------------------------------------------------------
# the fault injector on a gateway
# ---------------------------------------------------------------------------------

def _gateway(pkg):
    kw = {"device": "cpu"} if pkg is T else {}
    return pkg.Gateway(pkg.Bridge(pkg.TPU_V5E, cc_on=True),
                       pkg.defaults(True), pool_workers=2, **kw)


def _crossing(pkg, nbytes=4096):
    return pkg.Crossing(nbytes, pkg.Direction.H2D, pkg.Staging.REGISTERED)


def _case_retries_capped(pkg):
    gw = _gateway(pkg)
    inj = pkg.res.FaultInjector(
        pkg.res.FaultPlan(seed=1, crossing_failure_p=1.0)).attach(gw)
    gw.charge_crossing(4096, pkg.Direction.H2D, op_class=oc.PROMPT_H2D)
    assert inj.stats.crossing_failures == \
        inj.policy_for(oc.PROMPT_H2D).max_attempts - 1
    return gw, inj, None


def _case_transient_sequence(pkg):
    gw = _gateway(pkg)
    inj = pkg.res.FaultInjector(
        pkg.res.FaultPlan.transient(seed=9, rate=0.4)).attach(gw)
    for i in range(32):
        gw.charge_crossing(1024 + i, pkg.Direction.H2D,
                           op_class=oc.PROMPT_H2D)
    return gw, inj, None


def _case_fused_decomposes(pkg):
    gw = _gateway(pkg)
    inj = pkg.res.FaultInjector(
        pkg.res.FaultPlan(seed=2, crossing_failure_p=1.0)).attach(gw)
    c = _crossing(pkg, 8192)
    cost = gw.bridge.crossing_time(c, n_contexts=1)
    out = inj.on_crossing(oc.COALESCED_H2D, c, cost, n_units=4)
    assert inj.stats.decompositions == 1
    return gw, inj, out


def _case_single_unit(pkg):
    gw = _gateway(pkg)
    inj = pkg.res.FaultInjector(
        pkg.res.FaultPlan(seed=2, crossing_failure_p=1.0)).attach(gw)
    c = _crossing(pkg)
    out = inj.on_crossing(oc.PROMPT_H2D, c,
                          gw.bridge.crossing_time(c, n_contexts=1))
    assert inj.stats.decompositions == 0
    return gw, inj, out


def _case_teardown(pkg):
    gw = _gateway(pkg)
    inj = pkg.res.FaultInjector(
        pkg.res.FaultPlan(seed=3, teardown_p=1.0)).attach(gw)
    gw.charge_crossing(4096, pkg.Direction.H2D, op_class=oc.PROMPT_H2D)
    p = gw.bridge.profile
    assert inj.stats.reestablish_s == p.context_create + p.pinned_slot_alloc
    assert any(r.op_class == oc.CHAN_REESTABLISH for r in gw.records)
    return gw, inj, None


def _case_restore_cap(pkg):
    gw = _gateway(pkg)
    inj = pkg.res.FaultInjector(
        pkg.res.FaultPlan(seed=4, restore_corruption_p=1.0)).attach(gw)
    n = inj.policy_for(oc.KV_RESTORE_H2D).max_attempts
    out = [inj.restore_corrupted(a) for a in range(n)]
    assert out == [True] * (n - 1) + [False]
    return gw, inj, out


def _case_brownout(pkg):
    gw = _gateway(pkg)
    plan = pkg.res.FaultPlan(seed=5, brownouts=(
        pkg.res.BrownoutWindow(t_start=0.0, t_end=1e9, factor=3.0),))
    inj = pkg.res.FaultInjector(plan).attach(gw)
    c = _crossing(pkg)
    base = gw.bridge.crossing_time(c, n_contexts=1)
    out = inj.on_crossing(oc.PROMPT_H2D, c, base)
    assert out == pytest.approx(3.0 * base)
    return gw, inj, out


def _case_reattest(pkg):
    gw = _gateway(pkg)
    inj = pkg.res.FaultInjector(
        pkg.res.FaultPlan(seed=6, attestation_ttl_s=1.0)).attach(gw)
    due = (inj.reattest_due(0.5, attested_at=0.0),
           inj.reattest_due(1.5, attested_at=0.0))
    assert due == (False, True)
    inj.charge_reattest()
    assert any(r.op_class == oc.REATTEST for r in gw.records)
    return gw, inj, due


def _case_escalation(pkg):
    gw = _gateway(pkg)
    inj = pkg.res.FaultInjector(
        pkg.res.FaultPlan(seed=7, crossing_failure_p=1.0),
        budget=pkg.res.RetryBudget(events_per_escalation=2)).attach(gw)
    gw.charge_crossing(4096, pkg.Direction.H2D, op_class=oc.PROMPT_H2D)
    assert inj.ladder.level >= 1
    return gw, inj, None


def _case_mixed_paths(pkg):
    """Every charged gateway path under a dense transient plan."""
    gw = _gateway(pkg)
    inj = pkg.res.FaultInjector(pkg.res.FaultPlan(
        seed=13, crossing_failure_p=0.35, teardown_p=0.2,
        restore_corruption_p=0.5)).attach(gw)
    rng = np.random.default_rng(0)
    for i in range(12):
        arr = rng.integers(0, 100, (1, 8 + i), dtype=np.int32)
        gw.h2d(arr, op_class=oc.PROMPT_H2D)
        dev = torch.from_numpy(arr) if pkg is T else jax.numpy.asarray(arr)
        gw.d2h(dev, op_class=oc.DRAIN_D2H)
        gw.batch_h2d([arr, arr[:, :2]], op_class=oc.PREP_BATCHED_H2D)
        gw.charge_crossing(4096 * (i + 1), pkg.Direction.H2D,
                           op_class=oc.COALESCED_H2D,
                           sources=((oc.PREP_BATCHED_H2D, 4096),) * (1 + i % 4))
        inj.restore_corrupted(i % 3)
    return gw, inj, None


INJECTOR_CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_retries_capped, _case_transient_sequence, _case_fused_decomposes,
    _case_single_unit, _case_teardown, _case_restore_cap, _case_brownout,
    _case_reattest, _case_escalation, _case_mixed_paths)}


@pytest.mark.parametrize("case", list(INJECTOR_CASES))
def test_fault_injector_is_the_references(case):
    """The same calls through both packages' gateways and injectors give
    the same records, stats, clock, ladder and return values."""
    fn = INJECTOR_CASES[case]
    (tgw, tinj, tout), (jgw, jinj, jout) = fn(T), fn(J)
    assert plain(tgw.records) == plain(jgw.records)
    assert tinj.stats.snapshot() == jinj.stats.snapshot()
    assert tgw.clock.now == jgw.clock.now
    assert (tinj.ladder.level, plain(tinj.ladder.transitions)) == \
        (jinj.ladder.level, plain(jinj.ladder.transitions))
    assert plain(tout) == plain(jout)
    assert tgw.faults is tinj and tinj.gateway is tgw


def test_transient_plan_shape():
    plan = t_res.FaultPlan.transient(seed=5, rate=0.16)
    assert plan == t_res.FaultPlan(seed=5, crossing_failure_p=0.16,
                                   teardown_p=0.01,
                                   restore_corruption_p=0.16)
    assert plan.any_faults() and not t_res.FaultPlan(seed=5).any_faults()


# ---------------------------------------------------------------------------------
# the chaos invariant on the port's cluster, against the reference's
# ---------------------------------------------------------------------------------

#: shared prefix (2 full blocks at block_tokens=8), the warm-restore unit
PREFIX = list(range(1, 17))
CHAOS_SEEDS = (3, 5, 9)


@pytest.fixture(scope="module")
def models():
    """The reference's smoke olmo-1b with every engine drawing the same
    weights (seed 0), and the port's model holding them."""
    jcfg = smoke_config(all_configs()["olmo-1b"])
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jmodel.init = lambda key: jparams
    tcfg = t_smoke(get_config("olmo-1b"))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return jmodel, Model(tcfg, params=tparams, device="cpu")


def serve(pkg, model, plan, *, ladder_enabled=True):
    """The reference test's two-wave, two-replica run; returns tokens,
    stats, tapes, fault snapshots and replicas' health."""
    cluster = pkg.cluster.build_cluster(
        model, n_replicas=2, fault_plan=plan,
        replica_cfg=pkg.cluster.ReplicaConfig(max_batch=2, max_len=64),
        seed=0)
    if not ladder_enabled:
        for r in cluster.replicas:
            if r.faults is not None:
                r.faults.ladder = pkg.res.DegradationLadder(enabled=False)
    submitted = 0
    for wave in range(2):
        for i in range(4):
            assert cluster.submit(pkg.Request(
                f"w{wave}r{i}", prompt=PREFIX + [40 + 4 * wave + i] * 8,
                sampling=pkg.Sampling(max_new_tokens=3))) is not None
            submitted += 1
        cluster.run()
    stats = cluster.stats()
    tokens = {e["request"].request_id: tuple(e["request"].output_tokens)
              for e in cluster.request_log}
    tapes = [r.tape() for r in cluster.replicas]
    faults = [r.faults.stats.snapshot() for r in cluster.replicas
              if r.faults is not None]
    cluster.close()
    assert stats["finished"] == submitted, "request lost or hung"
    return dict(tokens=tokens, stats=stats, tapes=tapes, faults=faults)


@pytest.fixture(scope="module")
def baseline(models):
    return serve(T, models[1], None)


@pytest.fixture(scope="module")
def reference_runs(models):
    """The reference cluster fault-free and at each chaos seed."""
    runs = {None: serve(J, models[0], None)}
    for seed in CHAOS_SEEDS:
        runs[seed] = serve(J, models[0],
                           j_res.FaultPlan.transient(seed=seed, rate=0.15))
    return runs


def test_fault_free_cluster_is_the_references(models, baseline,
                                              reference_runs):
    ref = reference_runs[None]
    assert baseline["tokens"] == ref["tokens"]
    for tt, jt in zip(baseline["tapes"], ref["tapes"]):
        assert [r.to_dict() for r in tt.records] == \
            [r.to_dict() for r in jt.records]


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_chaos_invariant_over_seeded_schedules(models, baseline,
                                               reference_runs, seed):
    """Faults only move the clock: tokens byte-identical to the fault-free
    run, and tokens, tapes and fault stats equal to the reference's."""
    run = serve(T, models[1], t_res.FaultPlan.transient(seed=seed,
                                                        rate=0.15))
    assert sum(f["injected_events"] for f in run["faults"]) > 0, \
        f"seed {seed}: the schedule injected nothing"
    assert run["tokens"] == baseline["tokens"], \
        f"seed {seed}: faults moved data, not just the clock"
    ref = reference_runs[seed]
    assert run["tokens"] == ref["tokens"]
    assert run["faults"] == ref["faults"]
    assert run["stats"]["makespan_s"] == ref["stats"]["makespan_s"]
    for tt, jt in zip(run["tapes"], ref["tapes"]):
        assert [r.to_dict() for r in tt.records] == \
            [r.to_dict() for r in jt.records]


def test_faulted_tapes_conserve_and_attribute(models):
    plan = t_res.FaultPlan(seed=5, crossing_failure_p=0.4, teardown_p=0.3,
                           restore_corruption_p=0.4)
    run = serve(T, models[1], plan)
    assert sum(f["reestablishments"] for f in run["faults"]) > 0
    records = [r for t in run["tapes"] for r in t.records]
    assert any(oc.RETRY in r.tags for r in records)
    assert any(r.op_class == oc.CHAN_REESTABLISH for r in records)
    for tape in run["tapes"]:
        assert check_tape(tape).ok, "faulted tape violates the bridge law"
        report = attribute_stalls(tape)
        assert report.closure >= 0.99, report.format()


def test_attestation_expiry_quarantines_then_reattests(models, baseline):
    run = serve(T, models[1], t_res.FaultPlan(seed=1, attestation_ttl_s=0.05))
    assert sum(s["reattests"] for s in run["stats"]["replicas"]) > 0
    assert sum(s["quarantines"] for s in run["stats"]["replicas"]) > 0
    assert any(r.op_class == oc.REATTEST
               for t in run["tapes"] for r in t.records)
    assert all(h == "healthy" for h in run["stats"]["health"].values())
    assert run["tokens"] == baseline["tokens"]


def test_ladder_never_changes_tokens(models, baseline):
    plan = t_res.FaultPlan.transient(seed=7, rate=0.3)
    on = serve(T, models[1], plan)
    off = serve(T, models[1], plan, ladder_enabled=False)
    assert on["tokens"] == off["tokens"] == baseline["tokens"]


# ---------------------------------------------------------------------------------
# the engine's ladder hooks and the offload manager's restore redos
# ---------------------------------------------------------------------------------

def test_engine_runs_dense_and_degraded_at_the_top_rung(models):
    """With the ladder pinned at its last rung every step is dense, every
    compute charge carries DEGRADED and tokens match the fault-free run."""
    model = models[1]

    def run(ladder_level):
        engine = ServingEngine(model, max_batch=2, max_len=48, cc_on=True,
                               seed=0, device="cpu")
        if ladder_level is not None:
            inj = t_res.FaultInjector(t_res.FaultPlan(seed=0)).attach(
                engine.gateway)
            inj.ladder.recovery_quiet_s = 1e9
            for _ in range(ladder_level):
                inj.ladder.escalate(0.0)
            inj.ladder.observe_fault(0.0)
        for i in range(3):
            engine.submit(Request(f"r{i}", prompt=[5, 6, 7 + i],
                                  sampling=SamplingParams(max_new_tokens=4)))
        engine.run()
        engine.close()
        return engine

    free, top = run(None), run(t_res.RUNG_DENSE_STEP)
    assert {r.request_id: r.output_tokens for r in free.finished} == \
        {r.request_id: r.output_tokens for r in top.finished}
    assert all(s.packed > 0 for s in free.trace)
    assert all(s.packed == 0 for s in top.trace)
    compute = [r for r in top.gateway.records if r.kind == "compute"]
    assert compute and all(
        oc.DEGRADED in r.tags for r in compute
        if r.op_class != oc.PREFILL_COMPUTE)
    assert not any(oc.DEGRADED in r.tags for r in free.gateway.records)


def _restore_case(pkg, payloads, *, plan, forced):
    """Spill ``payloads`` and restore them pipelined (4 contexts) with a
    fault plan on the gateway, the ladder at level 0 or forced to the
    sync-restore rung."""
    kw = {"device": "cpu"} if pkg is T else {}
    gw = pkg.Gateway(pkg.Bridge(pkg.TPU_V5E, cc_on=True),
                     pkg.defaults(True), pool_workers=4, **kw)
    mgr = pkg.Offload(gw, pkg.OffloadPolicy.REUSE_AWARE, store_threshold=1,
                      pipelined_restore=True,
                      restore_chunk_bytes=2 * payloads[0].nbytes)
    hashes = list(range(len(payloads)))
    for h, p in zip(hashes, payloads):
        mgr.observe(h)
        if pkg is T:
            assert mgr.evict(h, payload=p)
        else:
            assert mgr.evict(h, payload=np.asarray(p.view(torch.int16)))
    inj = None
    if plan is not None:
        inj = pkg.res.FaultInjector(plan).attach(gw)
        if forced:
            inj.ladder.escalate(gw.clock.now)
    hits = mgr.restore(hashes, key="r0")
    return mgr, gw, inj, hits


def _expected_redos(seed: int, p: float) -> int:
    """Redos of one restore: the leading restore-corruption draws below
    ``p``, capped by the restore policy (the last verify is forced clean)."""
    cap = t_res.DEFAULT_POLICIES[oc.KV_RESTORE_H2D].max_attempts - 1
    n = 0
    while n < cap and t_res.unit_draw(seed, "restore_corrupt", n) < p:
        n += 1
    return n


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("seed", [1, 4])
def test_restore_redos_match_the_reference_and_keep_the_data(seed, forced):
    gen = torch.Generator().manual_seed(0)
    payloads = [torch.randn(2, 2, 16, 4, 8, generator=gen).to(torch.bfloat16)
                for _ in range(6)]
    plan = dict(seed=seed, restore_corruption_p=0.5)
    clean, _, _, _ = _restore_case(T, payloads, plan=None, forced=False)
    mgr, gw, inj, hits = _restore_case(T, payloads,
                                       plan=t_res.FaultPlan(**plan),
                                       forced=forced)
    jmgr, jgw, jinj, jhits = _restore_case(J, payloads,
                                           plan=j_res.FaultPlan(**plan),
                                           forced=forced)
    assert hits == jhits
    assert mgr.stats.restore_retries == _expected_redos(seed, 0.5)
    assert _expected_redos(1, 0.5) == 2     # seed 1 exercises the redos
    assert plain(mgr.stats) == plain(jmgr.stats)
    assert mgr.stats.sync_restores_forced == (1 if forced else 0)
    assert mgr.stats.pipelined_restores == (0 if forced else 1)
    assert inj.stats.snapshot() == jinj.stats.snapshot()
    assert plain(gw.records) == plain(jgw.records)
    retries = [r for r in gw.records if oc.RETRY in r.tags]
    assert len(retries) == mgr.stats.restore_retries
    assert all(r.op_class == oc.KV_RESTORE_H2D for r in retries)
    for h, p in enumerate(payloads):
        assert torch.equal(mgr.restored[h], p)
        assert torch.equal(mgr.restored[h], clean.restored[h])
