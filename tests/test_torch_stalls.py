"""The port's stall attribution and timeline export against the reference.

``attribute_stalls`` gives the reference's ``StallReport`` (its dict
within 1e-12, its intervals and its table) on the three golden tapes and on
tapes the port records under faults, with the coalescer and with restores
in flight; ``ladder_table`` prints the same table; ``export_timeline`` and
``tape_to_trace_events`` give the same Chrome-trace JSON for the same tape,
request spans included.
"""

import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import repro.obs as j_obs
from repro.trace.tape import BridgeTape as JTape

import repro_torch.obs as t_obs
from repro_torch.cluster import ReplicaConfig, RoutingPolicy, build_cluster
from repro_torch.configs.base import get_config, smoke_config
from repro_torch.core.bridge import B300, BridgeModel
from repro_torch.core.policy import cc_aware_defaults
from repro_torch.models.model import Model
from repro_torch.resilience import FaultPlan
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.sampler import SamplingParams
from repro_torch.trace import TraceRecorder
from repro_torch.trace.tape import BridgeTape

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_TAPES = ("tape_sync.json", "tape_async.json", "tape_worker.json")
TOL = 1e-12


def _as_reference(tape: BridgeTape) -> JTape:
    return JTape.from_dict(json.loads(json.dumps(tape.to_dict())))


def _close_dicts(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            _close_dicts(g, w)
        elif isinstance(w, float):
            assert abs(g - w) <= TOL * max(1.0, abs(w)), (key, g, w)
        else:
            assert g == w, key


def _same_report(tape: BridgeTape) -> t_obs.StallReport:
    got = t_obs.attribute_stalls(tape)
    want = j_obs.attribute_stalls(_as_reference(tape))
    _close_dicts(got.to_dict(), want.to_dict())
    assert [dataclasses.astuple(i) for i in got.intervals] == \
        [dataclasses.astuple(i) for i in want.intervals]
    assert got.format() == want.format()
    assert abs(sum(got.causes.values()) - got.gap_s) < 1e-9
    return got


@pytest.fixture(scope="module")
def model():
    return Model(smoke_config(get_config("olmo-1b")), seed=0, device="cpu")


@pytest.fixture(scope="module")
def faulted_tapes(model):
    """Replica tapes of a two-wave cluster run under every fault class the
    replicas answer (MAC rejects, teardown, restore corruption, attestation
    expiry), with the coalescer on; least-loaded routing, so both
    replicas serve."""
    plan = FaultPlan(seed=5, crossing_failure_p=0.4, teardown_p=0.3,
                     restore_corruption_p=0.4, attestation_ttl_s=0.05)
    cluster = build_cluster(
        model, n_replicas=2, fault_plan=plan,
        routing=RoutingPolicy.LEAST_LOADED,
        replica_cfg=ReplicaConfig(max_batch=2, max_len=64,
                                  coalesce_small_crossings=True), seed=0)
    for wave in range(2):
        for i in range(4):
            cluster.submit(Request(
                f"w{wave}r{i}", prompt=list(range(1, 17)) + [40 + i] * 8,
                sampling=SamplingParams(max_new_tokens=3)))
        cluster.run()
    tapes = [r.tape() for r in cluster.replicas]
    cluster.close()
    return tapes


@pytest.fixture(scope="module")
def engine_run(model):
    """A coalesced engine run with spans on; its tape and its spans."""
    defaults = dataclasses.replace(
        cc_aware_defaults(True, concurrency=4),
        coalesce_small_crossings=True, observability=True)
    engine = ServingEngine(model, max_batch=4, max_len=48,
                           bridge=BridgeModel(B300, cc_on=True),
                           defaults=defaults, seed=0, device="cpu")
    rec = TraceRecorder(engine.gateway, policy="sync", label="spans").attach()
    for i in range(5):
        engine.submit(Request(f"r{i}", prompt=[3, 4, 5 + i],
                              sampling=SamplingParams(max_new_tokens=3 + i)))
    engine.run()
    engine.close()
    return rec.tape(), engine.obs.spans


@pytest.mark.parametrize("name", GOLDEN_TAPES)
def test_golden_tapes_attribute_as_the_reference(name):
    tape = BridgeTape.load(os.path.join(GOLDEN_DIR, name))
    report = _same_report(tape)
    assert report.closure >= 0.99


@pytest.mark.parametrize("replica", [0, 1])
def test_faulted_tapes_attribute_as_the_reference(faulted_tapes, replica):
    tape = faulted_tapes[replica]
    assert tape.records
    report = _same_report(tape)
    assert report.closure >= 0.99, report.format()


def test_faulted_tapes_carry_the_recovery_causes(faulted_tapes):
    causes = {}
    for tape in faulted_tapes:
        for cause, s in t_obs.attribute_stalls(tape).causes.items():
            causes[cause] = causes.get(cause, 0.0) + s
    assert causes.get(t_obs.CAUSE_RETRY, 0.0) > 0
    assert causes.get(t_obs.CAUSE_REESTABLISH, 0.0) > 0
    assert causes.get(t_obs.CAUSE_REATTEST, 0.0) > 0


def test_engine_tape_attributes_as_the_reference(engine_run):
    _same_report(engine_run[0])


def test_ladder_table_is_the_references(faulted_tapes):
    names = [os.path.join(GOLDEN_DIR, n) for n in GOLDEN_TAPES]
    tapes = [BridgeTape.load(p) for p in names] + list(faulted_tapes)
    labels = [f"t{i}" for i in range(len(tapes))]
    got = t_obs.ladder_table({l: t_obs.attribute_stalls(t)
                              for l, t in zip(labels, tapes)})
    want = j_obs.ladder_table({l: j_obs.attribute_stalls(_as_reference(t))
                               for l, t in zip(labels, tapes)})
    assert got == want
    assert t_obs.CAUSES == j_obs.CAUSES


@pytest.mark.parametrize("which", GOLDEN_TAPES + ("faulted", "engine"))
def test_timeline_is_the_references(which, faulted_tapes, engine_run,
                                    tmp_path):
    if which == "faulted":
        tape = faulted_tapes[0]
    elif which == "engine":
        tape = engine_run[0]
    else:
        tape = BridgeTape.load(os.path.join(GOLDEN_DIR, which))
    path = tmp_path / "trace.json"
    got = t_obs.export_timeline(tape, str(path))
    want = j_obs.export_timeline(_as_reference(tape))
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(want))
    assert got["traceEvents"]


def test_timeline_with_spans_is_the_references(engine_run):
    tape, spans = engine_run
    got = t_obs.tape_to_trace_events(tape, spans=spans)
    want = j_obs.tape_to_trace_events(_as_reference(tape), spans=spans)
    assert got == want
    assert any(ev["ph"] == "i" and "first_token" in ev["name"] for ev in got)
