"""The port's decode-step simulator against the reference.

The reference's own cases (``tests/test_simulator.py``: the paper tables
and the structural properties) run on the port's simulator; then the same
inputs go through both packages and every float that comes out must be
equal, bit for bit: the paper's 54 serving cells (``simulate_matrix`` over
``benchmarks/workloads.py``'s c=128 table, concurrency sweep and serving
matrix), the H200 boundary, ``fit_workload`` with and without a config,
``roofline_workload`` on qwen3p6-27b, and the microbenchmark curves.  The
reference's workloads are rebuilt as the port's ``ServingWorkload`` field
by field.
"""

import dataclasses

import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="property tests need hypothesis")
import hypothesis.strategies as st
from hypothesis import given, settings

from benchmarks import workloads as W
from repro.configs.base import all_configs
from repro.core import bridge as JB
from repro.core import simulator as JS
from repro.core.policy import SchedulingPolicy as JSP
from repro_torch.configs.base import get_config
from repro_torch.core import simulator as TS
from repro_torch.core.bridge import B300, H200, PROFILES, BridgeModel, Direction
from repro_torch.core.policy import (PolicyOutcome, SchedulingPolicy as SP,
                                     cc_aware_defaults, detect_inversion)
from repro_torch.core.simulator import (Observation, ServingWorkload,
                                        fit_workload, tokens_per_s, tpot_ms)


# ---------------------------------------------------------------------------------
# the reference's cases, on the port
# ---------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen_c128():
    obs = [
        Observation(SP.ASYNC_OVERLAP, False, tpot_ms=23.64),
        Observation(SP.ASYNC_OVERLAP, True, tpot_ms=31.10),
        Observation(SP.SYNC_DRAIN, False, tpot_ms=26.56),
        Observation(SP.SYNC_DRAIN, True, tpot_ms=26.92),
    ]
    return fit_workload("qwen", 128, B300, obs)


class TestPaperTables:
    def test_54_cells_within_5pct(self, qwen_c128):
        targets = {(SP.ASYNC_OVERLAP, False): 23.64, (SP.ASYNC_OVERLAP, True): 31.10,
                   (SP.SYNC_DRAIN, False): 26.56, (SP.SYNC_DRAIN, True): 26.92}
        for (p, cc), tgt in targets.items():
            v = tpot_ms(p, BridgeModel(B300, cc_on=cc), qwen_c128)
            assert v == pytest.approx(tgt, rel=0.05)

    def test_one_flag_recovery_near_57pct(self, qwen_c128):
        on = BridgeModel(B300, cc_on=True)
        off = BridgeModel(B300, cc_on=False)
        gold = tpot_ms(SP.ASYNC_OVERLAP, off, qwen_c128)
        a = tpot_ms(SP.ASYNC_OVERLAP, on, qwen_c128)
        s = tpot_ms(SP.SYNC_DRAIN, on, qwen_c128)
        rec = (a - s) / (a - gold)
        assert rec == pytest.approx(0.57, abs=0.08)

    def test_residual_cc_tax_under_sync_about_1pct(self, qwen_c128):
        on = tpot_ms(SP.SYNC_DRAIN, BridgeModel(B300, cc_on=True), qwen_c128)
        off = tpot_ms(SP.SYNC_DRAIN, BridgeModel(B300, cc_on=False), qwen_c128)
        assert (on - off) / off < 0.02

    def test_b300_inversion_detected(self, qwen_c128):
        outcomes = [
            PolicyOutcome(p, cc, tokens_per_s(p, BridgeModel(B300, cc_on=cc), qwen_c128))
            for p in (SP.ASYNC_OVERLAP, SP.SYNC_DRAIN) for cc in (False, True)]
        inv = detect_inversion(outcomes)
        assert inv["inverted"]
        assert inv["best_cc_off"] is SP.ASYNC_OVERLAP
        assert inv["best_cc_on"] is SP.SYNC_DRAIN

    def test_h200_neutralization_not_inversion(self):
        obs = [
            Observation(SP.ASYNC_OVERLAP, False, tokens_per_s=3497),
            Observation(SP.SYNC_DRAIN, False, tokens_per_s=3174),
            Observation(SP.ASYNC_OVERLAP, True, tokens_per_s=3106),
            Observation(SP.SYNC_DRAIN, True, tokens_per_s=3133),
        ]
        w = fit_workload("h200", 128, H200, obs)
        outcomes = [
            PolicyOutcome(p, cc, tokens_per_s(p, BridgeModel(H200, cc_on=cc), w))
            for p in (SP.ASYNC_OVERLAP, SP.SYNC_DRAIN) for cc in (False, True)]
        inv = detect_inversion(outcomes)
        assert abs(inv["async_gain_cc_on"]) < 0.03
        assert inv["async_gain_cc_off"] > 0.05


class TestStructuralProperties:
    """Hold for any physically sensible workload, not just fitted ones."""

    workloads = st.builds(
        ServingWorkload,
        name=st.just("w"), concurrency=st.sampled_from([32, 128, 512]),
        forward_ms=st.floats(5.0, 100.0), prep_cpu_ms=st.floats(0.5, 20.0),
        gpu_stream_gain_ms=st.floats(0.0, 5.0),
        n_small_h2d=st.integers(1, 12))

    overlapful = st.builds(
        ServingWorkload,
        name=st.just("w"), concurrency=st.sampled_from([32, 128, 512]),
        forward_ms=st.floats(5.0, 100.0), prep_cpu_ms=st.floats(2.0, 20.0),
        gpu_stream_gain_ms=st.floats(0.0, 5.0),
        n_small_h2d=st.integers(1, 12))

    @given(w=overlapful)
    @settings(max_examples=60, deadline=None)
    def test_async_best_cc_off(self, w):
        off = BridgeModel(B300, cc_on=False)
        assert tpot_ms(SP.ASYNC_OVERLAP, off, w) <= \
            tpot_ms(SP.SYNC_DRAIN, off, w) + 1e-9

    tax_regime = st.integers(3, 12).flatmap(
        lambda n: st.builds(
            ServingWorkload,
            name=st.just("w"), concurrency=st.sampled_from([32, 128, 512]),
            forward_ms=st.floats(5.0, 100.0),
            prep_cpu_ms=st.floats(0.0, n * 1.0),
            gpu_stream_gain_ms=st.floats(0.0, 5.0),
            n_small_h2d=st.just(n)))

    @given(w=tax_regime)
    @settings(max_examples=60, deadline=None)
    def test_sync_beats_async_cc_on(self, w):
        on = BridgeModel(B300, cc_on=True)
        assert tpot_ms(SP.SYNC_DRAIN, on, w) <= \
            tpot_ms(SP.ASYNC_OVERLAP, on, w) + 1e-9

    @given(w=workloads)
    @settings(max_examples=60, deadline=None)
    def test_worker_between_sync_and_gold(self, w):
        on = BridgeModel(B300, cc_on=True)
        off = BridgeModel(B300, cc_on=False)
        assert tpot_ms(SP.WORKER_DRAIN, on, w) >= \
            tpot_ms(SP.ASYNC_OVERLAP, off, w) - 1e-9

    @given(w=tax_regime)
    @settings(max_examples=40, deadline=None)
    def test_cc_aware_default_is_never_worse(self, w):
        on = BridgeModel(B300, cc_on=True)
        default = cc_aware_defaults(True, concurrency=w.concurrency).scheduling
        assert tpot_ms(default, on, w) <= tpot_ms(SP.ASYNC_OVERLAP, on, w) + 1e-9


# ---------------------------------------------------------------------------------
# parity: the same inputs through both packages, every float equal
# ---------------------------------------------------------------------------------

def _port(w) -> ServingWorkload:
    """A reference ``ServingWorkload`` rebuilt as the port's, field by
    field."""
    return ServingWorkload(**dataclasses.asdict(w))


def _paper_workloads() -> list:
    """(profile name, reference workload): the §5.4 c=128 table, the §5.5
    sweep (c=128/256/512) and the §5.1 serving matrix (5 rows), 9 workloads
    and 54 cells, then the H200 boundary."""
    ws = [("b300-hgx", W.qwen27b_c128())]
    ws += [("b300-hgx", w) for w in W.sweep_workloads().values()]
    ws += [("b300-hgx", w) for w in W.serving_matrix_workloads().values()]
    return ws + [("h200", W.h200_boundary())]


def _outcomes(outcomes) -> list:
    return [(o.policy.value, o.cc_on, o.tokens_per_s) for o in outcomes]


@pytest.mark.parametrize("i", range(10))
def test_simulate_matrix_matches_reference(i):
    profile, jw = _paper_workloads()[i]
    tw = _port(jw)
    assert dataclasses.asdict(tw) == dataclasses.asdict(jw)
    ours = TS.simulate_matrix(PROFILES[profile], tw)
    ref = JS.simulate_matrix(JB.PROFILES[profile], jw)
    assert len(ours) == 6
    assert _outcomes(ours) == _outcomes(ref)
    for cc in (False, True):
        for p in SP:
            tb = TS.step_breakdown(p, BridgeModel(PROFILES[profile], cc_on=cc),
                                   tw)
            jb = JS.step_breakdown(JSP(p.value), JB.BridgeModel(
                JB.PROFILES[profile], cc_on=cc), jw)
            assert dataclasses.asdict(tb) == dataclasses.asdict(jb)
            assert tb.tpot == jb.tpot


def test_paper_cells_count_54():
    cells = sum(len(TS.simulate_matrix(B300, _port(w)))
                for p, w in _paper_workloads() if p == "b300-hgx")
    assert cells == 54


def _observations(pkg_sp, obs_cls, rows):
    return [obs_cls(pkg_sp(p), cc, **{kind: v}) for p, cc, kind, v in rows]


#: the fits of benchmarks/workloads.py: (name, concurrency, profile, cells,
#: keyword arguments; "cfg" names a config each package loads itself)
FITS = [
    ("qwen3p6-27b-c128", 128, "b300-hgx",
     [("async", False, "tpot_ms", 23.64), ("async", True, "tpot_ms", 31.10),
      ("sync", False, "tpot_ms", 26.56), ("sync", True, "tpot_ms", 26.92)],
     dict(eff_tokens_per_step=4522 * 23.64e-3, cfg="qwen3p6-27b",
          kv_len=W.PAPER_KV_LEN)),
    ("qwen3p6-27b-c512", 512, "b300-hgx",
     [("async", True, "tokens_per_s", 5026), ("sync", True, "tokens_per_s", 5004),
      ("worker", True, "tokens_per_s", 5518),
      ("async", False, "tokens_per_s", 6020),
      ("sync", False, "tokens_per_s", 5226)],
     dict(cfg="qwen3p6-27b", kv_len=W.PAPER_KV_LEN)),
    ("qwen3.6-27b-h200", 128, "h200",
     [("async", False, "tokens_per_s", 3497), ("sync", False, "tokens_per_s", 3174),
      ("async", True, "tokens_per_s", 3106), ("sync", True, "tokens_per_s", 3133)],
     {}),
    ("moe-qwen3.6-35b-a3b", 128, "b300-hgx",
     [("async", False, "tokens_per_s", 5282), ("async", True, "tokens_per_s", 3981)],
     dict(n_small_h2d=9)),
]


@pytest.mark.parametrize("fit", FITS, ids=[f[0] for f in FITS])
def test_fit_workload_matches_reference(fit):
    name, c, profile, rows, kw = fit
    tkw, jkw = dict(kw), dict(kw)
    if "cfg" in kw:
        tkw["cfg"], jkw["cfg"] = get_config(kw["cfg"]), all_configs()[kw["cfg"]]
    ours = TS.fit_workload(name, c, PROFILES[profile],
                           _observations(SP, TS.Observation, rows), **tkw)
    ref = JS.fit_workload(name, c, JB.PROFILES[profile],
                          _observations(JSP, JS.Observation, rows), **jkw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert _outcomes(TS.simulate_matrix(PROFILES[profile], ours)) == \
        _outcomes(JS.simulate_matrix(JB.PROFILES[profile], ref))


@pytest.mark.parametrize("concurrency,kv_len,eff", [(8, 0.0, 1.0),
                                                    (128, 1536.0, 1.7),
                                                    (512, 4608.0, 0.9)])
def test_roofline_workload_matches_reference(concurrency, kv_len, eff):
    ours = TS.roofline_workload("q", get_config("qwen3p6-27b"), B300,
                                concurrency, kv_len=kv_len, eff=eff,
                                prep_cpu_ms=1.5, n_small_h2d=8)
    ref = JS.roofline_workload("q", all_configs()["qwen3p6-27b"], JB.B300,
                               concurrency, kv_len=kv_len, eff=eff,
                               prep_cpu_ms=1.5, n_small_h2d=8)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.forward_source == "roofline"
    assert TS.roofline_forward_ms(get_config("qwen3p6-27b"), B300, concurrency,
                                  kv_len=kv_len) == \
        JS.roofline_forward_ms(all_configs()["qwen3p6-27b"], JB.B300,
                               concurrency, kv_len=kv_len)


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("cc_on", [False, True])
def test_microbenchmark_curves_match_reference(profile, cc_on):
    tp, jp = PROFILES[profile], JB.PROFILES[profile]
    counts = [1, 2, 4, 8, 16]
    assert TS.context_scaling_curve(tp, cc_on, counts) == \
        JS.context_scaling_curve(jp, cc_on, counts)
    for d in ("H2D", "D2H"):
        for n in (1, 2, 8):
            assert TS.small_copy_latency_us(tp, cc_on, n, Direction[d]) == \
                JS.small_copy_latency_us(jp, cc_on, n, JB.Direction[d])
    for n in (1, 4):
        assert TS.sustained_transfer_event_sim(tp, cc_on, n_contexts=n,
                                               n_chunks=16) == \
            JS.sustained_transfer_event_sim(jp, cc_on, n_contexts=n,
                                            n_chunks=16)
