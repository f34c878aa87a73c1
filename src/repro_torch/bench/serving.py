"""§5.1 serving overheads, §5.2 accounting, §5.3 policy inversion + patch
refutation, §5.4 sync recovery, §5.5 worker-thread drain sweep.

The port's counterpart of ``benchmarks/bench_serving.py``: the same rows, on the
virtual clock only (no model, no device).

    PYTHONPATH=src python -m repro_torch.bench.serving
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.core import simulator as sim
from repro_torch.core.accounting import CopyRecord, attribute
from repro_torch.core.bridge import (B300, H200, BridgeModel, Crossing,
                                     Direction, StagingKind)
from repro_torch.core.compute import ComputeModel
from repro_torch.core.policy import (PolicyOutcome, SchedulingPolicy as SP,
                                     detect_inversion)
from repro_torch.core.simulator import tokens_per_s, tpot_ms

from . import workloads as W

US = 1e-6


def serving_matrix_rows() -> list[tuple[str, float, str]]:
    """§5.1: CC tax by workload class — the tax is a function of
    bridge-crossing frequency, not a single number."""
    out = []
    for name, off_tps, on_tps in W.SERVING_MATRIX:
        w = W.serving_matrix_workloads()[name]
        model_off = tokens_per_s(SP.ASYNC_OVERLAP, BridgeModel(B300, cc_on=False), w)
        model_on = tokens_per_s(SP.ASYNC_OVERLAP, BridgeModel(B300, cc_on=True), w)
        model_delta = 100 * (model_on / model_off - 1)
        paper_delta = 100 * (on_tps / off_tps - 1)
        out.append((f"5.1/{name}_delta_pct", model_delta,
                    f"paper={paper_delta:.1f}% (n_small={w.n_small_h2d}, "
                    f"off={off_tps},on={on_tps})"))
    return out


def accounting_rows() -> list[tuple[str, float, str]]:
    """§5.2: the accounting loop must close the gap onto the 44x op class."""
    rng = np.random.default_rng(0)
    cc_off, cc_on = [], []
    for op, calls, off_us, on_us in W.PROFILE_OP_CLASSES:
        for _ in range(calls):
            cc_off.append(CopyRecord(op, 64, max(1e-7, rng.normal(off_us, off_us * 0.05)) * US, False))
            cc_on.append(CopyRecord(op, 64, max(1e-7, rng.normal(on_us, on_us * 0.05)) * US, True))
    gap_s = 1.56  # §5.2: 1.56 s total slowdown in the profile window
    attr = attribute(cc_off, cc_on, gap_s)
    dom = attr.dominant()
    out = [
        ("5.2/closure_fraction", attr.closure,
         "paper: 1.54 of 1.56 s = 0.987 explained"),
        ("5.2/dominant_slowdown_x", dom.per_call_slowdown,
         f"paper=44x ({dom.op_class})"),
        ("5.2/dominant_delta_s", dom.total_delta_s, "paper=1.545"),
    ]
    # model-side: the FRESH-vs-REGISTERED staging split reproduces the 44x class
    on = BridgeModel(B300, cc_on=True)
    off = BridgeModel(B300, cc_on=False)
    fresh_on = on.crossing_time(Crossing(64, Direction.H2D, StagingKind.FRESH))
    fresh_off = off.crossing_time(Crossing(64, Direction.H2D, StagingKind.FRESH))
    out.append(("5.2/model_fresh_crossing_x", fresh_on / fresh_off,
                f"paper=44x ({fresh_on/US:.0f}us vs {fresh_off/US:.1f}us)"))
    return out


#: §5.3 patch table: (patch, paper delta ms, model lever)
PATCHES = [
    ("v1_batch_scatter_2to1", -1.0, {"n_small_h2d": 5}),
    ("v4_persistent_pinned", +0.7, {}),       # contention remains: no lever
    ("v5_remove_stream_wait", -0.7, {"arb": 0.0}),
    ("v8_persistent_buffers", -0.5, {"arb": 0.1}),
    ("v9_full_graph_capture", +0.4, {"arb": 0.35}),
]


def patch_refutation_rows() -> list[tuple[str, float, str]]:
    """§5.3: no structural patch moves TPOT; only scheduling policy does.

    An arbitration lever rebinds the simulator's module-level
    ``ARB_ON_MS`` for one pricing; it is restored in a ``finally``, so a
    patch that raises cannot leave later prices at its arbitration."""
    w = W.qwen27b_c128()
    on = BridgeModel(B300, cc_on=True)
    base = tpot_ms(SP.ASYNC_OVERLAP, on, w)
    out = []
    for name, paper_delta, lever in PATCHES:
        w2 = w
        if "n_small_h2d" in lever:
            w2 = dataclasses.replace(w, n_small_h2d=lever["n_small_h2d"])
        old_arb = sim.ARB_ON_MS
        try:
            if "arb" in lever:
                sim.ARB_ON_MS = lever["arb"]
            delta = tpot_ms(SP.ASYNC_OVERLAP, on, w2) - base
        finally:
            sim.ARB_ON_MS = old_arb
        out.append((f"5.3/{name}_delta_ms", delta,
                    f"paper={paper_delta:+.1f}ms (structural: stays 30-31ms TPOT)"))
    # the only change that moves it: the scheduling flip
    flip = tpot_ms(SP.SYNC_DRAIN, on, w) - base
    out.append(("5.3/scheduling_flip_delta_ms", flip,
                "paper=-4.18ms: policy, not structure"))
    return out


def inversion_rows() -> list[tuple[str, float, str]]:
    """§5.3/§5.4: Blackwell inversion vs H200 neutralization + recovery."""
    w = W.qwen27b_c128()
    out = []
    outcomes = [PolicyOutcome(p, cc, tokens_per_s(p, BridgeModel(B300, cc_on=cc), w))
                for p in (SP.ASYNC_OVERLAP, SP.SYNC_DRAIN) for cc in (False, True)]
    inv = detect_inversion(outcomes)
    out.append(("5.3/b300_inverted", float(inv["inverted"]),
                f"paper: inversion (async_gain_off={inv['async_gain_cc_off']:+.3f}, "
                f"on={inv['async_gain_cc_on']:+.3f})"))

    wh = W.h200_boundary()
    outcomes_h = [PolicyOutcome(p, cc, tokens_per_s(p, BridgeModel(H200, cc_on=cc), wh))
                  for p in (SP.ASYNC_OVERLAP, SP.SYNC_DRAIN) for cc in (False, True)]
    inv_h = detect_inversion(outcomes_h)
    out.append(("5.3/h200_neutralized", float(inv_h["neutralized"] or
                                              abs(inv_h["async_gain_cc_on"]) < 0.02),
                f"paper: neutralization (async_gain_on={inv_h['async_gain_cc_on']:+.3f})"))

    # §5.4 four cells + recovery fraction
    cells = [(SP.ASYNC_OVERLAP, False, 23.64), (SP.ASYNC_OVERLAP, True, 31.10),
             (SP.SYNC_DRAIN, False, 26.56), (SP.SYNC_DRAIN, True, 26.92)]
    for p, cc, paper in cells:
        v = tpot_ms(p, BridgeModel(B300, cc_on=cc), w)
        out.append((f"5.4/{p.value}_cc{'on' if cc else 'off'}_tpot_ms", v,
                    f"paper={paper} err={100*(v-paper)/paper:+.1f}%"))
    # recovery in the TPOT domain (the stable metric: the paper's tok/s cells
    # carry per-config occupancy differences)
    gold_t = tpot_ms(SP.ASYNC_OVERLAP, BridgeModel(B300, cc_on=False), w)
    on_async_t = tpot_ms(SP.ASYNC_OVERLAP, BridgeModel(B300, cc_on=True), w)
    on_sync_t = tpot_ms(SP.SYNC_DRAIN, BridgeModel(B300, cc_on=True), w)
    rec = (on_async_t - on_sync_t) / (on_async_t - gold_t)
    out.append(("5.4/one_flag_recovery_fraction", rec, "paper=0.57"))
    on_sync = tokens_per_s(SP.SYNC_DRAIN, BridgeModel(B300, cc_on=True), w)
    off_sync = tokens_per_s(SP.SYNC_DRAIN, BridgeModel(B300, cc_on=False), w)
    out.append(("5.4/residual_cc_tax_under_sync", 1 - on_sync / off_sync,
                "paper~0.01 (CC tax vanishes under a bridge-respecting schedule)"))
    return out


def worker_drain_rows() -> list[tuple[str, float, str]]:
    """§5.5: the v10c concurrency sweep (qualified B300 result)."""
    sweeps = W.sweep_workloads()
    paper = {
        128: {"async": 3629, "sync": 3856, "worker": 3942, "gold": 4653},
        256: {"sync": 4766, "worker": 5073},
        512: {"async": 5026, "sync": 5004, "worker": 5518, "gold": 6020},
    }
    out = []
    for c, w in sweeps.items():
        on = BridgeModel(B300, cc_on=True)
        off = BridgeModel(B300, cc_on=False)
        vals = {
            "async": tokens_per_s(SP.ASYNC_OVERLAP, on, w),
            "sync": tokens_per_s(SP.SYNC_DRAIN, on, w),
            "worker": tokens_per_s(SP.WORKER_DRAIN, on, w),
            "gold": tokens_per_s(SP.ASYNC_OVERLAP, off, w),
        }
        for k, v in vals.items():
            if k in paper[c]:
                tgt = paper[c][k]
                out.append((f"5.5/c{c}_{k}_tps", v,
                            f"paper={tgt} err={100*(v-tgt)/tgt:+.1f}%"))
    # headline: gap to gold at c=512 and recovered fraction
    w512 = sweeps[512]
    on = BridgeModel(B300, cc_on=True)
    off = BridgeModel(B300, cc_on=False)
    v10c = tokens_per_s(SP.WORKER_DRAIN, on, w512)
    gold = tokens_per_s(SP.ASYNC_OVERLAP, off, w512)
    vanilla = tokens_per_s(SP.ASYNC_OVERLAP, on, w512)
    out.append(("5.5/c512_gap_to_gold_pct", 100 * (v10c / gold - 1),
                "paper=-8.3% (qualified)"))
    # "recovers up to 92%": v10c reaches 92% of gold throughput at c=512
    out.append(("5.5/c512_fraction_of_gold", v10c / gold,
                "paper=5518/6020=0.917 (qualified)"))
    return out


def compute_window_rows() -> list[tuple[str, float, str]]:
    """The hideability law (Hopper CC study, arXiv 2409.03992): whether CC
    overhead can be hidden is the compute/crossing ratio.  One decode
    step's compute window (ComputeModel, qwen3.6-27B on B300) against the
    step's crossing overhead under each discipline, swept over the §5.5
    concurrencies: async's fresh-staged crossings outgrow the window (the
    inversion is structural), sync's drained crossings vanish inside it."""
    on = BridgeModel(B300, cc_on=True)
    cm = ComputeModel(get_config("qwen3p6-27b"), on)
    out = []
    for c, w in W.sweep_workloads().items():
        window = cm.decode_step_s(c)
        fresh = on.crossing_time(
            Crossing(w.small_bytes, Direction.H2D, StagingKind.FRESH))
        reg = on.crossing_time(
            Crossing(w.small_bytes, Direction.H2D, StagingKind.REGISTERED))
        drain = on.crossing_time(
            Crossing(w.drain_bytes, Direction.D2H, StagingKind.REGISTERED))
        async_bridge = w.n_small_h2d * fresh + drain
        sync_bridge = w.n_small_h2d * reg + drain
        out.append((f"5.5/c{c}_hideable_ratio_async",
                    window / async_bridge,
                    f"compute window {window*1e3:.2f}ms vs fresh-staged "
                    f"crossings {async_bridge*1e3:.2f}ms (<1: unhideable)"))
        out.append((f"5.5/c{c}_hideable_ratio_sync",
                    window / sync_bridge,
                    f"same window vs drained crossings "
                    f"{sync_bridge*1e3:.2f}ms (>1: the bridge hides)"))
    return out


def run() -> list[str]:
    lines = []
    for fn in (serving_matrix_rows, accounting_rows, patch_refutation_rows,
               inversion_rows, worker_drain_rows, compute_window_rows):
        for name, val, derived in fn():
            lines.append(f"serving/{name},{val:.4f},{derived}")
    return lines


if __name__ == "__main__":
    print("\n".join(run()))
