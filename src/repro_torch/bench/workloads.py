"""Calibrated workloads for the paper's serving tables (the port's copy of
``benchmarks/workloads.py``, which the port's benches use).

Each paper table row becomes a ServingWorkload whose compute terms (forward,
prep, gpu-stream gain) are least-squares-fit to that row's measured cells —
the bridge-law constants (tolls, channel bandwidths, arbitration) stay fixed
across all fits.  Reproduction quality is therefore a statement about the
*model structure*, not per-row curve fitting: two to four compute terms must
explain four to eight measured cells per table.
"""

from __future__ import annotations

import functools

from repro_torch.configs.base import get_config
from repro_torch.core.bridge import B300, H200
from repro_torch.core.policy import SchedulingPolicy as SP
from repro_torch.core.simulator import Observation, ServingWorkload, fit_workload

#: nominal decode-time context depth of the paper's serving tables (1k-in /
#: 1k-out workload, mid-generation) — the KV term of the roofline-anchored
#: forward.  The fit's efficiency factor absorbs the exact value; it only
#: moves how the forward splits into weight vs KV traffic in the report.
PAPER_KV_LEN = 1536.0


@functools.lru_cache()
def qwen27b_c128() -> ServingWorkload:
    """§5.4 table: Qwen3.6-27B-FP8, c=128, B300.

    Roofline-anchored (DESIGN.md §10): the forward term is
    ``eff x ComputeModel.decode_step_s(128, kv_len=PAPER_KV_LEN)`` — the
    same pricing source the engine's compute-charged clock uses.
    """
    obs = [
        Observation(SP.ASYNC_OVERLAP, False, tpot_ms=23.64),
        Observation(SP.ASYNC_OVERLAP, True, tpot_ms=31.10),
        Observation(SP.SYNC_DRAIN, False, tpot_ms=26.56),
        Observation(SP.SYNC_DRAIN, True, tpot_ms=26.92),
    ]
    return fit_workload("qwen3p6-27b-c128", 128, B300, obs,
                        eff_tokens_per_step=4522 * 23.64e-3,
                        cfg=get_config("qwen3p6-27b"), kv_len=PAPER_KV_LEN)


@functools.lru_cache()
def sweep_workloads() -> dict:
    """§5.5 concurrency sweep (fresh CVM campaign, B300).

    Cells: c=128 (vanilla 3629 / sync 3856 / v10c 3942 / gold 4653),
    c=256 (sync 4766 / v10c 5073), c=512 (vanilla 5026 / sync 5004 /
    v10c 5518 / gold 6020, CC-off sync 5226).  Roofline-anchored like
    ``qwen27b_c128``.
    """
    rows = {
        128: [
            Observation(SP.ASYNC_OVERLAP, True, tokens_per_s=3629),
            Observation(SP.SYNC_DRAIN, True, tokens_per_s=3856),
            Observation(SP.WORKER_DRAIN, True, tokens_per_s=3942),
            Observation(SP.ASYNC_OVERLAP, False, tokens_per_s=4653),
        ],
        256: [
            Observation(SP.SYNC_DRAIN, True, tokens_per_s=4766),
            Observation(SP.WORKER_DRAIN, True, tokens_per_s=5073),
        ],
        512: [
            Observation(SP.ASYNC_OVERLAP, True, tokens_per_s=5026),
            Observation(SP.SYNC_DRAIN, True, tokens_per_s=5004),
            Observation(SP.WORKER_DRAIN, True, tokens_per_s=5518),
            Observation(SP.ASYNC_OVERLAP, False, tokens_per_s=6020),
            Observation(SP.SYNC_DRAIN, False, tokens_per_s=5226),
        ],
    }
    return {c: fit_workload(f"qwen3p6-27b-c{c}", c, B300, obs,
                            cfg=get_config("qwen3p6-27b"),
                            kv_len=PAPER_KV_LEN)
            for c, obs in rows.items()}


#: §5.1 workload classes: (name, cc_off tok/s, cc_on tok/s).  The per-step
#: crossing count n_small is fit per row over a small integer grid — the
#: paper's point exactly: "the tax is a function of bridge-crossing frequency
#: and size", and MoE/speculative rows land on higher counts.
SERVING_MATRIX = [
    ("mlperf-gpt-oss-120b", 1193, 1180),      # rate-capped: bridge idle
    ("dense-qwen3.6-27b", 3302, 2873),
    ("dense-gemma-4-31b", 2357, 2022),
    ("moe-qwen3.6-35b-a3b", 5282, 3981),
    ("moe-gemma-4-26b-a4b", 5583, 4040),
]


@functools.lru_cache()
def serving_matrix_workloads() -> dict:
    from repro_torch.core.bridge import BridgeModel
    from repro_torch.core.simulator import tokens_per_s as _tps

    out = {}
    for name, off_tps, on_tps in SERVING_MATRIX:
        obs = [
            Observation(SP.ASYNC_OVERLAP, False, tokens_per_s=off_tps),
            Observation(SP.ASYNC_OVERLAP, True, tokens_per_s=on_tps),
        ]
        best, best_err = None, float("inf")
        for n_small in range(0, 17):
            w = fit_workload(name, 128, B300, obs, n_small_h2d=n_small)
            m_off = _tps(SP.ASYNC_OVERLAP, BridgeModel(B300, cc_on=False), w)
            m_on = _tps(SP.ASYNC_OVERLAP, BridgeModel(B300, cc_on=True), w)
            err = abs(m_on / m_off - on_tps / off_tps)
            if err < best_err:
                best, best_err = w, err
        out[name] = best
    return out


@functools.lru_cache()
def h200_boundary() -> ServingWorkload:
    """H200 boundary check: async 3497 / sync 3174 CC-off; 3106 / 3133 CC-on
    (neutralization, not inversion)."""
    obs = [
        Observation(SP.ASYNC_OVERLAP, False, tokens_per_s=3497),
        Observation(SP.SYNC_DRAIN, False, tokens_per_s=3174),
        Observation(SP.ASYNC_OVERLAP, True, tokens_per_s=3106),
        Observation(SP.SYNC_DRAIN, True, tokens_per_s=3133),
    ]
    return fit_workload("qwen3.6-27b-h200", 128, H200, obs)


#: §5.2 profiling configuration (CUDA-graphs, warm steady state):
#: 5070 tok/s CC-off vs 3729 CC-on, TPOT 21.5 vs 30.2 ms
PROFILE_TPOT = {"cc_off_ms": 21.5, "cc_on_ms": 30.2}

#: §5.2 op-class table (calls, CC-off avg us, CC-on avg us)
PROFILE_OP_CLASSES = [
    ("aten::_to_copy (alloc+H2D)", 1138, 31.7, 1389.0),
    ("copy_ into pre-allocated", 2628, 25.1, 31.0),
    ("_prepare_inputs pinned", 260, 18.2, 18.4),
    ("attention-path copies", 192, 27.0, 27.8),
]
