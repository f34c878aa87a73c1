"""Scheduling policies and CC-mode-aware defaults (paper §5, §8 rule 3).

The paper's central serving result is *policy inversion*: vLLM's default
async scheduling — overlap step N's device-to-host output drain with step
N+1's preparation — saves ~3 ms/step without CC and costs ~4 ms/step with it,
because the overlapped copies serialize anyway (bridge law L1/L2) while the
stream-arbitration overhead remains.

This module defines the policy vocabulary used across the engine, the
simulator and the benchmarks, and the CC-aware default selection the paper
says belongs in the runtime ("Runtimes should detect GPU-CC mode and flip
scheduling, offload, and streaming defaults accordingly").
"""

from __future__ import annotations

import enum
import os
from dataclasses import dataclass, field
from typing import Optional

from .bridge import BridgeModel, BridgeProfile


class SchedulingPolicy(enum.Enum):
    #: vLLM default: overlap step-N output drain with step-N+1 prep on extra
    #: CUDA streams.  Optimal CC-off; *inverted* (harmful) CC-on.
    ASYNC_OVERLAP = "async"
    #: --no-async-scheduling: forward, sample, one small D2H, drain, continue.
    #: The drained, sequential pattern the secure bridge is engineered for.
    SYNC_DRAIN = "sync"
    #: v10c: keep async structure but move the *blocking* drain to a worker
    #: thread.  A blocked crossing releases the GIL, so the engine thread
    #: pipelines host work while the worker sits in the driver.
    WORKER_DRAIN = "worker"


class OffloadPolicy(enum.Enum):
    #: default vLLM CPU-offload: spill every evicted block (2.3 GiB measured)
    SPILL_ALL = "spill_all"
    #: reuse-aware: offload only blocks observed >= store_threshold times
    #: (2.3 MB measured; 2.97x warm-TTFT improvement CC-on)
    REUSE_AWARE = "reuse_aware"
    #: residency-first: never offload (buy residency — §8 rule 4)
    NO_OFFLOAD = "no_offload"


def overlap_scheduler_default() -> bool:
    """CI matrix hook: REPRO_OVERLAP_SCHEDULER=0 turns the overlap
    *preference* off fleet-wide (tier-1 must pass either way — the barrier
    semantics are not optional).  This is the single source of truth:
    every RuntimeDefaults construction honors it unless a caller overrides
    the field explicitly."""
    return os.environ.get("REPRO_OVERLAP_SCHEDULER", "1") != "0"


def observability_default() -> bool:
    """REPRO_OBS=0 disables observatory creation fleet-wide (the obs layer
    is passive — it never moves the virtual clock — so this is purely a
    host-overhead lever; bench_obs measures the on/off ratio and CI bounds
    it at 1.10x)."""
    return os.environ.get("REPRO_OBS", "1") != "0"


@dataclass(frozen=True)
class RuntimeDefaults:
    """Policy defaults the runtime should select for a given CC mode."""

    scheduling: SchedulingPolicy
    offload: OffloadPolicy
    store_threshold: int
    #: loader worker contexts (0 = single-context default path)
    loader_pool_workers: int
    loader_prewarm: bool
    #: batch small per-step crossings into one staged crossing (§8 rule 1)
    batch_small_crossings: bool
    # ---- bridge_opt levers (DESIGN.md §6) -------------------------------------
    #: pinned-byte budget for the persistent StagingArena (0 = legacy
    #: unbudgeted registered-set staging, no arena)
    staging_arena_bytes: int = 0
    #: queue sub-threshold crossings and flush them fused (CrossingCoalescer)
    coalesce_small_crossings: bool = False
    #: chunk + double-buffer KV restores across the channel pool so restore
    #: overlaps subsequent decode steps (attacks the +131% restore penalty)
    pipelined_restore: bool = False
    # ---- compute-charged clock + overlap scheduling (DESIGN.md §7) ------------
    #: charge per-step prefill/decode compute to the virtual clock (the
    #: ComputeModel roofline) — what makes coalescer deadlines come due and
    #: restore-overlap windows real
    charge_compute: bool = True
    #: prefer scheduling decode compute into windows where pipelined-restore
    #: channels are busy past clock.now (restored admissions defer while
    #: other decode work fills the window).  The restore_barrier correctness
    #: edge is ALWAYS enforced; this flag only controls the preference.
    overlap_scheduler: bool = field(default_factory=overlap_scheduler_default)
    # ---- slot-masked decode (DESIGN.md §8) ------------------------------------
    #: step only the slots whose KV restores have landed (slot-granular read
    #: sets) instead of barriering the whole decode batch on any one slot's
    #: pending restore.  Inert without late restores in flight — with no
    #: pending restore the masked path is byte-identical to the fused batch
    #: step, which is what keeps the golden tapes stable with the flag on.
    slot_masked_decode: bool = True
    # ---- packed ragged decode (DESIGN.md §10) ---------------------------------
    #: execute decode over a packed (non-padded) batch of exactly the ready
    #: slots instead of a dense batch padded to max_batch: prep crossings,
    #: the drain and the compute charge all cover the packed set, so a
    #: half-empty engine stops paying full-batch bridge bytes and phantom
    #: lanes.  Token streams are byte-identical to the dense/slot-masked
    #: paths under greedy decode (rows are batch-independent); with the flag
    #: off the engine takes the legacy dense step.  Packing is what lets
    #: max_batch climb into the hundreds–thousands without every step
    #: paying the widest slot set.
    packed_decode: bool = True
    # ---- observability (DESIGN.md §9) ------------------------------------------
    #: create a repro_torch.obs.Observatory for engines/replicas that are not
    #: handed one explicitly (metrics registry + request spans wired into
    #: the gateway's record stream).  Passive: never touches the clock.
    observability: bool = field(default_factory=observability_default)
    # ---- quantized bridge crossings (DESIGN.md §13) -----------------------------
    #: codec for KV offload/restore crossings ("fp8" | "int8"; "" = full
    #: width).  Spills and restores move wire bytes; restore pays a
    #: dequant compute charge (never bridge time).
    kv_quant: str = ""
    #: codec for weight shard uploads (the 34x load path at 1/2–1/4 bytes)
    weight_quant: str = ""
    #: max per-block relative round-trip error a selected codec may show on
    #: the seeded probe — quant.select_codec refuses codecs above it (e.g.
    #: 0.01 accepts int8, refuses fp8-e4m3)
    accuracy_budget: float = 0.05


def cc_aware_defaults(cc_on: bool, *, allow_worker_drain: bool = True,
                      concurrency: Optional[int] = None,
                      bridge_opt: bool = False) -> RuntimeDefaults:
    """The paper's §8 checklist as a runtime default table.

    CC-off: the classic overlap-everything defaults are correct.
    CC-on : flip scheduling (inversion), make offload evidence-driven, pool
            loader contexts, and batch small crossings.

    Beyond-paper refinement: WORKER_DRAIN's per-step wake overhead only
    amortizes at high concurrency (its measured win is at c=512; at c=128 it
    barely beats sync), so the default is concurrency-aware — SYNC_DRAIN
    below 256 concurrent sequences, WORKER_DRAIN above.  `allow_worker_drain`
    gates the qualified v10c patch entirely; the conservative default is the
    fully-reproduced one-flag fix (SYNC_DRAIN).

    `bridge_opt=True` additionally enables the transfer-optimization
    subsystem (persistent staging arena, crossing coalescer, pipelined KV
    restore — DESIGN.md §6) when CC is on.  It is off by default so the
    paper's measured baselines stay reproducible as recorded.
    """
    if not cc_on:
        return RuntimeDefaults(
            scheduling=SchedulingPolicy.ASYNC_OVERLAP,
            offload=OffloadPolicy.SPILL_ALL,
            store_threshold=0,
            loader_pool_workers=0,
            loader_prewarm=False,
            batch_small_crossings=False,
        )
    use_worker = allow_worker_drain and (concurrency is None or concurrency >= 256)
    return RuntimeDefaults(
        scheduling=(SchedulingPolicy.WORKER_DRAIN if use_worker
                    else SchedulingPolicy.SYNC_DRAIN),
        offload=OffloadPolicy.REUSE_AWARE,
        store_threshold=2,
        loader_pool_workers=8,
        loader_prewarm=True,
        batch_small_crossings=True,
        staging_arena_bytes=(64 << 20) if bridge_opt else 0,
        coalesce_small_crossings=bridge_opt,
        pipelined_restore=bridge_opt,
    )


@dataclass
class PolicyOutcome:
    """One (policy, cc_mode) measurement used by the inversion detector."""

    policy: SchedulingPolicy
    cc_on: bool
    tokens_per_s: float


def detect_inversion(outcomes: list[PolicyOutcome]) -> dict[str, object]:
    """Detect policy inversion from measured/simulated outcomes.

    Inversion (the Blackwell result): the policy ordering flips with CC —
    async > sync CC-off but async < sync CC-on.  Neutralization (the Hopper
    boundary result): async's benefit disappears but does not become a loss.
    """

    def best(cc_on: bool) -> Optional[PolicyOutcome]:
        cands = [o for o in outcomes if o.cc_on is cc_on]
        return max(cands, key=lambda o: o.tokens_per_s) if cands else None

    def get(policy: SchedulingPolicy, cc_on: bool) -> Optional[PolicyOutcome]:
        for o in outcomes:
            if o.policy is policy and o.cc_on is cc_on:
                return o
        return None

    a_off, s_off = get(SchedulingPolicy.ASYNC_OVERLAP, False), get(SchedulingPolicy.SYNC_DRAIN, False)
    a_on, s_on = get(SchedulingPolicy.ASYNC_OVERLAP, True), get(SchedulingPolicy.SYNC_DRAIN, True)
    if None in (a_off, s_off, a_on, s_on):
        raise ValueError("need async/sync outcomes for both CC modes")

    async_gain_off = (a_off.tokens_per_s - s_off.tokens_per_s) / s_off.tokens_per_s
    async_gain_on = (a_on.tokens_per_s - s_on.tokens_per_s) / s_on.tokens_per_s
    # classification thresholds: 1% band counts as a tie (paper's H200 case)
    inverted = async_gain_off > 0.01 and async_gain_on < -0.01
    neutralized = async_gain_off > 0.01 and abs(async_gain_on) <= 0.01
    return {
        "async_gain_cc_off": async_gain_off,
        "async_gain_cc_on": async_gain_on,
        "inverted": inverted,
        "neutralized": neutralized,
        "best_cc_off": best(False).policy,
        "best_cc_on": best(True).policy,
    }


def recovered_fraction(cc_default: float, cc_fixed: float, gold: float) -> float:
    """Fraction of the CC gap a fix recovers: (fixed - default) / (gold - default)."""
    gap = gold - cc_default
    if gap <= 0:
        return 1.0
    return (cc_fixed - cc_default) / gap
