"""Decode-step pipeline simulator (paper §5).

Steady-state model of one serving engine decode step under each scheduling
policy, priced by the bridge law.  The per-step anatomy follows vLLM's:

    prepare inputs (host CPU + small H2D crossings: scatter-index and
    sampling-index tensors) -> forward+sample (GPU) -> output drain (D2H).

What each policy does with that anatomy:

  SYNC_DRAIN      forward, sample, one small D2H, drain, continue — strictly
                  sequential.  Every crossing finds an idle channel and a warm
                  (REGISTERED) staging slot.
  ASYNC_OVERLAP   overlap step-N drain with step-N+1 prep on extra streams.
                  CC-off this hides prep + drain behind forward (plus
                  GPU-side stream pipelining at high concurrency).  CC-on the
                  overlap is a fiction: crossings serialize on the secure
                  channel (L1), block the issuing thread (L2), and the async
                  path's per-step fresh allocations put every input crossing
                  on the FRESH staging path (~1.39 ms each, the 44x class of
                  §5.2) — while the stream-arbitration overhead remains.
  WORKER_DRAIN    v10c: keep async structure, move the *blocking* drain to a
                  worker thread (a blocked crossing releases the GIL).  Host
                  pipelining is restored and input crossings return to the
                  REGISTERED path; the residual vs gold is the GPU-side
                  stream pipelining CC removes regardless of host structure.

The model is linear in the workload's compute terms, so calibration against
a paper table is a least-squares solve (``fit_workload``).  The *law-level*
properties (inversion sign, recovery ordering, streams-flat/contexts-scale)
are structural — they hold for any physically sensible workload and are
checked by property tests.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

from .bridge import BridgeModel, BridgeProfile, Crossing, Direction, StagingKind
from .channels import SecureChannelPool, VirtualClock
from .policy import PolicyOutcome, SchedulingPolicy

MS = 1e-3


# ---------------------------------------------------------------------------------
# Global pipeline constants (shared across workloads; see module docstring).
# ---------------------------------------------------------------------------------

#: async-submission overhead CC-off (stream setup amortized per step)
ARB_OFF_MS = 1.0
#: stream-arbitration overhead between in-flight transfers CC-on (per step)
ARB_ON_MS = 0.25
#: worker-thread handoff + queue overhead per step (v10c)
WORKER_HANDOFF_MS = 0.65
#: per-step worker wake latency, amortized by concurrency (at low c the
#: worker wakes once per small drain; at high c drains batch) — calibrated
#: to the §5.5 sweep (v10c barely beats sync at c=128, strongly at c=512)
WORKER_WAKE_MS_AT_256 = 1.3
#: small per-step input crossings — vLLM's scatter-index + sampling-index
#: tensors ("six small fresh-pinned H2D copies per decode step", §5.2)
N_SMALL_H2D = 6
#: auxiliary registered copies per step (copy_ into pre-allocated, 1.2x class)
N_AUX_REG = 14
#: measured per-call CC delta of the 1.2x aux class (31.0 - 25.1 us, §5.2)
AUX_CC_DELTA_S = 5.9e-6


@dataclass(frozen=True)
class ServingWorkload:
    """Calibrated decode-step terms for one (model, concurrency) workload."""

    name: str
    concurrency: int
    forward_ms: float            # GPU forward+sample per step (CC parity, L5)
    prep_cpu_ms: float           # host-side prep compute per step
    gpu_stream_gain_ms: float    # GPU-side pipelining async adds CC-off only
    small_bytes: int = 64        # per small input crossing
    drain_bytes: int = 512       # sampled-token drain per step (§5.4)
    eff_tokens_per_step: float = 0.0   # occupancy x concurrency; 0 -> 0.863*c
    #: small per-step input crossings; MoE adds routing-metadata crossings
    #: ("irreducible bridge traffic at the framework level", §5.4)
    n_small_h2d: int = N_SMALL_H2D
    #: where forward_ms came from: "calibrated" (free least-squares term,
    #: the historical path) or "roofline" (``eff x ComputeModel`` — the one
    #: pricing source the engine's clock also charges; DESIGN.md §10)
    forward_source: str = "calibrated"
    #: measured forward as a multiple of the ideal roofline step (>= 1 means
    #: below roofline; ``1/roofline_eff`` is the MFU/MBU-style achieved
    #: fraction).  Meaningful only when forward_source == "roofline".
    roofline_eff: float = 0.0

    @property
    def tokens_per_step(self) -> float:
        return self.eff_tokens_per_step or 0.863 * self.concurrency


@dataclass(frozen=True)
class StepBreakdown:
    """Per-step time attribution (seconds) — what the accounting loop reads."""

    forward: float
    prep_cpu: float
    small_crossings: float
    aux_crossings: float
    drain: float
    arbitration: float
    hidden: float                # overlapped work (subtracted from the sum)

    @property
    def tpot(self) -> float:
        return (
            self.forward + self.prep_cpu + self.small_crossings
            + self.aux_crossings + self.drain + self.arbitration - self.hidden
        )


def _crossing_times(bridge: BridgeModel, w: ServingWorkload) -> dict[str, float]:
    small_reg = bridge.crossing_time(
        Crossing(w.small_bytes, Direction.H2D, StagingKind.REGISTERED))
    small_fresh = bridge.crossing_time(
        Crossing(w.small_bytes, Direction.H2D, StagingKind.FRESH))
    drain = bridge.crossing_time(
        Crossing(w.drain_bytes, Direction.D2H, StagingKind.REGISTERED))
    aux_delta = AUX_CC_DELTA_S if bridge.cc_on else 0.0
    return {
        "small_reg": small_reg,
        "small_fresh": small_fresh,
        "drain": drain,
        "aux": N_AUX_REG * aux_delta,
    }


def step_breakdown(
    policy: SchedulingPolicy, bridge: BridgeModel, w: ServingWorkload
) -> StepBreakdown:
    """Steady-state decode-step time under `policy` on `bridge`."""
    t = _crossing_times(bridge, w)
    fwd = w.forward_ms * MS
    prep = w.prep_cpu_ms * MS

    if policy is SchedulingPolicy.SYNC_DRAIN:
        # fully sequential, drained: idle channel, warm staging (§5.4)
        return StepBreakdown(
            forward=fwd, prep_cpu=prep,
            small_crossings=w.n_small_h2d * t["small_reg"],
            aux_crossings=t["aux"], drain=t["drain"],
            arbitration=0.0, hidden=0.0,
        )

    if policy is SchedulingPolicy.ASYNC_OVERLAP:
        if not bridge.cc_on:
            # overlap hides prep + crossings + drain behind forward, plus
            # GPU-side stream pipelining; floor is the forward itself.
            host = prep + w.n_small_h2d * t["small_fresh"] + t["drain"]
            hidden = min(host, fwd) + w.gpu_stream_gain_ms * MS
            return StepBreakdown(
                forward=fwd, prep_cpu=prep,
                small_crossings=w.n_small_h2d * t["small_fresh"],
                aux_crossings=t["aux"], drain=t["drain"],
                arbitration=ARB_OFF_MS * MS, hidden=hidden,
            )
        # CC-on: crossings block the engine thread after sampling (their
        # completion gates the next forward), fresh staging each step; the
        # only overlap that survives is host CPU prep behind the forward.
        return StepBreakdown(
            forward=fwd, prep_cpu=prep,
            small_crossings=w.n_small_h2d * t["small_fresh"],
            aux_crossings=t["aux"], drain=t["drain"],
            arbitration=ARB_ON_MS * MS, hidden=min(prep, fwd),
        )

    if policy is SchedulingPolicy.WORKER_DRAIN:
        if not bridge.cc_on:
            # CC-off the worker thread is just async with extra handoff
            b = step_breakdown(SchedulingPolicy.ASYNC_OVERLAP, bridge, w)
            return replace(b, arbitration=b.arbitration + WORKER_HANDOFF_MS * MS)
        # v10c: drain blocked on worker thread; engine pipelines prep; input
        # crossings return to the warm path; GPU stream pipelining stays lost.
        handoff = (WORKER_HANDOFF_MS
                   + WORKER_WAKE_MS_AT_256 * 256.0 / max(1, w.concurrency)) * MS
        return StepBreakdown(
            forward=fwd, prep_cpu=prep,
            small_crossings=w.n_small_h2d * t["small_reg"],
            aux_crossings=t["aux"], drain=t["drain"],
            arbitration=handoff,
            hidden=min(prep + t["drain"], fwd),
        )

    raise ValueError(f"unknown policy {policy}")


def tpot_ms(policy: SchedulingPolicy, bridge: BridgeModel, w: ServingWorkload) -> float:
    return step_breakdown(policy, bridge, w).tpot / MS


def tokens_per_s(policy: SchedulingPolicy, bridge: BridgeModel, w: ServingWorkload) -> float:
    return w.tokens_per_step / step_breakdown(policy, bridge, w).tpot


def simulate_matrix(
    profile: BridgeProfile, w: ServingWorkload,
    policies: tuple[SchedulingPolicy, ...] = (
        SchedulingPolicy.ASYNC_OVERLAP, SchedulingPolicy.SYNC_DRAIN,
        SchedulingPolicy.WORKER_DRAIN,
    ),
) -> list[PolicyOutcome]:
    out = []
    for cc_on in (False, True):
        bridge = BridgeModel(profile, cc_on=cc_on)
        for p in policies:
            out.append(PolicyOutcome(p, cc_on, tokens_per_s(p, bridge, w)))
    return out


# ---------------------------------------------------------------------------------
# One pricing source (DESIGN.md §10): the simulator's forward term is the same
# ComputeModel roofline the engine's clock charges.  A calibrated workload is a
# roofline step scaled by one dimensionless achieved-efficiency factor, so the
# §5 tables and the engine can never price the forward from different models.
# ---------------------------------------------------------------------------------


def roofline_forward_ms(cfg, profile: BridgeProfile, batch: int, *,
                        kv_len: float = 0.0, spec=None) -> float:
    """One decode step's forward time (ms) from the ComputeModel roofline.

    Priced CC-off (device-local work is at parity, L5 — the ``forward_ms``
    the step model carries is policy- and CC-independent by construction).
    """
    from .compute import ComputeModel
    cm = ComputeModel(cfg, BridgeModel(profile, cc_on=False), spec=spec)
    return cm.decode_step_s(batch, kv_len=kv_len) / MS


def roofline_workload(name: str, cfg, profile: BridgeProfile,
                      concurrency: int, *, kv_len: float = 0.0,
                      eff: float = 1.0, prep_cpu_ms: float = 0.0,
                      gpu_stream_gain_ms: float = 0.0,
                      **kw) -> ServingWorkload:
    """Build a workload whose forward term is ``eff x`` the ComputeModel
    roofline step — no measured table required (the bench_packed sweep uses
    this to price arbitrary config x batch x length cells)."""
    fwd = eff * roofline_forward_ms(cfg, profile, concurrency, kv_len=kv_len)
    return ServingWorkload(
        name, concurrency, forward_ms=fwd, prep_cpu_ms=prep_cpu_ms,
        gpu_stream_gain_ms=gpu_stream_gain_ms,
        forward_source="roofline", roofline_eff=eff, **kw)


# ---------------------------------------------------------------------------------
# Calibration: the step model is linear in (forward, prep_cpu, gpu_stream_gain),
# so fitting a workload to measured table cells is a least-squares solve.
# ---------------------------------------------------------------------------------

@dataclass(frozen=True)
class Observation:
    policy: SchedulingPolicy
    cc_on: bool
    tpot_ms: Optional[float] = None        # either TPOT...
    tokens_per_s: Optional[float] = None   # ...or throughput (converted)


def fit_workload(
    name: str, concurrency: int, profile: BridgeProfile,
    observations: list[Observation], *, eff_tokens_per_step: float = 0.0,
    n_small_h2d: int = N_SMALL_H2D, cfg=None, kv_len: float = 0.0,
) -> ServingWorkload:
    """Fit (forward, prep_cpu, gpu_stream_gain) to measured table cells.

    The step model is *piecewise* linear (the overlap `min` terms), so the
    fit is a damped Gauss-Newton around the current iterate rather than one
    linear solve.  Converges in a handful of iterations for every paper table
    (the pieces are flat and the tables are near-consistent with the model).

    With a ``cfg`` (ModelConfig), the forward term is not a free millisecond
    count: the fit solves for a dimensionless achieved-efficiency factor on
    the ComputeModel roofline step (``forward_ms = eff x roofline``) — the
    same reparameterized linear space, so the fitted workload is numerically
    identical, but the §5 tables and the engine's clock now share one
    pricing source and the fit's residual is an honest MFU/MBU-style
    statement (``roofline_eff``) instead of an unanchored constant.
    """
    probe = ServingWorkload(name, concurrency, 0.0, 0.0, 0.0,
                            eff_tokens_per_step=eff_tokens_per_step,
                            n_small_h2d=n_small_h2d)
    tps_const = probe.tokens_per_step
    #: ms of forward per unit of x[0]: the roofline step when anchored to a
    #: config, 1.0 (x[0] is itself the ms) on the legacy free-term path
    base_ms = (roofline_forward_ms(cfg, profile, concurrency, kv_len=kv_len)
               if cfg is not None else 1.0)

    targets = []
    for obs in observations:
        target = obs.tpot_ms
        if target is None:
            if obs.tokens_per_s is None:
                raise ValueError("observation needs tpot_ms or tokens_per_s")
            target = tps_const / obs.tokens_per_s / MS
        targets.append((obs.policy, obs.cc_on, target))

    bridges = {cc: BridgeModel(profile, cc_on=cc) for cc in (False, True)}

    def predict(x: np.ndarray) -> np.ndarray:
        w = replace(probe, forward_ms=float(x[0]) * base_ms,
                    prep_cpu_ms=float(x[1]),
                    gpu_stream_gain_ms=float(x[2]))
        return np.array([
            step_breakdown(p, bridges[cc], w).tpot / MS for p, cc, _ in targets])

    y = np.array([t for _, _, t in targets])
    # init: forward = 80% of fastest cell, small prep, small gain
    x = np.array([0.8 * y.min() / base_ms, 0.15 * y.min(), 0.5])
    eps = 1e-3
    for _ in range(60):
        f0 = predict(x)
        J = np.zeros((len(targets), 3))
        for i in range(3):
            dx = np.zeros(3)
            dx[i] = eps
            J[:, i] = (predict(x + dx) - f0) / eps
        # damped least-squares step
        JTJ = J.T @ J + 1e-6 * np.eye(3)
        step = np.linalg.solve(JTJ, J.T @ (y - f0))
        x = np.clip(x + 0.8 * step, 0.0, None)
        if np.linalg.norm(step) < 1e-9:
            break
    fwd, prep, gain = float(x[0]) * base_ms, float(x[1]), float(x[2])
    return ServingWorkload(
        name, concurrency, forward_ms=fwd, prep_cpu_ms=prep,
        gpu_stream_gain_ms=gain, eff_tokens_per_step=eff_tokens_per_step,
        n_small_h2d=n_small_h2d,
        forward_source="roofline" if cfg is not None else "calibrated",
        roofline_eff=float(x[0]) if cfg is not None else 0.0,
    )


# ---------------------------------------------------------------------------------
# Microbenchmark simulator: the streams-flat / contexts-scale curves (§4.2, Fig 2)
# ---------------------------------------------------------------------------------

def small_copy_latency_us(
    profile: BridgeProfile, cc_on: bool, n_streams: int,
    direction: Direction = Direction.D2H,
) -> float:
    """Per-copy latency of 32-byte same-context copies vs stream count (L1)."""
    bridge = BridgeModel(profile, cc_on=cc_on)
    return bridge.stream_scaling(direction, n_streams) / 1e-6


def context_scaling_curve(
    profile: BridgeProfile, cc_on: bool, context_counts: list[int],
    direction: Direction = Direction.H2D,
) -> list[float]:
    """Aggregate sustained bandwidth (GB/s) vs number of contexts (L4)."""
    bridge = BridgeModel(profile, cc_on=cc_on)
    return [bridge.aggregate_bandwidth(direction, n) / 1e9 for n in context_counts]


def sustained_transfer_event_sim(
    profile: BridgeProfile, cc_on: bool, *, n_contexts: int, n_chunks: int = 64,
    chunk_bytes: int = 256 << 20, direction: Direction = Direction.H2D,
) -> float:
    """Event-driven check of the analytic law: fan `n_chunks` large copies
    over a context pool and measure achieved GB/s.  Returns bandwidth in GB/s.
    """
    bridge = BridgeModel(profile, cc_on=cc_on)
    clock = VirtualClock()
    pool = SecureChannelPool(bridge, n_workers=n_contexts, clock=clock)
    pool.prewarm()
    done = 0.0
    for _ in range(n_chunks):
        done = max(done, pool.submit(
            Crossing(chunk_bytes, direction, StagingKind.REGISTERED)))
    total_bytes = n_chunks * chunk_bytes
    # ceiling: aggregate over the pool cannot exceed the systemic cap
    elapsed = max(done, total_bytes / bridge.aggregate_bandwidth(direction, n_contexts))
    return total_bytes / elapsed / 1e9
