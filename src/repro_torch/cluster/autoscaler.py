"""Replica-set autoscaler on the virtual clock (paper §4 L4 at fleet scale).

Classic autoscalers read wall-clock queue delay; this one reads the same
signal off the virtual clock, plus the gateway's per-op-class crossing
accounting (§5.2) — and that second signal changes the decision rule.  When
queue delay is high because replicas are *bridge-bound* (crossing time
dominates their virtual time) and the secure-context budget is exhausted,
adding a replica is futile: the new replica's context lease is carved out of
the existing replicas' leases, redistributing bridge bandwidth instead of
adding it.  The scaler reports BRIDGE_BOUND instead of thrashing — the L4
law as an autoscaling invariant.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

from .budget import BudgetExhausted, SecureContextBudget
from .replica import ReplicaMetrics


class ScaleDecision(enum.Enum):
    SCALE_UP = "scale_up"
    SCALE_DOWN = "scale_down"
    HOLD = "hold"
    #: scaling up cannot help: the fleet is bridge-bound and the system-wide
    #: secure-context budget has nothing left to lease
    BRIDGE_BOUND = "bridge_bound"


@dataclass
class AutoscalerConfig:
    high_queue_delay_s: float = 0.25
    low_queue_delay_s: float = 0.02
    min_replicas: int = 1
    max_replicas: int = 8
    #: fraction of virtual time spent in crossings above which the fleet
    #: counts as bridge-bound
    bridge_bound_fraction: float = 0.5
    # ---- replacement spawns (resilience, DESIGN.md §11) ------------------
    #: first backoff after a budget-rejected spawn (doubles per consecutive
    #: failure, capped below) — the anti-spin-loop guard: a scaler whose
    #: spawn keeps hitting BudgetExhausted must wait, not hammer the budget
    spawn_backoff_s: float = 1.0
    max_spawn_backoff_s: float = 60.0


class Autoscaler:
    def __init__(self, budget: SecureContextBudget,
                 cfg: Optional[AutoscalerConfig] = None, *,
                 registry=None):
        self.budget = budget
        self.cfg = cfg or AutoscalerConfig()
        #: optional obs.MetricsRegistry: each evaluate() records its
        #: decision (counter, labeled by outcome) and the signals it read
        #: (gauges), so fleet dashboards see *why* the scaler held —
        #: BRIDGE_BOUND with bridge_fraction pinned high is the §4 L4 story
        self.registry = registry
        self.decisions: list[dict] = []
        # ---- replacement-spawn backoff state (DESIGN.md §11) -------------
        self.spawn_failures = 0
        self.spawn_skipped = 0
        self.spawns = 0
        self._spawn_backoff_s = 0.0
        self.spawn_backoff_until = 0.0

    def try_spawn(self, spawn_fn, *, now: float):
        """Attempt a replacement spawn without spin-looping on the budget.

        ``spawn_fn`` provisions and returns the new replica (raising
        :class:`BudgetExhausted` when the fleet's secure-context or pinned
        budget has nothing left).  On rejection the scaler backs off
        exponentially on the virtual clock — repeated calls inside the
        backoff window are counted and skipped, never retried, so a failed
        replacement can't hammer the budget every tick.  Returns the new
        replica, or None (rejected or still backing off).
        """
        if now < self.spawn_backoff_until:
            self.spawn_skipped += 1
            return None
        try:
            replica = spawn_fn()
        except BudgetExhausted:
            self.spawn_failures += 1
            self._spawn_backoff_s = min(
                self.cfg.max_spawn_backoff_s,
                max(self.cfg.spawn_backoff_s, 2.0 * self._spawn_backoff_s))
            self.spawn_backoff_until = now + self._spawn_backoff_s
            if self.registry is not None:
                self.registry.counter("autoscaler/spawn_failures").inc()
            return None
        self.spawns += 1
        self._spawn_backoff_s = 0.0
        self.spawn_backoff_until = 0.0
        return replica

    def evaluate(self, metrics: list[ReplicaMetrics]) -> dict:
        """One scaling decision from a fleet snapshot."""
        if not metrics:
            raise ValueError("need metrics for at least one replica")
        cfg = self.cfg
        n = len(metrics)
        mean_delay = sum(m.queue_delay_s for m in metrics) / n
        total_vt = sum(m.virtual_time_s for m in metrics)
        total_bridge = sum(m.bridge_time_s for m in metrics)
        bridge_fraction = total_bridge / total_vt if total_vt > 0 else 0.0
        op_class: dict[str, float] = {}
        for m in metrics:
            for op, secs in m.op_class_seconds.items():
                op_class[op] = op_class.get(op, 0.0) + secs

        decision, target = ScaleDecision.HOLD, n
        if mean_delay > cfg.high_queue_delay_s:
            if n >= cfg.max_replicas:
                decision = ScaleDecision.HOLD
            elif (bridge_fraction >= cfg.bridge_bound_fraction
                  and self.budget.available() < 1):
                decision = ScaleDecision.BRIDGE_BOUND
            else:
                decision, target = ScaleDecision.SCALE_UP, n + 1
        elif mean_delay < cfg.low_queue_delay_s and n > cfg.min_replicas:
            decision, target = ScaleDecision.SCALE_DOWN, n - 1

        out = {
            "decision": decision,
            "target_replicas": target,
            "mean_queue_delay_s": mean_delay,
            "bridge_fraction": bridge_fraction,
            "op_class_seconds": op_class,
            "budget_available": self.budget.available(),
        }
        self.decisions.append(out)
        if self.registry is not None:
            self.registry.counter("autoscaler/decisions",
                                  decision=decision.value).inc()
            self.registry.gauge("autoscaler/bridge_fraction").set(
                bridge_fraction)
            self.registry.gauge("autoscaler/mean_queue_delay_s").set(
                mean_delay)
            self.registry.gauge("autoscaler/target_replicas").set(
                float(target))
        return out
