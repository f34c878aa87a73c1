"""Bridge resilience: deterministic fault injection, retry/backoff, and the
degradation ladder.

The bridge is a serialized, high-setup-cost secure channel — which makes
every crossing a failure surface.  This package injects seeded, virtual-
clock-native faults (MAC rejects, session teardown, brownouts, restore
corruption, attestation expiry) and recovers from them with bounded
deterministic retries, escalating to a degradation ladder under sustained
fault pressure.  Faults only move the clock, never the data.
"""

from .degrade import (
    RUNG_COALESCER_BYPASS,
    RUNG_DENSE_STEP,
    RUNG_NAMES,
    RUNG_NONE,
    RUNG_SYNC_RESTORE,
    DegradationLadder,
    LadderTransition,
)
from .faults import (
    REATTEST_SECONDS,
    BrownoutWindow,
    FaultInjector,
    FaultPlan,
    FaultStats,
    unit_draw,
)
from .retry import DEFAULT_POLICIES, DEFAULT_POLICY, RetryBudget, RetryPolicy

__all__ = [
    "BrownoutWindow",
    "DEFAULT_POLICIES",
    "DEFAULT_POLICY",
    "DegradationLadder",
    "FaultInjector",
    "FaultPlan",
    "FaultStats",
    "LadderTransition",
    "REATTEST_SECONDS",
    "RetryBudget",
    "RetryPolicy",
    "RUNG_COALESCER_BYPASS",
    "RUNG_DENSE_STEP",
    "RUNG_NAMES",
    "RUNG_NONE",
    "RUNG_SYNC_RESTORE",
    "unit_draw",
]
