"""Degradation ladder: trade optimization for fault-cost under sustained
bridge faults, then recover with hysteresis once the channel quiets down.

Rungs (cumulative — rung N implies all rungs below it):

  0  full-opt        pipelined restore, coalescer, packed decode
  1  sync_restore    pipelined -> drained sync restore.  The pipelined path
                     MACs the whole transfer as one stream, so an integrity
                     failure re-pays the entire prefix; the sync path
                     verifies per block and re-sends one block.
  2  coalescer_bypass small crossings charged individually (barrier flush on
                     entry).  A fused flush is one ciphertext — any
                     constituent MAC reject re-pays the whole flush; bypassed
                     crossings retry only themselves.
  3  dense_step      packed -> dense decode, the maximally predictable step
                     shape (last resort; byte-identical tokens either way).

Escalation is driven by the retry budget (``RetryBudget.consume`` returning
True); recovery steps one rung down after ``recovery_quiet_s`` of virtual
time with no fault events — the hysteresis that prevents flapping between
rungs at intermediate fault rates.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

RUNG_NONE = 0
RUNG_SYNC_RESTORE = 1
RUNG_COALESCER_BYPASS = 2
RUNG_DENSE_STEP = 3

RUNG_NAMES = ("full", "sync_restore", "coalescer_bypass", "dense_step")


@dataclass
class LadderTransition:
    t: float
    level: int
    reason: str


class DegradationLadder:
    """Current degradation level plus the virtual-time transition log.

    With ``enabled=False`` the ladder records escalation requests but the
    level stays pinned at 0 — the ablation arm of ``bench_chaos``.
    """

    def __init__(self, *, enabled: bool = True,
                 recovery_quiet_s: float = 0.05,
                 max_level: int = RUNG_DENSE_STEP):
        self.enabled = enabled
        self.recovery_quiet_s = recovery_quiet_s
        self.max_level = max_level
        self.level = RUNG_NONE
        self.transitions: list[LadderTransition] = []
        self.escalations_requested = 0
        self._last_fault_t: Optional[float] = None
        self._degraded_since: Optional[float] = None
        self._degraded_accum_s = 0.0

    # -- state queries ----------------------------------------------------
    @property
    def sync_restore_forced(self) -> bool:
        return self.level >= RUNG_SYNC_RESTORE

    @property
    def coalescer_bypassed(self) -> bool:
        return self.level >= RUNG_COALESCER_BYPASS

    @property
    def dense_step_forced(self) -> bool:
        return self.level >= RUNG_DENSE_STEP

    def degraded_s(self, now: float) -> float:
        """Total virtual time spent at level > 0 up to ``now``."""
        open_s = (now - self._degraded_since
                  if self._degraded_since is not None else 0.0)
        return self._degraded_accum_s + max(0.0, open_s)

    # -- transitions ------------------------------------------------------
    def observe_fault(self, now: float) -> None:
        """Reset the recovery quiet timer (any injected fault event)."""
        self._last_fault_t = now

    def escalate(self, now: float, *, reason: str = "retry_budget") -> int:
        self.escalations_requested += 1
        if not self.enabled or self.level >= self.max_level:
            return self.level
        self._set_level(self.level + 1, now, reason)
        return self.level

    def maybe_recover(self, now: float) -> bool:
        """Hysteresis step-down: one rung per quiet window."""
        if self.level == RUNG_NONE:
            return False
        quiet_since = self._last_fault_t
        if quiet_since is None or now - quiet_since >= self.recovery_quiet_s:
            self._set_level(self.level - 1, now, "recovered")
            # a further rung-down needs a fresh quiet window
            self._last_fault_t = now
            return True
        return False

    def _set_level(self, level: int, now: float, reason: str) -> None:
        if level == self.level:
            return
        if self.level == RUNG_NONE and level > RUNG_NONE:
            self._degraded_since = now
        elif level == RUNG_NONE and self._degraded_since is not None:
            self._degraded_accum_s += max(0.0, now - self._degraded_since)
            self._degraded_since = None
        self.level = level
        self.transitions.append(LadderTransition(now, level, reason))
