"""Deterministic retry/backoff policies for bridge fault recovery.

Every backoff interval is a pure function of (fault seed, op class, attempt
counter) — no wall clock, no global RNG — so a faulted run is byte-for-byte
reproducible and the chaos invariant (faults move the clock, never the data)
can be asserted in CI.

The retry *budget* is the escalation coupling: fault events drain it, and
each time it runs dry the caller climbs one rung of the degradation ladder
(``repro_torch.resilience.degrade``).  Retries themselves are bounded by
``RetryPolicy.max_attempts`` and always terminate in success — a transient
fault may never lose or hang a request.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..trace import opclasses as oc


@dataclass(frozen=True)
class RetryPolicy:
    """Per-op-class retry knobs.

    ``max_attempts`` counts total tries including the final forced success;
    a crossing can therefore be re-charged at most ``max_attempts - 1``
    times.  ``timeout_s`` is the crossing/restore deadline on the virtual
    clock: a (brownout-scaled) crossing whose modeled duration exceeds it
    counts as a timeout fault event and feeds ladder escalation.
    """

    max_attempts: int = 4
    backoff_base_s: float = 200e-6
    backoff_multiplier: float = 2.0
    jitter_frac: float = 0.25
    timeout_s: Optional[float] = None

    def backoff_s(self, attempt: int, unit: float) -> float:
        """Backoff after failed attempt ``attempt`` (0-based).

        ``unit`` in [0, 1) supplies the seeded jitter; the result is
        deterministic given the fault seed's draw stream.
        """
        base = self.backoff_base_s * self.backoff_multiplier ** attempt
        jitter = base * self.jitter_frac * (2.0 * unit - 1.0)
        return max(0.0, base + jitter)


DEFAULT_POLICY = RetryPolicy()

# Bulk restores get a longer fuse and fewer tries: each failed attempt
# re-pays a transfer, not just a toll.
DEFAULT_POLICIES: dict[str, RetryPolicy] = {
    oc.KV_RESTORE_H2D: RetryPolicy(
        max_attempts=3, backoff_base_s=500e-6, timeout_s=5.0),
    oc.KV_RESTORE_PIPELINED: RetryPolicy(
        max_attempts=3, backoff_base_s=500e-6, timeout_s=5.0),
}


class RetryBudget:
    """Escalation accounting.

    Each injected fault event consumes one unit; when ``events_per_escalation``
    units have been consumed since the last escalation, :meth:`consume`
    returns True — the signal to climb the degradation ladder — and the
    window resets.
    """

    def __init__(self, events_per_escalation: int = 8):
        if events_per_escalation < 1:
            raise ValueError("events_per_escalation must be >= 1")
        self.events_per_escalation = events_per_escalation
        self.consumed_total = 0
        self.escalations = 0
        self._since = 0

    def consume(self, n: int = 1) -> bool:
        self.consumed_total += n
        self._since += n
        if self._since >= self.events_per_escalation:
            self._since = 0
            self.escalations += 1
            return True
        return False
