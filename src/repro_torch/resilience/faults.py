"""Seeded fault injection for the CVM<->GPU bridge, native to the virtual clock.

Every crossing of the serialized bridge is also a failure surface: the
AES-GCM MAC/IV verify can reject (transient — retry re-pays the crossing),
the SPDM secure session can tear down (re-establishment re-pays the fixed
setup toll, ~0.7 s per context on the B300 profile), the channel can brown
out (bandwidth /k for a window), a KV restore can fail its integrity check
(re-restore from the offload store), and attestation evidence expires
(quarantine until re-attest).

Determinism contract
--------------------
All fault draws come from counter-based BLAKE2b streams keyed on
``(seed, stream, n)`` — no wall clock, no global RNG, no dependence on the
virtual clock's value.  Retries are bounded by the per-op-class
``RetryPolicy`` and always terminate in success.  Faults therefore *only
move the clock, never the data*: under any seeded schedule of transient
faults the token streams are byte-identical to the fault-free run and no
request is lost or hung.  CI gates exactly that invariant.

Tape visibility
---------------
Every recovery charge lands on the bridge tape: retry penalties re-record
the failed crossing with the ``retry`` tag; re-establishment and
re-attestation get their own op classes (``chan_reestablish``,
``reattest``).  Recovery records carry a real direction/staging so replay
repricing stays total, and their durations sit above the L3 toll floor by
construction (penalty >= the crossing's own modeled cost).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional

from ..core.bridge import Crossing, Direction
from ..trace import opclasses as oc
from .degrade import DegradationLadder
from .retry import DEFAULT_POLICIES, DEFAULT_POLICY, RetryBudget, RetryPolicy

#: modeled re-attestation latency (SPDM GET_MEASUREMENTS + verifier round
#: trip); charged to the replica's clock as one ``reattest`` record
REATTEST_SECONDS = 2.0


def unit_draw(seed: int, stream: str, n: int) -> float:
    """The n-th uniform [0, 1) draw of a named stream — pure and portable."""
    h = hashlib.blake2b(f"{seed}:{stream}:{n}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big") / 2.0 ** 64


@dataclass(frozen=True)
class BrownoutWindow:
    """Channel bandwidth derated by ``factor`` over [t_start, t_end)."""
    t_start: float
    t_end: float
    factor: float  # crossing-cost multiplier, >= 1

    def active(self, now: float) -> bool:
        return self.t_start <= now < self.t_end


@dataclass(frozen=True)
class FaultPlan:
    """A seeded schedule of bridge faults.  Immutable; share freely."""

    seed: int = 0
    crossing_failure_p: float = 0.0    # per charged crossing unit (MAC reject)
    teardown_p: float = 0.0            # per charged crossing (session loss)
    restore_corruption_p: float = 0.0  # per finished KV restore
    brownouts: tuple[BrownoutWindow, ...] = ()
    attestation_ttl_s: Optional[float] = None

    @classmethod
    def transient(cls, seed: int, rate: float) -> "FaultPlan":
        """The canonical transient-fault mix swept by tests and bench_chaos:
        MAC rejects at ``rate``, restore corruption at ``rate``, teardown an
        order of magnitude rarer (each teardown costs ~0.7 s of setup toll).
        """
        return cls(seed=seed, crossing_failure_p=rate,
                   teardown_p=rate / 16.0, restore_corruption_p=rate)

    def any_faults(self) -> bool:
        return bool(self.crossing_failure_p or self.teardown_p
                    or self.restore_corruption_p or self.brownouts
                    or self.attestation_ttl_s is not None)


@dataclass
class FaultStats:
    injected_events: int = 0
    crossing_failures: int = 0
    reestablishments: int = 0
    restore_corruptions: int = 0
    #: fused crossings whose retry budget drained without a clean verify —
    #: decomposed into per-unit re-sends (each with its own fault exposure)
    decompositions: int = 0
    timeouts: int = 0
    reattests: int = 0
    escalations: int = 0
    retry_s: float = 0.0
    reestablish_s: float = 0.0
    restore_redo_s: float = 0.0
    reattest_s: float = 0.0
    decompose_s: float = 0.0

    def recovery_s(self) -> float:
        return (self.retry_s + self.reestablish_s + self.restore_redo_s
                + self.reattest_s + self.decompose_s)

    def mttr_s(self) -> float:
        """Mean time-to-recover per injected fault event (virtual seconds)."""
        return self.recovery_s() / self.injected_events \
            if self.injected_events else 0.0

    def snapshot(self) -> dict:
        return {
            "injected_events": self.injected_events,
            "crossing_failures": self.crossing_failures,
            "reestablishments": self.reestablishments,
            "restore_corruptions": self.restore_corruptions,
            "decompositions": self.decompositions,
            "timeouts": self.timeouts,
            "reattests": self.reattests,
            "escalations": self.escalations,
            "recovery_s": self.recovery_s(),
            "mttr_s": self.mttr_s(),
        }


class FaultInjector:
    """Hooks a :class:`FaultPlan` into a TransferGateway's submit paths.

    Attach with :meth:`attach`; the gateway then routes every charged
    crossing through :meth:`on_crossing` (brownout scaling + teardown +
    transient-failure penalties), and the offload manager consults
    :meth:`restore_corrupted` after each restore.  One injector per
    gateway/replica; draws are independent across replicas via the plan
    seed.
    """

    def __init__(self, plan: FaultPlan, *,
                 policies: Optional[dict[str, RetryPolicy]] = None,
                 ladder: Optional[DegradationLadder] = None,
                 budget: Optional[RetryBudget] = None):
        self.plan = plan
        self.policies = dict(DEFAULT_POLICIES)
        if policies:
            self.policies.update(policies)
        self.ladder = ladder if ladder is not None else DegradationLadder()
        self.budget = budget if budget is not None else RetryBudget()
        self.stats = FaultStats()
        self.gateway = None
        self._counters: dict[str, int] = {}

    # -- plumbing ---------------------------------------------------------
    def attach(self, gateway) -> "FaultInjector":
        gateway.faults = self
        self.gateway = gateway
        return self

    def policy_for(self, op_class: str) -> RetryPolicy:
        return self.policies.get(op_class, DEFAULT_POLICY)

    def _draw(self, stream: str) -> float:
        n = self._counters.get(stream, 0)
        self._counters[stream] = n + 1
        return unit_draw(self.plan.seed, stream, n)

    def _fault_event(self, now: float) -> None:
        self.stats.injected_events += 1
        self.ladder.observe_fault(now)
        if self.budget.consume():
            self.stats.escalations += 1
            self.ladder.escalate(now)

    # -- gateway hook -----------------------------------------------------
    def brownout_factor(self, now: float) -> float:
        factor = 1.0
        for w in self.plan.brownouts:
            if w.active(now):
                factor = max(factor, w.factor)
        return factor

    def on_crossing(self, op_class: str, crossing: Crossing,
                    cost: float, *, n_units: int = 1) -> float:
        """Gateway submit-path hook; returns the (brownout-scaled) cost.

        Fault penalties are charged *before* the real crossing, each as a
        tape record tagged ``retry`` with the same op class / direction /
        staging — so stall attribution and replay see them first-class.
        ``n_units`` is the number of fused constituents in the crossing
        (a coalesced flush is one ciphertext: any constituent MAC reject
        rejects — and re-pays — the whole flush).
        """
        gw = self.gateway
        cost = cost * self.brownout_factor(gw.clock.now)
        pol = self.policy_for(op_class)

        # secure-session teardown: re-establishment pays the setup toll
        if self.plan.teardown_p and \
                self._draw(f"teardown:{op_class}") < self.plan.teardown_p:
            self.reestablish_channel()

        # transient MAC/IV verify rejects: each failed attempt re-pays the
        # crossing plus deterministic exponential backoff, capped by the
        # policy (the final attempt always succeeds — transient by contract)
        p_fail = self.plan.crossing_failure_p
        if p_fail and n_units > 1:
            p_fail = 1.0 - (1.0 - p_fail) ** n_units
        attempt = 0
        while (p_fail and attempt < pol.max_attempts - 1
               and self._draw(f"fail:{op_class}") < p_fail):
            penalty = cost + pol.backoff_s(
                attempt, self._draw(f"jitter:{op_class}"))
            gw.record_modeled(
                crossing.nbytes, crossing.direction, penalty,
                op_class=op_class, staging=crossing.staging,
                tags=(oc.RETRY,))
            self.stats.crossing_failures += 1
            self.stats.retry_s += penalty
            self._fault_event(gw.clock.now)
            attempt += 1

        if n_units > 1 and attempt >= pol.max_attempts - 1:
            # fused ciphertext whose retry budget drained without a clean
            # verify: fusing cannot escape per-unit fault exposure, so the
            # flush decomposes — every constituent re-sends as its own
            # ciphertext (own toll, own verify, own retries).  This is the
            # coalescer's honest failure economics: amortized tolls at low
            # fault rates, toll + whole-flush retries + per-unit isolation
            # at high ones — the crossover the ladder's bypass rung trades
            # against.  Still transient: per-unit retries are policy-capped
            # and the final verify is clean.
            self._charge_decomposition(op_class, crossing, n_units, pol)

        if pol.timeout_s is not None and cost > pol.timeout_s:
            self.stats.timeouts += 1
            self._fault_event(gw.clock.now)
        return cost

    def _charge_decomposition(self, op_class: str, crossing: Crossing,
                              n_units: int, pol: RetryPolicy) -> float:
        """Per-unit isolation re-send of a fused crossing (one tape record)."""
        gw = self.gateway
        unit = Crossing(max(1, crossing.nbytes // n_units),
                        crossing.direction, crossing.staging)
        unit_cost = gw.bridge.crossing_time(unit, n_contexts=1)
        total = 0.0
        p = self.plan.crossing_failure_p
        for _ in range(n_units):
            total += unit_cost
            a = 0
            while (a < pol.max_attempts - 1
                   and self._draw(f"fail:{op_class}") < p):
                total += unit_cost + pol.backoff_s(
                    a, self._draw(f"jitter:{op_class}"))
                a += 1
        gw.record_modeled(crossing.nbytes, crossing.direction, total,
                          op_class=op_class, staging=crossing.staging,
                          tags=(oc.RETRY,))
        self.stats.decompositions += 1
        self.stats.decompose_s += total
        self._fault_event(gw.clock.now)
        return total

    # -- channel re-establishment ----------------------------------------
    def reestablish_channel(self) -> float:
        """Tear down one secure context and re-establish it, charging the
        fixed setup toll (context create + pinned slot registration) as a
        ``chan_reestablish`` record on the engine-serial path."""
        gw = self.gateway
        p = gw.bridge.profile
        toll = p.context_create + p.pinned_slot_alloc
        gw.pool.reestablish()
        gw.record_modeled(0, Direction.H2D, toll,
                          op_class=oc.CHAN_REESTABLISH)
        self.stats.reestablishments += 1
        self.stats.reestablish_s += toll
        self._fault_event(gw.clock.now)
        return toll

    # -- KV restore integrity --------------------------------------------
    def restore_corrupted(self, attempt: int, *, key: str = "") -> bool:
        """Integrity-verify draw for a finished restore.

        ``attempt`` is the 0-based redo count so far; once the restore
        policy's retry budget is spent the result is forced clean — the
        fault class is transient and may not hang a request.
        """
        p = self.plan.restore_corruption_p
        if not p:
            return False
        pol = self.policy_for(oc.KV_RESTORE_H2D)
        if attempt >= pol.max_attempts - 1:
            return False
        if self._draw("restore_corrupt") < p:
            self.stats.restore_corruptions += 1
            self._fault_event(self.gateway.clock.now)
            return True
        return False

    def note_restore_redo(self, seconds: float) -> None:
        self.stats.restore_redo_s += seconds

    # -- attestation expiry ----------------------------------------------
    def reattest_due(self, now: float, attested_at: float) -> bool:
        ttl = self.plan.attestation_ttl_s
        return ttl is not None and now - attested_at >= ttl

    def charge_reattest(self, seconds: float = REATTEST_SECONDS) -> float:
        """Charge a re-attestation round trip as a ``reattest`` record."""
        gw = self.gateway
        gw.record_modeled(0, Direction.H2D, seconds, op_class=oc.REATTEST)
        self.stats.reattests += 1
        self.stats.reattest_s += seconds
        self._fault_event(gw.clock.now)
        return seconds
