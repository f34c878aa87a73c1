"""OverlapScheduler — restore-aware step scheduling + the PipeLLM barrier.

Pipelined KV restore (bridge_opt/restore.py) leaves secure channels busy
past ``clock.now``: the caller was charged only the pipeline fill, and the
remaining chunks drain in the background.  Two things follow, one a
preference and one a law:

  * **Preference** — the engine should schedule decode *compute* into that
    window (compute is the only charge that overlaps channel traffic — the
    bridge law forbids overlapping crossings, L1/L2, but says nothing
    against the forward pass running while a channel drains).  Concretely:
    a request whose restore pipeline is still draining defers admission
    while other decode work fills the window; by the time it admits, the
    window has been spent on useful tokens instead of an idle barrier wait.
  * **Law** — speculative restore needs a barrier before first use
    (PipeLLM, ASPLOS 2025): an engine step that reads restored KV before
    the pipeline drains MUST block until it lands.  ``restore_barrier``
    advances the virtual clock to the pipeline's completion; a step that
    does not read restored KV must never pay it.

The preference is a flag (``prefer_overlap``, CI-swept via
``REPRO_OVERLAP_SCHEDULER``); the barrier is unconditional.  With no
restores in flight the scheduler is inert — admission order and every
crossing are identical with the preference on or off, which is what keeps
the golden tapes stable across the CI matrix.

Slot-masked decode (DESIGN.md §8) makes the law slot-granular for running
requests: ``ready_mask`` answers, per stepping slot, whether that slot's
read set (its own request's KV) still has a restore draining, so the
engine steps the ready subset instead of barriering the whole batch on one
slot's pipeline.  Deferrals the engine takes are counted in
``deferred_slots`` — the masked sibling of ``barrier_noops`` (window
hidden) and ``barrier_waits`` (window paid idle).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional

from repro_torch.core.channels import SecureChannelPool, VirtualClock

#: slack under which a pending restore counts as already landed
EPS = 1e-12

#: default window (barrier outcomes) for the windowed no-op share — small
#: enough that a replica going cold shows up within ~one wave of requests
DEFAULT_BARRIER_WINDOW = 64


@dataclass
class OverlapStats:
    #: distinct admissions pushed back because their restore pipeline was
    #: draining (one per request per restore, however many steps it spans)
    deferred_admissions: int = 0
    #: admission passes that deferred something (deferral churn per step)
    deferral_steps: int = 0
    #: barriers that actually blocked (clock advanced to pipeline end)
    barrier_waits: int = 0
    #: virtual seconds spent blocked at barriers
    barrier_wait_s: float = 0.0
    #: barriers that found the pipeline already drained (the overlap win)
    barrier_noops: int = 0
    #: slot-steps deferred by slot-masked decode: a slot whose restore was
    #: still draining sat out one engine step while the rest of the batch
    #: stepped (one count per slot per step — the masked-decode analogue of
    #: a barrier wait the batch did NOT pay)
    deferred_slots: int = 0
    restores_noted: int = 0


class OverlapScheduler:
    """Tracks in-flight restores and arbitrates admission around them."""

    def __init__(self, clock: VirtualClock, pool: SecureChannelPool, *,
                 prefer_overlap: bool = True,
                 barrier_window: int = DEFAULT_BARRIER_WINDOW):
        self.clock = clock
        self.pool = pool
        self.prefer_overlap = prefer_overlap
        #: request/slot key -> virtual time its restored KV fully lands
        self.pending: Dict[str, float] = {}
        #: keys already counted in stats.deferred_admissions for the
        #: currently-pending restore (cleared when the restore resolves)
        self._deferred_keys: set = set()
        #: last `barrier_window` barrier outcomes (True = no-op, the overlap
        #: win) — the windowed counterpart to the lifetime noop counters, so
        #: routers track *current* rather than historical warmth
        self.recent_barriers: deque = deque(maxlen=max(1, int(barrier_window)))
        self.stats = OverlapStats()

    # -- bookkeeping -------------------------------------------------------------------

    def note_restore(self, key: str, done_t: float) -> None:
        """Register that `key`'s KV restore completes at virtual `done_t`.

        Blocking (non-pipelined) restores pass ``done_t <= clock.now`` and
        make the later barrier a no-op — the same call site covers both.
        """
        self.pending[key] = max(float(done_t), self.pending.get(key, 0.0))
        self.stats.restores_noted += 1

    def outstanding(self) -> int:
        return len(self.pending)

    def pending_done_t(self, key: str) -> Optional[float]:
        """Virtual time `key`'s pending restore lands (None when none)."""
        return self.pending.get(key)

    # -- slot-granular read sets (slot-masked decode; DESIGN.md §8) --------------------

    def ready_mask(self, slot_keys: Mapping[int, str]) -> Dict[int, bool]:
        """Per-slot readiness for one decode step.

        ``slot_keys`` maps each stepping slot to the request key whose KV it
        reads — the slot's read set.  A slot is ready iff that read set has
        no restore still draining (nothing pending, or the pipeline already
        landed on the virtual clock).  This is the decode-batch form of the
        PipeLLM barrier: instead of one barrier summed over every stepping
        slot (whole-batch stall), the engine steps the ready subset and
        re-asks next step — the mask is re-evaluated against ``clock.now``
        each call, so deferred slots become ready exactly when their
        pipeline drains.  Pure: no stats move here (the engine records
        deferrals it actually takes via ``record_slot_deferral``).
        """
        now = self.clock.now
        out: Dict[int, bool] = {}
        for slot, key in slot_keys.items():
            done_t = self.pending.get(key)
            out[slot] = done_t is None or done_t - now <= EPS
        return out

    def record_slot_deferral(self, key: str) -> None:
        """Count one slot-step deferral taken by slot-masked decode."""
        self.stats.deferred_slots += 1

    # -- the preference ----------------------------------------------------------------

    def window_s(self) -> float:
        """Seconds the secure channels stay busy past now (the window decode
        compute can be scheduled into)."""
        ctxs = self.pool.active_contexts()
        if not ctxs:
            return 0.0
        return max(0.0, max(c.busy_until for c in ctxs) - self.clock.now)

    def should_defer(self, key: str, *, step_cost_s: float = 0.0) -> bool:
        """Defer `key`'s admission while its restore pipeline drains?

        Only a preference: the engine still admits when nothing else could
        make progress (the caller checks that), and never defers once the
        pipeline has landed.  `step_cost_s` is the price of deferral —
        admission is re-decided once per engine step, so deferring a
        request that would have batched with this step's decode costs one
        step of serialization at the tail.  Defer only when the barrier
        wait it avoids exceeds that (a window shorter than a step is
        cheaper to pay as a wait than to chase).
        """
        if not self.prefer_overlap:
            return False
        done_t = self.pending.get(key)
        return (done_t is not None
                and done_t - self.clock.now > step_cost_s + EPS)

    def record_deferral(self, key: str) -> None:
        """Count a deferral the engine just took for `key`: once per
        request per restore in `deferred_admissions`, every admission pass
        in `deferral_steps`."""
        self.stats.deferral_steps += 1
        if key not in self._deferred_keys:
            self._deferred_keys.add(key)
            self.stats.deferred_admissions += 1

    # -- the law -----------------------------------------------------------------------

    def restore_barrier(self, key: str) -> float:
        """Block until `key`'s restored KV has fully landed (first-use
        barrier).  Returns the virtual seconds waited (0.0 when the pipeline
        already drained or nothing was pending for `key`)."""
        done_t = self.pending.pop(key, None)
        self._deferred_keys.discard(key)   # a later re-restore counts anew
        if done_t is None:
            return 0.0
        waited = done_t - self.clock.now
        if waited > EPS:
            self.clock.advance_to(done_t)
            self.stats.barrier_waits += 1
            self.stats.barrier_wait_s += waited
            self.recent_barriers.append(False)
            return waited
        self.stats.barrier_noops += 1
        self.recent_barriers.append(True)
        return 0.0

    def windowed_noop_share(self) -> float:
        """No-op share over the last ``barrier_window`` barriers only.

        The lifetime share (barrier_noops / barriers) is dominated by
        history — a replica that was warm an hour ago still looks warm.
        Routers preferring overlap-filled replicas should read this one.
        Returns 0.0 before any barrier resolves, like the lifetime share.
        """
        if not self.recent_barriers:
            return 0.0
        return sum(self.recent_barriers) / len(self.recent_barriers)

    # -- export ------------------------------------------------------------------------

    def stats_dict(self) -> dict:
        return {
            "deferred_admissions": self.stats.deferred_admissions,
            "deferral_steps": self.stats.deferral_steps,
            "barrier_waits": self.stats.barrier_waits,
            "barrier_wait_s": self.stats.barrier_wait_s,
            "barrier_noops": self.stats.barrier_noops,
            "deferred_slots": self.stats.deferred_slots,
            "restores_noted": self.stats.restores_noted,
            "outstanding": self.outstanding(),
            "prefer_overlap": self.prefer_overlap,
            "windowed_noop_share": self.windowed_noop_share(),
        }
