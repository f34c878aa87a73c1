"""Stall attribution: where did the CC gap go? (the §5.2 question, answered
from any BridgeTape).

The paper located the CC slowdown by attributing profiler time to op
classes; this module does the tape-native equivalent.  Over the charged
span of a tape (first charged start to last charged end), every second is
either charged compute or part of the *gap* — and the attributor classifies
the entire gap into the paper's causes:

  ``fresh_staging_toll``       the toll excess a FRESH-staged crossing pays
                               over the same crossing REGISTERED-staged
                               (the 44x alloc-and-copy class, §5.2)
  ``channel_serialization``    charged crossing time that would remain even
                               with warm staging — the serialized channel
                               itself (L1/L2), plus idle intervals covered
                               by pool/worker traffic the engine had to
                               wait out
  ``coalescer_deadline_flush`` crossing time spent in coalescer flushes
                               forced by the deadline (latency the batching
                               knob itself injected, as opposed to
                               watermark/cap flushes doing useful batching)
  ``restore_barrier``          idle intervals covered by in-flight KV
                               restore traffic the engine was draining
                               (pipelined chunks or pooled restores)
  ``deferred_slot``            idle adjacent to slot-masked decode steps —
                               the batch ran short-handed while a deferred
                               slot's restore was still in flight
  ``unattributed_idle``        whatever remains (conservation makes this
                               explicit instead of silently absorbed)

Conservation holds *by construction*: the six buckets sum exactly to
``gap_s = charged_wall_span_s - compute_s``, so the acceptance check
("attributed stall seconds equal the tape's bridge-vs-compute gap within
1%") reduces to ``closure >= 0.99`` — the share of the gap explained by a
named cause rather than ``unattributed_idle``.

The attributor only reads the tape; it never prices anything except the
FRESH-vs-REGISTERED toll delta, which comes from the tape's own bridge
profile.  Intervals are kept per attribution so timeline.py can paint the
stalls as their own track.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.bridge import PROFILES

from repro_torch.trace import opclasses as oc
from repro_torch.trace.tape import BridgeTape

#: sub-nanosecond segments are float dust, not stalls
EPS = 1e-12

CAUSE_FRESH = "fresh_staging_toll"
CAUSE_SERIAL = "channel_serialization"
CAUSE_FLUSH = "coalescer_deadline_flush"
CAUSE_RESTORE = "restore_barrier"
CAUSE_DEFERRED = "deferred_slot"
#: resilience causes (DESIGN.md §11): fault-recovery charges are first-class
#: gap — a retry re-pays a crossing, a re-establishment re-pays the setup
#: toll, a re-attestation re-pays the verifier round trip
CAUSE_RETRY = "fault_retry"
CAUSE_REESTABLISH = "chan_reestablish"
CAUSE_REATTEST = "reattest"
#: fabric-P2P charge (DESIGN.md §12): a TP allreduce / KV migration / shard
#: exchange on the step critical path — named gap, not serialization (the
#: fabric is the one path CC does not serialize, so lumping it under
#: channel_serialization would misread every TP tape)
CAUSE_P2P = "fabric_p2p"
CAUSE_UNATTRIBUTED = "unattributed_idle"

#: every cause, in report order
CAUSES = (CAUSE_FRESH, CAUSE_SERIAL, CAUSE_FLUSH, CAUSE_RESTORE,
          CAUSE_DEFERRED, CAUSE_RETRY, CAUSE_REESTABLISH, CAUSE_REATTEST,
          CAUSE_P2P, CAUSE_UNATTRIBUTED)

#: uncharged traffic that means "a restore was in flight"
_RESTORE_CLASSES = frozenset({oc.KV_RESTORE_H2D, oc.KV_RESTORE_PIPELINED,
                              oc.KV_RESTORE_Q})
_COALESCED_CLASSES = frozenset({oc.COALESCED_H2D, oc.COALESCED_D2H})
#: the coalescer stamps flush records with the trigger that fired them
DEADLINE_FLUSH_TAG = "flush_deadline"

#: idle-gap cover priority (higher wins where uncharged intervals overlap)
_COVER_PRIORITY = {CAUSE_RESTORE: 3, CAUSE_FLUSH: 2, CAUSE_SERIAL: 1}


@dataclass(frozen=True)
class StallInterval:
    """One attributed slice of the gap (timeline.py paints these)."""

    t_start: float
    t_end: float
    cause: str
    record_index: int = -1   # tape record the slice came from (-1 = idle gap)
    note: str = ""

    @property
    def duration_s(self) -> float:
        return self.t_end - self.t_start


@dataclass
class StallReport:
    tape_label: str
    cc_on: bool
    wall_span_s: float = 0.0      # first charged start -> last charged end
    compute_s: float = 0.0        # charged compute inside that span
    gap_s: float = 0.0            # wall_span_s - compute_s
    causes: Dict[str, float] = field(default_factory=dict)
    intervals: List[StallInterval] = field(default_factory=list)

    @property
    def attributed_s(self) -> float:
        """Gap seconds explained by a named cause."""
        return sum(v for k, v in self.causes.items()
                   if k != CAUSE_UNATTRIBUTED)

    @property
    def closure(self) -> float:
        """Share of the gap a named cause explains (acceptance: >= 0.99)."""
        if self.gap_s <= EPS:
            return 1.0
        return self.attributed_s / self.gap_s

    def share(self, cause: str) -> float:
        if self.gap_s <= EPS:
            return 0.0
        return self.causes.get(cause, 0.0) / self.gap_s

    def to_dict(self) -> dict:
        return {"tape_label": self.tape_label, "cc_on": self.cc_on,
                "wall_span_s": self.wall_span_s, "compute_s": self.compute_s,
                "gap_s": self.gap_s, "closure": self.closure,
                "causes": {c: self.causes.get(c, 0.0) for c in CAUSES}}

    def format(self) -> str:
        """§5.2-style 'where did the CC gap go' table."""
        head = (f"stalls[{self.tape_label or 'tape'}] "
                f"span={self.wall_span_s:.6f}s compute={self.compute_s:.6f}s "
                f"gap={self.gap_s:.6f}s closure={self.closure:.4f}")
        lines = [head, f"  {'cause':<26} {'seconds':>12} {'share':>8}"]
        for cause in CAUSES:
            s = self.causes.get(cause, 0.0)
            if s <= EPS and cause != CAUSE_UNATTRIBUTED:
                continue
            lines.append(f"  {cause:<26} {s:>12.6f} {self.share(cause):>7.1%}")
        return "\n".join(lines)


def _fresh_toll_delta(profile_name: str, cc_on: bool) -> float:
    """FRESH-vs-REGISTERED toll excess per crossing under the tape's mode."""
    profile = PROFILES.get(profile_name)
    if profile is None:
        return 0.0
    if cc_on:
        return max(0.0, profile.cc_fresh_toll + profile.cc_fresh_alloc
                   - profile.cc_registered_toll)
    return max(0.0, profile.native_fresh_alloc)


def _charged_cause(record) -> str:
    """Cause of a charged crossing's non-fresh remainder."""
    if record.is_p2p:
        return CAUSE_P2P
    if record.op_class == oc.CHAN_REESTABLISH:
        return CAUSE_REESTABLISH
    if record.op_class == oc.REATTEST:
        return CAUSE_REATTEST
    if oc.RETRY in record.tags:
        return CAUSE_RETRY
    if (record.op_class in _COALESCED_CLASSES
            and DEADLINE_FLUSH_TAG in record.tags):
        return CAUSE_FLUSH
    return CAUSE_SERIAL


def _uncharged_cause(record) -> Optional[str]:
    """What an uncharged record overlapping an idle gap says the engine was
    waiting on (None = this record does not explain idleness)."""
    if record.is_compute:
        return None
    if record.op_class in _RESTORE_CLASSES:
        return CAUSE_RESTORE
    if record.op_class in _COALESCED_CLASSES:
        return (CAUSE_FLUSH if DEADLINE_FLUSH_TAG in record.tags
                else CAUSE_SERIAL)
    return CAUSE_SERIAL


def _is_masked_step(record) -> bool:
    return record.is_compute and (record.op_class == oc.DECODE_MASKED
                                  or oc.DEFERRED in record.tags)


def _attribute_gap(g0: float, g1: float, covers: list,
                   masked_adjacent: bool, report: StallReport) -> None:
    """Split idle gap [g0, g1] over its uncharged covers (priority union)."""
    points = sorted({g0, g1, *(max(g0, s) for s, _, _ in covers),
                     *(min(g1, e) for _, e, _ in covers)})
    fallback = CAUSE_DEFERRED if masked_adjacent else CAUSE_UNATTRIBUTED
    for a, b in zip(points, points[1:]):
        if b - a <= EPS:
            continue
        mid = 0.5 * (a + b)
        cause, rec_idx = fallback, -1
        best = 0
        for s, e, (c, i) in covers:
            if s <= mid <= e and _COVER_PRIORITY[c] > best:
                best, cause, rec_idx = _COVER_PRIORITY[c], c, i
        report.causes[cause] = report.causes.get(cause, 0.0) + (b - a)
        report.intervals.append(StallInterval(
            a, b, cause, record_index=rec_idx,
            note="idle" if rec_idx < 0 else "wait"))


def attribute_stalls(tape: BridgeTape) -> StallReport:
    """Classify every gap second of ``tape`` into the paper's stall causes.

    The decomposition is exact: causes (including ``unattributed_idle``)
    sum to ``gap_s`` up to float addition.  Charged-interval overlap would
    make "gap" ill-defined — L2 forbids it on CC-on tapes, which is what
    makes this attribution well-posed (conformance.py enforces it).
    """
    report = StallReport(tape_label=tape.meta.label, cc_on=tape.meta.cc_on)
    charged = sorted(((i, r) for i, r in enumerate(tape.records) if r.charged),
                     key=lambda ir: (ir[1].t_start, ir[1].t_end))
    if not charged:
        return report

    span_start = charged[0][1].t_start
    span_end = max(r.t_end for _, r in charged)
    report.wall_span_s = span_end - span_start
    report.compute_s = sum(r.duration_s for _, r in charged if r.is_compute)
    report.gap_s = report.wall_span_s - report.compute_s
    toll_delta = _fresh_toll_delta(tape.meta.profile, tape.meta.cc_on)

    # -- charged crossings: fresh excess first, remainder by class/tag ------------------
    for i, r in charged:
        if r.is_compute:
            continue
        d = r.duration_s
        fresh_s = 0.0
        if r.staging == "fresh":
            fresh_s = min(d, toll_delta)
            if fresh_s > EPS:
                report.causes[CAUSE_FRESH] = (
                    report.causes.get(CAUSE_FRESH, 0.0) + fresh_s)
                report.intervals.append(StallInterval(
                    r.t_start, r.t_start + fresh_s, CAUSE_FRESH,
                    record_index=i, note=r.op_class))
        rest = d - fresh_s
        if rest > EPS:
            cause = _charged_cause(r)
            report.causes[cause] = report.causes.get(cause, 0.0) + rest
            report.intervals.append(StallInterval(
                r.t_start + fresh_s, r.t_end, cause,
                record_index=i, note=r.op_class))

    # -- idle gaps between consecutive charged intervals --------------------------------
    uncharged = [(i, r) for i, r in enumerate(tape.records)
                 if not r.charged and not r.is_compute]
    for (_, prev), (_, nxt) in zip(charged, charged[1:]):
        g0, g1 = prev.t_end, nxt.t_start
        if g1 - g0 <= EPS:
            continue
        covers = []
        for i, r in uncharged:
            if r.t_end <= g0 + EPS or r.t_start >= g1 - EPS:
                continue
            cause = _uncharged_cause(r)
            if cause is not None:
                covers.append((r.t_start, r.t_end, (cause, i)))
        masked = _is_masked_step(prev) or _is_masked_step(nxt)
        _attribute_gap(g0, g1, covers, masked, report)

    return report


def ladder_table(reports: Dict[str, StallReport]) -> str:
    """Side-by-side cause table across an optimization ladder (bench view)."""
    names = list(reports)
    width = max(12, *(len(n) for n in names))
    lines = ["  ".join([f"{'cause':<26}"] + [f"{n:>{width}}" for n in names])]
    for cause in CAUSES:
        row = [f"{cause:<26}"]
        row += [f"{reports[n].causes.get(cause, 0.0):>{width}.6f}"
                for n in names]
        lines.append("  ".join(row))
    lines.append("  ".join(
        [f"{'gap_s':<26}"] + [f"{reports[n].gap_s:>{width}.6f}"
                              for n in names]))
    lines.append("  ".join(
        [f"{'closure':<26}"] + [f"{reports[n].closure:>{width}.4f}"
                                for n in names]))
    return "\n".join(lines)
