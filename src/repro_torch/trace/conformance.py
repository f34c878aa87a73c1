"""Bridge-law conformance checker: assert L1-L4 over any BridgeTape.

A tape that violates these invariants was not produced by a serialized
bridge — either the recorder is broken, the gateway's discipline regressed,
or the tape was edited.  The checker is what lets golden tapes act as
regressions on the crossing stream itself: a policy change that breaks the
law fails here before any throughput number moves.

  L1  Within a secure channel, crossings serialize: intervals on the same
      channel never overlap.  Compute records (kind="compute", DESIGN.md §7)
      occupy the engine-serial path (channel -1) like any other interval —
      a compute interval overlapping a crossing interval on the same
      channel means the engine claimed to run the forward *while* blocked
      in a same-thread crossing, which the bridge law forbids (L2 revokes
      exactly that asynchrony).  Cross-channel overlap is legal — it is the
      whole point of the restore-overlap scheduler.
  L2  Asynchrony is revoked: under CC, charged intervals block the calling
      thread, so no two charged intervals overlap anywhere on the tape
      (and every interval is well-formed).
  L3  Every crossing pays its staging toll: durations are floored by the
      profile's fresh/registered toll for the tape's CC mode.  Compute
      records are exempt — they have no staging path.
  L4  Bandwidth lives in bounded contexts: the tape uses at most
      ``max_secure_contexts`` distinct channels, and re-pricing the same
      stream CC-off never costs more than the recorded CC-on stream
      (CC time >= native time; compute re-prices at parity).

Fabric-P2P records (kind="p2p", DESIGN.md §12) are exempt from L3 — they
never transit host staging, so no toll floor applies — but carry their own
structural law ("P2P"): the op-class/kind bijection holds (P2P_CLASSES
records are exactly the kind-"p2p" records), P2P bytes never appear on a
bridge channel (channel is -1, direction "p2p", staging empty), and every
P2P interval is floored by its bytes over the fabric rate (the fallback
rate when tagged FABRIC_FALLBACK — a degraded tenant cannot record
full-fabric timing).

Quantized crossings (tape v5, DESIGN.md §13) carry their own law ("Q"):
any crossing marked quantized — by class, QUANTIZED tag, or a nonzero
raw_bytes — must record both byte counts with wire <= raw and name its
codec, and the quantized op classes always carry the QUANTIZED tag.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.bridge import PROFILES, BridgeProfile, StagingKind

from .tape import BridgeTape

#: absolute slack for float comparisons on virtual-clock seconds
EPS = 1e-9


class ConformanceError(AssertionError):
    """Raised by assert_conformant on a law-violating tape."""


@dataclass(frozen=True)
class Violation:
    law: str              # "L1".."L4"
    index: int            # record index on the tape (-1 for tape-level)
    message: str

    def __str__(self) -> str:
        where = f"record {self.index}" if self.index >= 0 else "tape"
        return f"{self.law} violated at {where}: {self.message}"


@dataclass
class ConformanceReport:
    tape_label: str
    profile: str
    cc_on: bool
    violations: list[Violation] = field(default_factory=list)
    checks: dict[str, int] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    def by_law(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for v in self.violations:
            out[v.law] = out.get(v.law, 0) + 1
        return out

    def format(self) -> str:
        head = (f"conformance[{self.tape_label or 'tape'}] profile={self.profile} "
                f"cc_on={self.cc_on}: "
                f"{'PASS' if self.ok else 'FAIL'} "
                f"({sum(self.checks.values())} checks, "
                f"{len(self.violations)} violations)")
        return "\n".join([head] + [f"  {v}" for v in self.violations[:20]])


def _toll_floor(profile: BridgeProfile, staging: str, cc_on: bool) -> float:
    fresh = staging == StagingKind.FRESH.value
    if cc_on:
        return (profile.cc_fresh_toll + profile.cc_fresh_alloc if fresh
                else profile.cc_registered_toll)
    return profile.native_toll + (profile.native_fresh_alloc if fresh else 0.0)


def check_tape(tape: BridgeTape) -> ConformanceReport:
    profile = PROFILES.get(tape.meta.profile)
    report = ConformanceReport(tape_label=tape.meta.label,
                               profile=tape.meta.profile,
                               cc_on=tape.meta.cc_on)
    if profile is None:
        report.violations.append(Violation(
            "L4", -1, f"unknown bridge profile {tape.meta.profile!r}"))
        return report
    records = tape.records

    # -- interval well-formedness (precondition for L1/L2) ------------------------------
    for i, r in enumerate(records):
        report.checks["wellformed"] = report.checks.get("wellformed", 0) + 1
        if r.t_end < r.t_start - EPS or r.nbytes < 0:
            report.violations.append(Violation(
                "L2", i, f"malformed interval [{r.t_start}, {r.t_end}] "
                         f"({r.nbytes} bytes)"))

    # -- L1: per-channel serialization --------------------------------------------------
    by_channel: dict[int, list[tuple[int, float, float]]] = {}
    for i, r in enumerate(records):
        by_channel.setdefault(r.channel, []).append((i, r.t_start, r.t_end))
    for channel, spans in by_channel.items():
        spans.sort(key=lambda s: (s[1], s[2]))
        for (i0, s0, e0), (i1, s1, e1) in zip(spans, spans[1:]):
            report.checks["L1"] = report.checks.get("L1", 0) + 1
            if s1 < e0 - EPS:
                report.violations.append(Violation(
                    "L1", i1, f"overlaps record {i0} on channel {channel}: "
                              f"[{s0:.6g}, {e0:.6g}] vs [{s1:.6g}, {e1:.6g}]"))

    # -- L1 (compute edge): compute never overlaps a crossing on its channel ------------
    # Implied by the sweep above when both kinds share a channel, but checked
    # explicitly so a tape where compute and crossings interleave incorrectly
    # names the offending *pair* of kinds (the overlap-scheduler regression
    # surface: decode compute may overlap a crossing only across channels).
    for channel, spans in by_channel.items():
        kinds = {i: records[i].is_compute for i, _, _ in spans}
        if not any(kinds.values()) or all(kinds.values()):
            continue
        ordered = sorted(spans, key=lambda s: (s[1], s[2]))
        open_end, open_i = -float("inf"), -1
        for i, s, e in ordered:
            report.checks["L1_compute"] = report.checks.get("L1_compute", 0) + 1
            if (open_i >= 0 and s < open_end - EPS
                    and kinds[i] != kinds[open_i]):
                report.violations.append(Violation(
                    "L1", i, f"compute/crossing overlap with record {open_i} "
                             f"on channel {channel}: device work cannot run "
                             f"while its thread is blocked in a crossing"))
            if e > open_end:
                open_end, open_i = e, i

    # -- L2: revoked asynchrony (charged crossings block the caller) --------------------
    if tape.meta.cc_on:
        charged = sorted(((i, r.t_start, r.t_end)
                          for i, r in enumerate(records) if r.charged),
                         key=lambda s: (s[1], s[2]))
        for (i0, s0, e0), (i1, s1, e1) in zip(charged, charged[1:]):
            report.checks["L2"] = report.checks.get("L2", 0) + 1
            if s1 < e0 - EPS:
                report.violations.append(Violation(
                    "L2", i1, f"charged crossing overlaps record {i0}: "
                              f"\"non-blocking\" is a fiction under CC"))

    # -- L3: staging tolls present ------------------------------------------------------
    for i, r in enumerate(records):
        if not r.is_bridge:
            continue  # compute and fabric P2P have no staging path / toll floor
        report.checks["L3"] = report.checks.get("L3", 0) + 1
        floor = _toll_floor(profile, r.staging, tape.meta.cc_on)
        if r.duration_s < floor - EPS:
            report.violations.append(Violation(
                "L3", i, f"{r.staging} {r.op_class} took {r.duration_s:.3e}s "
                         f"< toll floor {floor:.3e}s"))

    # -- P2P: fabric records are structural, never bridge-priced ------------------------
    from .opclasses import FABRIC_FALLBACK, P2P_CLASSES
    for i, r in enumerate(records):
        classed = r.op_class in P2P_CLASSES
        if not (classed or r.is_p2p):
            continue
        report.checks["P2P"] = report.checks.get("P2P", 0) + 1
        if classed != r.is_p2p:
            report.violations.append(Violation(
                "P2P", i, f"op class {r.op_class!r} / kind {r.kind!r} break "
                          f"the P2P bijection"))
            continue
        if r.channel >= 0 or r.direction != "p2p" or r.staging:
            report.violations.append(Violation(
                "P2P", i, f"fabric bytes on a bridge path: channel="
                          f"{r.channel} direction={r.direction!r} "
                          f"staging={r.staging!r} (P2P never transits the "
                          f"bridge)"))
            continue
        bw = (profile.fabric_fallback_bw if FABRIC_FALLBACK in r.tags
              else profile.fabric_p2p_bw)
        if bw > 0 and r.duration_s < r.nbytes / bw - EPS:
            report.violations.append(Violation(
                "P2P", i, f"{r.op_class} moved {r.nbytes} bytes in "
                          f"{r.duration_s:.3e}s — faster than the "
                          f"{'fallback' if FABRIC_FALLBACK in r.tags else 'fabric'} "
                          f"rate {bw:.3e} B/s allows"))

    # -- Q: quantized crossings carry both byte counts, wire <= raw ---------------------
    # Tape v5 (DESIGN.md §13): a quantized crossing — by class (QUANT_CLASSES),
    # tag (QUANTIZED), or a nonzero raw_bytes field — must record the
    # full-width count alongside the wire count it actually moved, never move
    # more than full width, and name its codec.  The quantized classes also
    # imply the tag, so attribution filters agree with class filters.
    from .opclasses import QUANT_CLASSES, QUANTIZED
    for i, r in enumerate(records):
        if r.kind != "crossing":
            continue
        quantish = (r.op_class in QUANT_CLASSES or QUANTIZED in r.tags
                    or r.raw_bytes > 0)
        if not quantish:
            continue
        report.checks["Q"] = report.checks.get("Q", 0) + 1
        if r.raw_bytes <= 0:
            report.violations.append(Violation(
                "Q", i, f"quantized {r.op_class} carries no full-width "
                        f"raw_bytes (wire nbytes={r.nbytes})"))
            continue
        if not 0 < r.nbytes <= r.raw_bytes:
            report.violations.append(Violation(
                "Q", i, f"quantized {r.op_class} moved {r.nbytes} wire bytes "
                        f"against {r.raw_bytes} raw bytes — a codec never "
                        f"inflates a crossing"))
        if not r.codec:
            report.violations.append(Violation(
                "Q", i, f"quantized {r.op_class} names no codec"))
        if r.op_class in QUANT_CLASSES and QUANTIZED not in r.tags:
            report.violations.append(Violation(
                "Q", i, f"{r.op_class} record missing the {QUANTIZED!r} tag"))

    # -- L4: bounded contexts + CC time >= native time ----------------------------------
    channels = {r.channel for r in records if r.channel >= 0}
    report.checks["L4"] = report.checks.get("L4", 0) + 1
    if len(channels) > profile.max_secure_contexts:
        report.violations.append(Violation(
            "L4", -1, f"{len(channels)} secure channels exceed the "
                      f"system-wide limit {profile.max_secure_contexts}"))
    if tape.meta.cc_on and records:
        from .replay import ReplaySpec, TraceReplayer
        report.checks["L4"] += 1
        native = TraceReplayer(tape).reprice(ReplaySpec(cc_on=False))
        recorded = tape.total_recorded_s()
        if recorded < native.total_replayed_s - EPS:
            report.violations.append(Violation(
                "L4", -1, f"recorded CC-on time {recorded:.6g}s is below the "
                          f"native repricing {native.total_replayed_s:.6g}s"))
    return report


def assert_conformant(tape: BridgeTape) -> ConformanceReport:
    report = check_tape(tape)
    if not report.ok:
        raise ConformanceError(report.format())
    return report
