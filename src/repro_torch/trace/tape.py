"""BridgeTape — the versioned, replayable crossing trace (the repo's §5.2).

A tape is the full crossing stream of one run: per crossing the op class,
direction, byte count, staging kind, secure channel, and virtual-clock
interval, plus metadata describing the discipline the stream was recorded
under (bridge profile, CC mode, scheduling policy, channel-pool width).

The tape is the discriminating evidence for every policy claim in this
repo: benchmarks re-price tapes under counterfactual disciplines
(replay.py) instead of re-running engines, regression tests pin the
crossing stream itself (tests/golden/), and the conformance checker
asserts the bridge-law invariants over any tape (conformance.py).

Format versioning (see DESIGN.md §5): ``format`` is ``bridge-tape/v<N>``.
Additive, default-carrying fields do not bump N; any change that alters the
meaning of an existing field or removes one does, and ``from_dict`` refuses
tapes from an unreadable major version rather than misreading them.

v2 (DESIGN.md §7): records carry an additive ``kind`` field — ``crossing``
(the only v1 meaning) or ``compute`` (a device-local prefill/decode
interval charged by core.compute.ComputeModel; direction/staging empty,
nbytes 0).  v1 tapes parse unchanged (every record defaults to
``crossing``), so this reader accepts v1 *and* v2; the writer stamps v2
because a stream containing compute records must not be consumed by a
v1-only reader that would misprice them as crossings.

v3 (DESIGN.md §9): coalesced records carry an additive ``sources`` field —
the (op_class, nbytes) pairs of the constituent crossings fused into one
flush — so the stall attributor and ``TraceReplayer`` can un-fuse a
coalesced stream counterfactually.  Defaults to empty; v1/v2 tapes parse
unchanged, so this reader accepts v1-v3.  The writer stamps v3 because a
stream whose byte totals double-count fused constituents (record.nbytes is
the fused total; sources re-lists the parts) must not be summed by a
reader unaware of the distinction.

v4 (DESIGN.md §12): records may carry ``kind == "p2p"`` — in-tenant fabric
P2P movement (KV migration, TP allreduce, weight-shard exchange) that never
transits the serialized bridge.  Direction is "p2p", staging is empty,
channel is -1, and the record is priced at `fabric.p2p_bandwidth` (or the
TCP fallback, tagged FABRIC_FALLBACK).  v1-v3 tapes parse unchanged; the
writer stamps v4 because a stream whose byte totals include fabric traffic
must not be summed as bridge bytes by a reader unaware of the kind.

v5 (DESIGN.md §13): quantized crossings carry additive ``raw_bytes`` (the
full-width byte count the payload widens back to on device) and ``codec``
(the codec id) fields; ``nbytes`` remains what actually crossed the wire.
v1-v4 tapes parse unchanged (both default to 0/"" = not quantized); the
writer stamps v5 because on a quantized stream ``nbytes`` totals are *wire*
bytes — a reader unaware of the distinction would misread them as the
workload's full-width traffic and under-count the counterfactual
un-quantized cost (conformance's Q-law enforces wire <= raw per record).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Iterable, Optional

from repro_torch.core.accounting import CopyRecord

TAPE_FORMAT = "bridge-tape/v5"
#: major versions this reader speaks (v1 = crossings only; v2 adds compute
#: records; v3 adds coalesced-record sources; v4 adds fabric-P2P records;
#: v5 adds quantized-crossing raw_bytes/codec)
READABLE_VERSIONS = (1, 2, 3, 4, 5)

#: record kinds
KIND_CROSSING = "crossing"
KIND_COMPUTE = "compute"
KIND_P2P = "p2p"


class TapeFormatError(ValueError):
    """Raised when a serialized tape is not a readable bridge-tape version."""


@dataclass(frozen=True)
class TapeRecord:
    """One crossing on the tape (the serializable form of a CopyRecord)."""

    op_class: str
    direction: str          # "h2d" | "d2h" ("" for compute records)
    nbytes: int
    staging: str            # "fresh" | "registered" ("" for compute records)
    channel: int            # secure-channel/context id; -1 = engine-serial path
    t_start: float
    t_end: float
    charged: bool = True
    #: additive provenance tags (bridge_opt: arena_hit/arena_miss); default
    #: empty, so pre-tag tapes parse unchanged (no version bump)
    tags: tuple = ()
    #: interval kind: "crossing" (v1's only meaning) or "compute"
    #: (device-local prefill/decode work — DESIGN.md §7)
    kind: str = KIND_CROSSING
    #: roofline boundness of a compute record ("compute" | "memory"; "" on
    #: crossings and pre-boundness tapes).  Additive with default per the
    #: §5 rules — replay uses it to pick the matching CC parity factor
    #: (hbm_parity for memory-bound steps) instead of assuming compute-bound.
    bound: str = ""
    #: v3: constituent crossings fused into this record, as (op_class,
    #: nbytes) pairs (set on coalesced flushes; empty otherwise).  Lets the
    #: stall attributor and replay un-fuse a coalesced stream
    #: counterfactually without guessing the pre-fusion shape.
    sources: tuple = ()
    #: v5: full-width byte count of a quantized crossing (nbytes is the wire
    #: size); 0 = not quantized.  Conformance demands 0 < nbytes <= raw_bytes
    #: whenever set, and replay's un-quantize lever reprices at this width.
    raw_bytes: int = 0
    #: v5: codec id ("fp8" | "int8") of a quantized crossing; "" otherwise
    codec: str = ""

    @property
    def duration_s(self) -> float:
        return self.t_end - self.t_start

    @property
    def is_compute(self) -> bool:
        return self.kind == KIND_COMPUTE

    @property
    def is_p2p(self) -> bool:
        return self.kind == KIND_P2P

    @property
    def is_bridge(self) -> bool:
        """A serialized-bridge crossing: not compute, not fabric P2P."""
        return self.kind == KIND_CROSSING

    @classmethod
    def from_copy_record(cls, rec: CopyRecord) -> "TapeRecord":
        return cls(op_class=rec.op_class, direction=rec.direction,
                   nbytes=rec.nbytes, staging=rec.staging, channel=rec.channel,
                   t_start=rec.t_start, t_end=rec.t_end, charged=rec.charged,
                   tags=tuple(rec.tags), kind=rec.kind, bound=rec.bound,
                   sources=tuple(tuple(s) for s in rec.sources),
                   raw_bytes=rec.raw_bytes, codec=rec.codec)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TapeRecord":
        return cls(op_class=d["op_class"], direction=d["direction"],
                   nbytes=int(d["nbytes"]), staging=d["staging"],
                   channel=int(d["channel"]), t_start=float(d["t_start"]),
                   t_end=float(d["t_end"]), charged=bool(d.get("charged", True)),
                   tags=tuple(d.get("tags", ())),
                   kind=d.get("kind", KIND_CROSSING),
                   bound=d.get("bound", ""),
                   sources=tuple((str(s[0]), int(s[1]))
                                 for s in d.get("sources", ())),
                   raw_bytes=int(d.get("raw_bytes", 0)),
                   codec=d.get("codec", ""))


@dataclass(frozen=True)
class TapeMeta:
    """The discipline the stream was recorded under."""

    profile: str            # BridgeProfile name, key into bridge.PROFILES
    cc_on: bool
    policy: str = ""        # SchedulingPolicy.value ("" when not engine-driven)
    pool_workers: int = 1
    label: str = ""
    extra: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TapeMeta":
        return cls(profile=d["profile"], cc_on=bool(d["cc_on"]),
                   policy=d.get("policy", ""),
                   pool_workers=int(d.get("pool_workers", 1)),
                   label=d.get("label", ""), extra=dict(d.get("extra", {})))


@dataclass
class BridgeTape:
    meta: TapeMeta
    records: list[TapeRecord] = field(default_factory=list)
    format: str = TAPE_FORMAT

    # -- summary views (what golden tests pin) ---------------------------------------

    def n_records(self) -> int:
        return len(self.records)

    def n_crossings(self) -> int:
        """Bridge-crossing records only — compute intervals and fabric-P2P
        movement are not serialized-bridge crossings."""
        return sum(1 for r in self.records if r.is_bridge)

    def total_bytes(self) -> int:
        return sum(r.nbytes for r in self.records)

    def total_recorded_s(self) -> float:
        """Sum of all recorded interval durations (crossings + compute)."""
        return sum(r.duration_s for r in self.records)

    def compute_seconds(self) -> float:
        """Recorded device-local compute time (kind="compute" records)."""
        return sum(r.duration_s for r in self.records if r.is_compute)

    def crossing_seconds(self) -> float:
        """Recorded serialized-bridge time (bridge-crossing records only —
        fabric-P2P time is deliberately excluded: it is the path the bridge
        law does not serialize, and folding it in would dilute fresh_share
        and every bridge-time recovery ratio)."""
        return sum(r.duration_s for r in self.records if r.is_bridge)

    def p2p_seconds(self) -> float:
        """Recorded in-tenant fabric-P2P time (kind="p2p" records)."""
        return sum(r.duration_s for r in self.records if r.is_p2p)

    def p2p_bytes(self) -> int:
        """Bytes moved over the tenant fabric (never the bridge)."""
        return sum(r.nbytes for r in self.records if r.is_p2p)

    def bridge_bytes(self) -> int:
        """Bytes that actually crossed the serialized bridge (wire bytes
        for quantized crossings)."""
        return sum(r.nbytes for r in self.records if r.is_bridge)

    def bridge_raw_bytes(self) -> int:
        """Full-width bytes the bridge crossings represent: raw_bytes where
        quantized, nbytes otherwise — the un-quantized counterfactual total
        (v5; equals bridge_bytes() on any unquantized tape)."""
        return sum((r.raw_bytes or r.nbytes)
                   for r in self.records if r.is_bridge)

    def charged_s(self) -> float:
        """Durations charged to the recording clock's critical path."""
        return sum(r.duration_s for r in self.records if r.charged)

    def op_class_mix(self) -> dict[str, int]:
        mix: dict[str, int] = {}
        for r in self.records:
            mix[r.op_class] = mix.get(r.op_class, 0) + 1
        return mix

    def op_class_seconds(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for r in self.records:
            out[r.op_class] = out.get(r.op_class, 0.0) + r.duration_s
        return out

    def staging_seconds(self) -> dict[str, float]:
        """Recorded crossing seconds per staging kind ("fresh"/"registered");
        compute and fabric-P2P records have no staging path and are
        excluded."""
        out: dict[str, float] = {}
        for r in self.records:
            if not r.is_bridge:
                continue
            out[r.staging] = out.get(r.staging, 0.0) + r.duration_s
        return out

    def fresh_share(self) -> float:
        """Fraction of recorded *crossing* seconds spent in fresh-staged
        crossings — the §5.2 headline class's share of this tape
        (bridge_opt's target; compute time is not part of the denominator,
        so charging compute cannot dilute a staging regression)."""
        total = self.crossing_seconds()
        if total <= 0:
            return 0.0
        return self.staging_seconds().get("fresh", 0.0) / total

    def tag_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for r in self.records:
            for t in r.tags:
                out[t] = out.get(t, 0) + 1
        return out

    def wall_span_s(self) -> float:
        if not self.records:
            return 0.0
        return (max(r.t_end for r in self.records)
                - min(r.t_start for r in self.records))

    def select(self, op_classes: Iterable[str]) -> "BridgeTape":
        keep = frozenset(op_classes)
        return BridgeTape(meta=self.meta,
                          records=[r for r in self.records
                                   if r.op_class in keep])

    # -- serialization ------------------------------------------------------------------

    def to_dict(self) -> dict:
        return {"format": self.format, "meta": self.meta.to_dict(),
                "records": [r.to_dict() for r in self.records]}

    @classmethod
    def from_dict(cls, d: dict) -> "BridgeTape":
        fmt = d.get("format", "")
        prefix, _, version = fmt.rpartition("/v")
        if prefix != "bridge-tape" or not version.isdigit():
            raise TapeFormatError(f"not a bridge tape: format={fmt!r}")
        if int(version) not in READABLE_VERSIONS:
            raise TapeFormatError(
                f"unsupported tape version {fmt!r} (this reader speaks "
                f"{TAPE_FORMAT}); regenerate the tape — see DESIGN.md §5")
        return cls(meta=TapeMeta.from_dict(d["meta"]),
                   records=[TapeRecord.from_dict(r) for r in d["records"]],
                   format=fmt)

    def to_json(self, *, indent: Optional[int] = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "BridgeTape":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "BridgeTape":
        with open(path) as f:
            return cls.from_json(f.read())
