"""Profiler accounting loop (paper §5.2).

The paper attributes the dense-decode CC gap by grouping profiled copy calls
into op classes and checing that (per-call delta x call count) closes the
observed end-to-end slowdown: 1,138 `aten::_to_copy` calls x 1,357 us/call =
1.54 s of the 1.56 s gap.

This module is the reusable form of that loop: the serving engine's
``TransferGateway`` records every crossing with its op class; ``attribute``
produces the Table-5.2-style accounting and verifies closure.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Iterable

US = 1e-6


@dataclass(frozen=True)
class CopyRecord:
    """One profiled crossing.

    The first four fields are the §5.2 accounting-loop minimum; the rest are
    the bridge-tape extension (trace/tape.py): where the crossing ran and
    when, so a recorded stream can be replayed, re-priced and checked against
    the bridge-law invariants.  Defaults keep hand-built accounting records
    (benchmarks) valid.
    """

    op_class: str       # e.g. "alloc_h2d" (fresh), "prealloc_copy", "prep_pinned"
    nbytes: int
    duration_s: float
    cc_on: bool
    direction: str = ""         # "h2d" | "d2h" ("" = unknown, pre-tape record)
    staging: str = ""           # "fresh" | "registered"
    channel: int = -1           # secure-channel/context id; -1 = engine-serial path
    t_start: float = 0.0        # virtual-clock interval of the crossing
    t_end: float = 0.0
    charged: bool = True        # False: wall-clock charge accounted elsewhere
    #: free-form provenance tags (e.g. arena_hit/arena_miss staging outcome)
    tags: tuple = ()
    #: interval kind: "crossing" (bridge traffic) or "compute" (device-local
    #: prefill/decode work priced by core.compute.ComputeModel — no bytes
    #: cross the bridge; direction/staging are empty by construction)
    kind: str = "crossing"
    #: which roofline term won for a compute record ("compute" | "memory";
    #: "" = unknown/crossing) — lets replay re-price at the matching parity
    #: factor instead of conservatively assuming compute-bound
    bound: str = ""
    #: constituent crossings fused into this one, as (op_class, nbytes)
    #: pairs — set by the coalescer so a fused flush stays un-fusable
    #: counterfactually (stall attribution, replay).  Empty for ordinary
    #: crossings; additive with default, so hand-built records stay valid.
    sources: tuple = ()
    #: quantized crossings (DESIGN.md §13): the full-width byte count the
    #: payload represents.  `nbytes` is what crossed the wire; `raw_bytes`
    #: is what it widens back to on device.  0 = not quantized (every
    #: pre-quant record), and the conformance Q-law demands
    #: 0 < nbytes <= raw_bytes whenever it is set.
    raw_bytes: int = 0
    #: codec id ("fp8" | "int8") for quantized crossings; "" otherwise
    codec: str = ""


@dataclass
class OpClassRow:
    op_class: str
    calls: int
    cc_off_avg_us: float
    cc_on_avg_us: float

    @property
    def per_call_slowdown(self) -> float:
        return self.cc_on_avg_us / max(self.cc_off_avg_us, 1e-9)

    @property
    def total_delta_s(self) -> float:
        return (self.cc_on_avg_us - self.cc_off_avg_us) * US * self.calls


@dataclass
class Attribution:
    rows: list[OpClassRow]
    total_gap_s: float

    @property
    def explained_s(self) -> float:
        return sum(r.total_delta_s for r in self.rows)

    @property
    def closure(self) -> float:
        """Fraction of the end-to-end gap explained by the op-class deltas."""
        if self.total_gap_s <= 0:
            return 1.0
        return self.explained_s / self.total_gap_s

    def dominant(self) -> OpClassRow:
        return max(self.rows, key=lambda r: r.total_delta_s)


def attribute(
    cc_off_records: Iterable[CopyRecord],
    cc_on_records: Iterable[CopyRecord],
    total_gap_s: float,
) -> Attribution:
    """Group paired CC-off/CC-on profiles by op class and close the accounting.

    Call counts are taken from the CC-on run (same workload => same counts;
    a mismatch larger than 2% raises, since it means the runs are not paired).
    """
    def group(records: Iterable[CopyRecord]) -> dict[str, list[float]]:
        g: dict[str, list[float]] = defaultdict(list)
        for r in records:
            g[r.op_class].append(r.duration_s)
        return g

    off, on = group(cc_off_records), group(cc_on_records)
    rows = []
    for op_class in sorted(on):
        if op_class not in off:
            raise ValueError(f"op class {op_class!r} missing from CC-off profile")
        n_on, n_off = len(on[op_class]), len(off[op_class])
        if abs(n_on - n_off) > 0.02 * max(n_on, n_off):
            raise ValueError(
                f"unpaired profiles for {op_class!r}: {n_off} CC-off vs {n_on} CC-on calls")
        rows.append(OpClassRow(
            op_class=op_class,
            calls=n_on,
            cc_off_avg_us=sum(off[op_class]) / n_off / US,
            cc_on_avg_us=sum(on[op_class]) / n_on / US,
        ))
    rows.sort(key=lambda r: r.total_delta_s, reverse=True)
    return Attribution(rows=rows, total_gap_s=total_gap_s)


def format_table(attr: Attribution) -> str:
    lines = [
        f"{'op class':<24}{'calls':>8}{'CC-off avg':>14}{'CC-on avg':>14}{'slowdown':>10}{'delta(s)':>10}"
    ]
    for r in attr.rows:
        lines.append(
            f"{r.op_class:<24}{r.calls:>8}{r.cc_off_avg_us:>12.1f}us{r.cc_on_avg_us:>12.1f}us"
            f"{r.per_call_slowdown:>9.1f}x{r.total_delta_s:>10.3f}"
        )
    lines.append(
        f"explained {attr.explained_s:.3f}s of {attr.total_gap_s:.3f}s gap "
        f"(closure {attr.closure:.1%}); dominant: {attr.dominant().op_class}"
    )
    return "\n".join(lines)
