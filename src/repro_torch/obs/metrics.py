"""Metrics registry — counters, gauges, histograms with exact percentiles.

The paper's diagnosis method *is* measurement (§5.2's op-class table located
the CC gap in the bridge, not compute), yet until this layer every subsystem
reported through its own ad-hoc dict.  The registry is the one shared sink:

  * **Counter**   monotone event count (crossings, flushes, decisions),
  * **Gauge**     last-written level (queue depth, overlap share),
  * **Histogram** full sample retention with *exact* streaming percentiles
                  (p50/p90/p99 match ``numpy.percentile`` bit-for-bit on the
                  same samples — SLO numbers must not be sketch artifacts).

Every metric is keyed by ``(name, labels)`` where labels are free-form
string pairs (replica/tenant/op-class/request-class), so one registry serves
a replica and a merged registry serves the fleet.  Snapshots are plain JSON
(``snapshot()``); registries merge associatively (``MetricsRegistry.merge``)
— counters add, histogram sample multisets union, gauges take the right
operand's value when it has one — which is what lets the cluster router
aggregate replica registries in any order and get the same answer (the
property suite pins associativity).

Sample retention is deliberate: the virtual-clock workloads this repo runs
are thousands of samples, not billions, and exactness is worth more than a
bounded sketch.  A production port would swap the Histogram backing store
for DDSketch/HDR without touching the registry surface.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

#: label key/value pairs, canonicalized to a sorted tuple for hashing
LabelKey = Tuple[Tuple[str, str], ...]

#: the percentiles every histogram snapshot exports
SNAPSHOT_PERCENTILES = (50.0, 90.0, 99.0)


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def percentile(values: Iterable[float], p: float) -> float:
    """Exact percentile with numpy's default ``linear`` interpolation.

    Mirrors ``numpy.percentile(values, p)`` including the lerp branch numpy
    takes for interpolation fractions >= 0.5 (``b - (b-a)*(1-t)`` instead of
    ``a + (b-a)*t``), so the registry's SLO numbers equal the numpy ones a
    notebook would compute from the same samples.
    """
    if not 0.0 <= p <= 100.0:
        raise ValueError(f"percentile must be in [0, 100], got {p}")
    vs = sorted(values)
    if not vs:
        raise ValueError("percentile of an empty sample set")
    n = len(vs)
    if n == 1:
        return float(vs[0])
    rank = (n - 1) * (p / 100.0)
    lo = int(math.floor(rank))
    hi = min(lo + 1, n - 1)
    t = rank - lo
    a, b = float(vs[lo]), float(vs[hi])
    if t >= 0.5:
        return b - (b - a) * (1.0 - t)
    return a + (b - a) * t


@dataclass
class Counter:
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters are monotone; cannot add {n}")
        self.value += n


@dataclass
class Gauge:
    value: float = 0.0
    #: True once set() has been called — merge() only lets a gauge that was
    #: actually written override the left operand's value
    written: bool = False

    def set(self, v: float) -> None:
        self.value = float(v)
        self.written = True


@dataclass
class Histogram:
    samples: List[float] = field(default_factory=list)

    def observe(self, v: float) -> None:
        self.samples.append(float(v))

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def sum(self) -> float:
        return float(sum(self.samples))

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.samples else 0.0

    def percentile(self, p: float) -> float:
        return percentile(self.samples, p)


class MetricsRegistry:
    """Label-keyed metric families, snapshot-able and mergeable."""

    def __init__(self):
        self._counters: Dict[Tuple[str, LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, LabelKey], Gauge] = {}
        self._histograms: Dict[Tuple[str, LabelKey], Histogram] = {}

    # -- get-or-create ------------------------------------------------------------------

    def counter(self, name: str, **labels: str) -> Counter:
        return self._counters.setdefault((name, _label_key(labels)), Counter())

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._gauges.setdefault((name, _label_key(labels)), Gauge())

    def histogram(self, name: str, **labels: str) -> Histogram:
        return self._histograms.setdefault((name, _label_key(labels)),
                                           Histogram())

    # -- cross-label reads (benchmark/router convenience) -------------------------------

    def counter_total(self, name: str) -> float:
        """Sum of a counter family across every label set."""
        return sum(c.value for (n, _), c in self._counters.items() if n == name)

    def histogram_values(self, name: str) -> List[float]:
        """All samples of a histogram family, merged across label sets."""
        out: List[float] = []
        for (n, _), h in self._histograms.items():
            if n == name:
                out.extend(h.samples)
        return out

    def family_percentile(self, name: str, p: float,
                          default: Optional[float] = None) -> Optional[float]:
        """Exact percentile over a histogram family's merged samples."""
        vs = self.histogram_values(name)
        if not vs:
            return default
        return percentile(vs, p)

    # -- snapshot -----------------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able view: sorted, deterministic, percentiles pre-computed."""

        def rows(metrics, render):
            out = []
            for (name, labels), m in sorted(metrics.items()):
                out.append({"name": name, "labels": dict(labels), **render(m)})
            return out

        def render_hist(h: Histogram) -> dict:
            row = {"count": h.count, "sum": h.sum,
                   "min": min(h.samples) if h.samples else None,
                   "max": max(h.samples) if h.samples else None}
            for p in SNAPSHOT_PERCENTILES:
                row[f"p{p:g}"] = h.percentile(p) if h.samples else None
            return row

        return {
            "counters": rows(self._counters, lambda c: {"value": c.value}),
            "gauges": rows(self._gauges, lambda g: {"value": g.value}),
            "histograms": rows(self._histograms, render_hist),
        }

    # -- merge (fleet aggregation) ------------------------------------------------------

    def merge_in(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold ``other`` into this registry (associative; returns self).

        Counters add; histogram sample multisets union; a gauge takes the
        right operand's value only when that operand actually wrote one —
        the rule that keeps ``(a+b)+c == a+(b+c)`` for every metric kind.
        """
        for key, c in other._counters.items():
            self.counter(key[0], **dict(key[1])).inc(c.value)
        for key, g in other._gauges.items():
            mine = self.gauge(key[0], **dict(key[1]))
            if g.written:
                mine.set(g.value)
        for key, h in other._histograms.items():
            self.histogram(key[0], **dict(key[1])).samples.extend(h.samples)
        return self

    @classmethod
    def merge(cls, registries: Iterable["MetricsRegistry"]) -> "MetricsRegistry":
        out = cls()
        for r in registries:
            out.merge_in(r)
        return out
