"""repro_torch.obs — the bridge observatory (telemetry on the virtual clock,
and ranges on the profiler's).

One layer, five instruments, every subsystem reports through it:

  * metrics.py   label-keyed counters/gauges/histograms with exact
                 percentiles, snapshot-able, associatively mergeable
  * spans.py     request-lifecycle spans (enqueue -> ... -> finish) and the
                 per-replica ``Observatory`` bundle wired into
                 ``TransferGateway.on_record``
  * stalls.py    §5.2-style stall attribution: every gap second of a tape
                 classified into the paper's causes, conserved exactly
  * timeline.py  Perfetto / chrome://tracing export of tapes + stalls
  * ranges.py    ``span``: wall-clock ranges of the engine, gateway, model
                 and kernels on the ``torch.profiler`` clock while it
                 records (one check and a no-op otherwise), with their
                 host totals by path

The observatory is passive: it never reads or advances the virtual clock,
so enabling it cannot change a schedule, a tape, or a golden stream.
"""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      SNAPSHOT_PERCENTILES, percentile)
from .ranges import clear_totals, span, totals
from .spans import Observatory, RequestSpan, SpanTracker
from .stalls import (CAUSE_DEFERRED, CAUSE_FLUSH, CAUSE_FRESH,
                     CAUSE_REATTEST, CAUSE_REESTABLISH, CAUSE_RESTORE,
                     CAUSE_RETRY, CAUSE_SERIAL, CAUSE_UNATTRIBUTED,
                     CAUSES, StallInterval, StallReport, attribute_stalls,
                     ladder_table)
from .timeline import export_timeline, tape_to_trace_events

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "SNAPSHOT_PERCENTILES", "percentile",
    "Observatory", "RequestSpan", "SpanTracker",
    "CAUSES", "CAUSE_DEFERRED", "CAUSE_FLUSH", "CAUSE_FRESH",
    "CAUSE_REATTEST", "CAUSE_REESTABLISH", "CAUSE_RESTORE", "CAUSE_RETRY",
    "CAUSE_SERIAL", "CAUSE_UNATTRIBUTED",
    "StallInterval", "StallReport", "attribute_stalls", "ladder_table",
    "export_timeline", "tape_to_trace_events",
    "span", "totals", "clear_totals",
]
