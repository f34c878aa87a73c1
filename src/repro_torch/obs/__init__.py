"""repro_torch.obs — the bridge observatory (telemetry on the virtual clock).

  * metrics.py   label-keyed counters/gauges/histograms with exact
                 percentiles, snapshot-able, associatively mergeable
  * spans.py     request-lifecycle spans (enqueue -> ... -> finish) and the
                 per-replica ``Observatory`` bundle wired into
                 ``TransferGateway.on_record``

Stall attribution (``stalls.py``) and the Perfetto export (``timeline.py``)
are still to port (ROADMAP.md, Queue 1 item 5).

The observatory is passive: it never reads or advances the virtual clock,
so enabling it cannot change a schedule, a tape, or a golden stream.
"""

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      SNAPSHOT_PERCENTILES, percentile)
from .spans import Observatory, RequestSpan, SpanTracker

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "SNAPSHOT_PERCENTILES", "percentile",
    "Observatory", "RequestSpan", "SpanTracker",
]
