"""Request-lifecycle spans and the Observatory bundle.

A request's life on a CC replica is
``enqueue -> admit -> prefill -> first token -> decode steps -> finish``,
with two CC-specific detours: a *restore wait* when the slot's KV must cross
the bridge back before prefill/decode may touch it, and *preemption* when
the engine evicts the slot mid-decode.  The tracker turns those lifecycle
events into the SLO histograms the ROADMAP's production-traffic arc needs:

  ``req/queue_wait_s``    enqueue -> (last) admit
  ``req/ttft_s``          enqueue -> first emitted token
  ``req/tpot_s``          per-decode-step inter-token gap (after the first)
  ``req/restore_wait_s``  seconds blocked on a restore barrier, per request
  ``req/e2e_s``           enqueue -> finish

all labeled by request class so multi-tenant runs can slice per tenant.

Events are tolerant of the engine's actual call order: a replica restores a
warm prefix *before* the scheduler enqueues, and the engine overwrites
``enqueue_t`` with its own clock on submit — so any event creates the span
on first touch, and ``on_enqueue`` is last-wins (the replica re-calls it
with the true arrival time after submit).

``Observatory`` is the per-replica bundle the rest of the repo wires in:
one MetricsRegistry + one SpanTracker + a gateway hook that streams every
``CopyRecord`` (crossings and compute) into bridge-level counters.  It is
passive — it never reads or advances the virtual clock — so attaching it
cannot change a tape, a schedule, or a golden stream.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .metrics import MetricsRegistry


@dataclass
class RequestSpan:
    """One request's lifecycle timestamps (virtual-clock seconds)."""

    req_id: str
    request_class: str = "default"
    enqueue_t: Optional[float] = None
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    restore_wait_s: float = 0.0
    token_times: List[float] = field(default_factory=list)
    n_admissions: int = 0
    n_preemptions: int = 0
    outcome: str = ""  # "finish" once released for good

    # -- derived SLO quantities (None until the inputs exist) ---------------------------

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.enqueue_t is None or self.admit_t is None:
            return None
        return max(0.0, self.admit_t - self.enqueue_t)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.enqueue_t is None or self.first_token_t is None:
            return None
        return max(0.0, self.first_token_t - self.enqueue_t)

    @property
    def e2e_s(self) -> Optional[float]:
        if self.enqueue_t is None or self.finish_t is None:
            return None
        return max(0.0, self.finish_t - self.enqueue_t)

    def tpot_samples(self) -> List[float]:
        """Inter-token gaps after the first token (time-per-output-token)."""
        ts = self.token_times
        return [max(0.0, b - a) for a, b in zip(ts, ts[1:])]

    def to_dict(self) -> dict:
        return {
            "req_id": self.req_id,
            "request_class": self.request_class,
            "enqueue_t": self.enqueue_t,
            "admit_t": self.admit_t,
            "first_token_t": self.first_token_t,
            "finish_t": self.finish_t,
            "restore_wait_s": self.restore_wait_s,
            "n_tokens": len(self.token_times),
            "n_admissions": self.n_admissions,
            "n_preemptions": self.n_preemptions,
            "outcome": self.outcome,
        }


class SpanTracker:
    """Collects RequestSpans and feeds the SLO histograms on finish."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 **base_labels: str):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.base_labels = {str(k): str(v) for k, v in base_labels.items()}
        self.spans: Dict[str, RequestSpan] = {}

    def _span(self, req_id: str) -> RequestSpan:
        return self.spans.setdefault(req_id, RequestSpan(req_id=req_id))

    def _labels(self, span: RequestSpan) -> Dict[str, str]:
        return {**self.base_labels, "request_class": span.request_class}

    # -- lifecycle events ---------------------------------------------------------------

    def on_enqueue(self, req_id: str, t: float,
                   request_class: Optional[str] = None) -> None:
        """Arrival. Last-wins: the engine stamps submit-time, then the
        replica re-stamps the true arrival time after scheduler.submit."""
        span = self._span(req_id)
        span.enqueue_t = float(t)
        if request_class is not None:
            span.request_class = str(request_class)

    def on_admit(self, req_id: str, t: float) -> None:
        span = self._span(req_id)
        span.n_admissions += 1
        # queue_wait measures the first admission; re-admissions after a
        # preempt are decode-path latency, already visible in tpot/e2e
        if span.admit_t is None:
            span.admit_t = float(t)

    def on_restore_wait(self, req_id: str, wait_s: float) -> None:
        if wait_s > 0.0:
            self._span(req_id).restore_wait_s += float(wait_s)

    def on_token(self, req_id: str, t: float) -> None:
        """A token was emitted (the first one sets first_token_t)."""
        span = self._span(req_id)
        if span.first_token_t is None:
            span.first_token_t = float(t)
        span.token_times.append(float(t))

    def on_preempt(self, req_id: str, t: float) -> None:
        span = self._span(req_id)
        span.n_preemptions += 1
        self.registry.counter("req/preemptions",
                              **self._labels(span)).inc()

    def on_finish(self, req_id: str, t: float) -> None:
        span = self._span(req_id)
        span.finish_t = float(t)
        span.outcome = "finish"
        labels = self._labels(span)
        self.registry.counter("req/finished", **labels).inc()
        for name, value in (("req/queue_wait_s", span.queue_wait_s),
                            ("req/ttft_s", span.ttft_s),
                            ("req/e2e_s", span.e2e_s),
                            ("req/restore_wait_s", span.restore_wait_s)):
            if value is not None:
                self.registry.histogram(name, **labels).observe(value)
        tpot = self.registry.histogram("req/tpot_s", **labels)
        for gap in span.tpot_samples():
            tpot.observe(gap)

    # -- views --------------------------------------------------------------------------

    def finished(self) -> List[RequestSpan]:
        return [s for s in self.spans.values() if s.outcome == "finish"]

    def snapshot(self) -> dict:
        done = self.finished()
        return {
            "n_spans": len(self.spans),
            "n_finished": len(done),
            "spans": [s.to_dict() for s in
                      sorted(self.spans.values(), key=lambda s: s.req_id)],
        }


class Observatory:
    """Per-replica telemetry bundle: registry + spans + gateway hook.

    One Observatory serves one clock domain (a replica, or a bare engine).
    ``attach_gateway`` subscribes to ``TransferGateway.on_record`` and turns
    every CopyRecord into bridge counters/histograms; it is idempotent per
    gateway.  ``merge`` folds many observatories into a fleet view (metric
    merge is associative; span dicts union — req_ids are replica-prefixed
    upstream so they never collide).
    """

    def __init__(self, **base_labels: str):
        self.labels = {str(k): str(v) for k, v in base_labels.items()}
        self.registry = MetricsRegistry()
        self.spans = SpanTracker(self.registry, **self.labels)
        self._attached: List[object] = []

    # -- gateway wiring -----------------------------------------------------------------

    def attach_gateway(self, gateway) -> None:
        if any(g is gateway for g in self._attached):
            return
        gateway.on_record.append(self._on_record)
        self._attached.append(gateway)

    def detach(self) -> None:
        for gateway in self._attached:
            if self._on_record in gateway.on_record:
                gateway.on_record.remove(self._on_record)
        self._attached.clear()

    def _on_record(self, record) -> None:
        """CopyRecord stream -> bridge metrics. Must stay cheap: this runs
        on every crossing and every charged compute interval."""
        labels = {**self.labels, "op_class": record.op_class}
        if getattr(record, "kind", "crossing") == "compute":
            self.registry.counter("engine/compute_s", **self.labels).inc(
                record.t_end - record.t_start)
            return
        self.registry.counter("bridge/crossings", **labels).inc()
        self.registry.counter("bridge/bytes", **labels).inc(record.nbytes)
        if record.charged:
            self.registry.histogram("bridge/crossing_s", **labels).observe(
                record.t_end - record.t_start)
        else:
            self.registry.counter("bridge/uncharged_crossings",
                                  **labels).inc()

    # -- views --------------------------------------------------------------------------

    def snapshot(self) -> dict:
        return {"labels": dict(self.labels),
                "metrics": self.registry.snapshot(),
                "spans": self.spans.snapshot()}

    @classmethod
    def merge(cls, observatories) -> "Observatory":
        out = cls()
        for o in observatories:
            out.registry.merge_in(o.registry)
            out.spans.spans.update(o.spans.spans)
        return out
