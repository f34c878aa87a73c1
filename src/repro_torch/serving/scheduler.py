"""Request scheduler wrapped around the engine: admission control, straggler
mitigation, and preemption — the fault-tolerance layer a production serving
deployment needs at thousand-node scale.

Straggler policy: a request whose per-step wall time exceeds
`straggler_factor` x the fleet EMA for `patience` consecutive steps is
preempted and requeued (its slot freed) — the serving-side analogue of the
train loop's straggler watchdog.  Preemption also fires on pool exhaustion:
newest requests yield pages first (LIFO), matching vLLM semantics.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .engine import Request, ServingEngine


@dataclass
class SchedulerConfig:
    straggler_factor: float = 4.0
    patience: int = 3
    max_queue: int = 4096
    admission_burst: int = 64


class Scheduler:
    def __init__(self, engine: ServingEngine, cfg: Optional[SchedulerConfig] = None):
        self.engine = engine
        self.cfg = cfg or SchedulerConfig()
        self._ema_dt: Optional[float] = None
        self._slow_streak: dict[str, int] = {}
        self.preemptions = 0
        self.rejected = 0

    def submit(self, req: Request) -> bool:
        if len(self.engine.queue) >= self.cfg.max_queue:
            self.rejected += 1
            return False
        self.engine.submit(req)
        return True

    def tick(self) -> int:
        """One scheduled engine step with straggler accounting."""
        t0 = time.perf_counter()
        stepped = self.engine.step()
        dt = time.perf_counter() - t0
        if stepped == 0:
            return 0
        self._ema_dt = dt if self._ema_dt is None else \
            0.9 * self._ema_dt + 0.1 * dt
        if self._ema_dt and dt > self.cfg.straggler_factor * self._ema_dt:
            self._handle_straggler()
        return stepped

    def preempt_for_pool(self, pool, n_tokens: int,
                         tables: dict[str, list[int]]) -> list[str]:
        """LIFO pool-exhaustion preemption: newest active requests yield
        their pages first (vLLM semantics) until `n_tokens` fits in `pool`.

        `tables` maps request_id -> page table; preempted entries are popped
        and their pages released.  Returns the preempted request ids, newest
        first.  Stops (without destroying the victim's work) when the newest
        active request holds no pages — preempting it would free nothing.
        """
        preempted: list[str] = []
        while (len(pool.free) < pool.pages_needed(n_tokens)
               and self.engine.active):
            newest = max(self.engine.active.values(),
                         key=lambda r: (r.enqueue_t, r.request_id))
            table = tables.pop(newest.request_id, None)
            if table is None:
                break
            pool.release(table)
            self.engine._release(newest, state="preempted")
            self.preemptions += 1
            preempted.append(newest.request_id)
        return preempted

    def _handle_straggler(self) -> None:
        """Preempt the newest active request (LIFO) and requeue it."""
        if not self.engine.active:
            return
        newest = max(self.engine.active.values(), key=lambda r: r.enqueue_t)
        self._slow_streak[newest.request_id] = \
            self._slow_streak.get(newest.request_id, 0) + 1
        if self._slow_streak[newest.request_id] >= self.cfg.patience:
            self.engine._release(newest, state="preempted")
            self.preemptions += 1
            self._slow_streak.pop(newest.request_id, None)

    def run(self, max_ticks: int = 100_000) -> dict:
        ticks = 0
        while (self.engine.queue or self.engine.active) and ticks < max_ticks:
            if self.tick() == 0 and not self.engine.queue:
                break
            ticks += 1
        stats = self.engine.stats()
        stats.update(preemptions=self.preemptions, rejected=self.rejected)
        return stats
