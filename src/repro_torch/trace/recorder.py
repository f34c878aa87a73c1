"""TraceRecorder — capture a TransferGateway's crossing stream into a tape.

The recorder subscribes to the gateway's ``on_record`` emit hook, so it sees
every crossing the moment it is priced — including crossings issued from
worker threads (the v10c drain) and pool-scheduled bulk transfers.  It is a
context manager; recording stops when it detaches, and ``tape()`` snapshots
what has been captured so far.
"""

from __future__ import annotations

import threading
from typing import Optional

from repro_torch.core.accounting import CopyRecord
from repro_torch.core.gateway import TransferGateway

from . import opclasses as oc
from .tape import BridgeTape, TapeMeta, TapeRecord


class TraceRecorder:
    def __init__(self, gateway: TransferGateway, *, policy: str = "",
                 label: str = "", extra: Optional[dict] = None):
        self.gateway = gateway
        self.meta = TapeMeta(
            profile=gateway.bridge.profile.name,
            cc_on=gateway.bridge.cc_on,
            policy=policy,
            pool_workers=gateway.pool.n_workers,
            label=label,
            extra=dict(extra or {}),
        )
        self._records: list[TapeRecord] = []
        self._lock = threading.Lock()
        self._attached = False

    # -- lifecycle ---------------------------------------------------------------------

    def attach(self) -> "TraceRecorder":
        if not self._attached:
            self.gateway.on_record.append(self._on_record)
            self._attached = True
        return self

    def detach(self) -> None:
        if self._attached:
            self.gateway.on_record.remove(self._on_record)
            self._attached = False

    def __enter__(self) -> "TraceRecorder":
        return self.attach()

    def __exit__(self, *exc) -> None:
        self.detach()

    # -- capture ------------------------------------------------------------------------

    def _on_record(self, rec: CopyRecord) -> None:
        with self._lock:
            self._records.append(TapeRecord.from_copy_record(rec))

    def tape(self) -> BridgeTape:
        with self._lock:
            return BridgeTape(meta=self.meta, records=list(self._records))

    def summary(self) -> dict:
        """Cheap live view of the captured stream (no tape snapshot): record
        and crossing counts plus the slot-masked decode markers — how many
        steps ran masked (one MASKED tag each) and how many slot-steps they
        deferred in total (one DEFERRED tag per deferred slot).  The
        bridge_opt restore-under-decode sweep reads this instead of
        snapshotting a full tape per probe."""
        with self._lock:
            n = len(self._records)
            compute = sum(1 for r in self._records if r.is_compute)
            masked = sum(1 for r in self._records if oc.MASKED in r.tags)
            deferred = sum(r.tags.count(oc.DEFERRED) for r in self._records)
        return {"records": n, "crossings": n - compute, "compute": compute,
                "masked_steps": masked, "deferred_slot_steps": deferred}


def record_gateway(gateway: TransferGateway, *, policy: str = "",
                   label: str = "", extra: Optional[dict] = None) -> TraceRecorder:
    """Attach a recorder to a live gateway (caller detaches or uses `with`)."""
    return TraceRecorder(gateway, policy=policy, label=label,
                         extra=extra).attach()
