"""Reuse-aware KV-cache offload (paper §6.2).

Under CC every byte across the bridge costs more, so offload must be
*evidence-driven*: the default spill-everything policy moves multi-GiB
device-to-host against MiB-scale restores; filtering to blocks observed at
least `store_threshold` times cut measured spill volume 2.3 GiB -> 2.3 MB
and improved CC-on warm TTFT 2.97x.

The manager tracks page-content observation counts, makes spill decisions
at eviction time, stores payloads host-side keyed by content hash, and
restores on prefix hits — all crossings priced through the TransferGateway
so policies are comparable on the virtual clock.

PyTorch counterpart of ``repro.serving.offload``.  Every tape record, stat
and charge is the reference's; what moves is real:

  * a spilled payload is a tensor on the gateway's device.  Quantized, it
    is encoded there and its wire bytes — the codes, then the scales'
    bytes (``QuantizedBlock.wire``) — cross to the host; unquantized, the
    payload crosses as its bytes.  The host store keeps what crossed;
  * a restore uploads those bytes (where the reference uploads wire-sized
    zeros), widens every block that holds codes with the dequant kernel
    (one launch for the whole restore) and keeps each restored tensor in
    ``restored``, keyed by content hash, for the caller to read.  An unquantized block
    comes back as the spilled tensor, bit for bit;
  * metadata-only and opaque (integer) blocks cross as wire-sized zeros,
    as in the reference, and restore nothing; a block the clamp keeps at
    full width (``wire_bytes == raw_bytes``) crosses as its own bytes.

With a fault injector on the gateway, the resilience layer's hooks are the
reference's: the degradation ladder's sync-restore rung forces the bulk
path, and an integrity reject after the transfer lands is charged as a
``RETRY`` re-send (charge only: no bytes move again, and ``restored`` holds
the same tensors as a fault-free restore's).
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.bridge_opt import CrossingCoalescer, pipelined_h2d
from repro_torch.core.bridge import Direction
from repro_torch.core.gateway import TransferGateway
from repro_torch.core.policy import OffloadPolicy
from repro_torch.quant import (QuantizedBlock, encode_payload, get_codec,
                               select_codec, split_wire)
from repro_torch.trace import opclasses as oc

logger = logging.getLogger(__name__)


@dataclass
class OffloadStats:
    spilled_blocks: int = 0
    spilled_bytes: int = 0
    skipped_blocks: int = 0
    restored_blocks: int = 0
    restored_bytes: int = 0
    restore_hits: int = 0
    restore_misses: int = 0
    # ---- pipelined restore (bridge_opt) ----------------------------------
    pipelined_restores: int = 0
    #: critical-path seconds the pipelined restores charged (pipeline fills)
    restore_fill_s: float = 0.0
    #: restore seconds moved off the critical path (vs a blocking drain)
    restore_overlap_s: float = 0.0
    # ---- resilience -------------------------------------------------------
    #: integrity-reject redos: pipelined restores re-send the whole prefix
    #: (one MAC stream), sync restores re-send one block
    restore_retries: int = 0
    #: restores the degradation ladder forced down the sync (bulk) path
    sync_restores_forced: int = 0
    #: on_restore_done subscribers that raised (isolated, logged, counted)
    callback_errors: int = 0
    # ---- intra-CVM fabric migration ---------------------------------------
    migrated_blocks: int = 0
    migrated_bytes: int = 0
    # ---- quantized crossings ----------------------------------------------
    quantized_spills: int = 0
    quantized_restores: int = 0
    #: wire bytes quantized spills/restores actually moved (raw totals stay
    #: in spilled_bytes/restored_bytes — the workload's full-width volume)
    spilled_wire_bytes: int = 0
    restored_wire_bytes: int = 0
    #: dequant compute charged on restore (ComputeModel.dequant_charge)
    dequant_s: float = 0.0


@dataclass
class HostBlock:
    token_hash: int
    payload_bytes: int
    seen_count: int
    #: the bytes that crossed to the host (uint8): the payload's own bytes,
    #: or a quantized spill's wire buffer; None when metadata-only
    payload: Optional[np.ndarray] = None
    #: quantized spill: wire bytes the block crosses at (0 = full width)
    #: and the codec that encoded it
    wire_bytes: int = 0
    codec: str = ""
    #: the encoded payload, its codes and scales viewed on the host copy
    qblock: Optional[QuantizedBlock] = None
    #: the spilled tensor's shape and dtype, to rebuild it on restore
    shape: tuple = ()
    dtype: Optional[torch.dtype] = None


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes, flat (uint8), on its device."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


class OffloadManager:
    def __init__(self, gateway: TransferGateway, policy: OffloadPolicy,
                 *, store_threshold: int = 2, block_bytes: int = 0,
                 coalescer: Optional[CrossingCoalescer] = None,
                 pipelined_restore: bool = False,
                 restore_chunk_bytes: int = 256 << 10,
                 kv_quant: str = "", accuracy_budget: float = 0.05,
                 compute_model=None,
                 obs=None):
        self.gateway = gateway
        self.policy = policy
        self.store_threshold = store_threshold
        self.block_bytes = block_bytes
        #: quantized crossings: when a codec is named, spills encode to wire
        #: bytes (what the bridge prices), restores move wire bytes back,
        #: widen them on the device and pay a dequant *compute* charge.  The
        #: codec must clear the accuracy budget or construction refuses.
        self.kv_codec = select_codec(kv_quant, accuracy_budget)
        #: core.compute.ComputeModel pricing dequant-on-restore; without one
        #: the widening is unpriced (byte accounting still exact)
        self.compute_model = compute_model
        #: optional obs.Observatory — spill/restore volumes land in its
        #: registry when attached
        self.obs = obs
        #: bridge_opt: metadata-only spills join the fused flush when present
        self.coalescer = coalescer
        #: bridge_opt: chunk + double-buffer restores over the channel pool
        #: (needs >= 2 pool contexts to overlap; falls back to bulk otherwise)
        self.pipelined_restore = pipelined_restore
        self.restore_chunk_bytes = restore_chunk_bytes
        self.host_store: dict[int, HostBlock] = {}
        self.seen_counts: dict[int, int] = {}
        self.stats = OffloadStats()
        #: restored tensors on the gateway's device, by content hash: f32 for
        #: a block that was widened, the spilled dtype for one that crossed
        #: as its own bytes.  Filled by ``restore``; the caller reads (and
        #: may pop) them.  On the card the widened tensors of one restore
        #: are views of one f32 buffer, which lives until the last of them
        #: is dropped.
        self.restored: dict[int, torch.Tensor] = {}
        #: virtual time the most recent restore fully lands — equals
        #: clock.now for blocking restores, the pipeline's completion for
        #: pipelined ones (legacy single-slot view; keyed restores read
        #: ``restore_done_t[key]``)
        self.last_restore_done_t: float = 0.0
        #: per-key pipeline completion: request key -> virtual time ITS
        #: restore fully lands (only keyed restores are tracked)
        self.restore_done_t: dict[str, float] = {}
        #: per-request restore-completion subscribers ``(key, done_t)``
        #: (ServingEngine.mark_restore)
        self.on_restore_done: list[Callable[[str, float], None]] = []

    # -- observation (prefix traffic feeds the evidence) --------------------------------

    def observe(self, token_hash: int) -> int:
        self.seen_counts[token_hash] = self.seen_counts.get(token_hash, 0) + 1
        return self.seen_counts[token_hash]

    def inventory(self) -> set[int]:
        """Content hashes restorable from the host store."""
        return set(self.host_store)

    def should_spill(self, token_hash: int) -> bool:
        if self.policy is OffloadPolicy.NO_OFFLOAD:
            return False
        if self.policy is OffloadPolicy.SPILL_ALL:
            return True
        return self.seen_counts.get(token_hash, 0) >= self.store_threshold

    # -- eviction ------------------------------------------------------------------------

    def evict(self, token_hash: int, payload: Optional[torch.Tensor] = None,
              payload_bytes: Optional[int] = None) -> bool:
        """Called when a page leaves the device pool; ``payload`` is its
        tensor on the gateway's device (None: metadata-only accounting).
        Returns True if the block crossed the bridge (spilled)."""
        if payload is not None and not isinstance(payload, torch.Tensor):
            raise TypeError(f"evict: payload must be a tensor on the "
                            f"gateway's device, got {type(payload).__name__}")
        nbytes = payload_bytes if payload_bytes is not None else (
            payload.nbytes if payload is not None else self.block_bytes)
        if token_hash in self.host_store:
            # content-addressed store: identical content never re-spills
            self.stats.skipped_blocks += 1
            return False
        if not self.should_spill(token_hash):
            self.stats.skipped_blocks += 1
            return False
        qb = None
        wire = 0
        host = None
        if self.kv_codec is not None:
            qb = encode_payload(self.kv_codec,
                                payload if payload is not None else nbytes)
            wire = qb.wire_bytes
            if self.coalescer is not None and payload is None:
                # sub-threshold metadata spills amortize into the fused
                # flush, at wire size
                self.coalescer.charge(wire, Direction.D2H,
                                      op_class=oc.KV_SPILL_D2H)
            else:
                # the bridge prices the *wire* bytes, and they are what
                # crosses: codes then scales, the payload's own bytes when
                # clamped, wire-sized zeros when there is nothing to encode
                if payload is None or qb.opaque:
                    wire_dev = torch.zeros(wire, dtype=torch.uint8,
                                           device=self.gateway.device)
                elif qb.clamped:
                    wire_dev = _as_bytes(payload)
                else:
                    wire_dev = qb.wire()
                host = self.gateway.d2h(wire_dev, op_class=oc.KV_SPILL_D2H,
                                        tags=(oc.QUANTIZED,),
                                        raw_bytes=qb.raw_bytes,
                                        codec=qb.codec)
                if payload is None:
                    host = None             # metadata-only: nothing kept
                elif not (qb.opaque or qb.clamped):
                    codes, scales = split_wire(torch.from_numpy(host),
                                               qb.codes.numel())
                    qb = dataclasses.replace(qb, codes=codes, scales=scales)
            self.stats.quantized_spills += 1
            self.stats.spilled_wire_bytes += wire
        elif payload is not None:
            host = self.gateway.d2h(_as_bytes(payload),
                                    op_class=oc.KV_SPILL_D2H)
        elif self.coalescer is not None:
            # sub-threshold metadata spills amortize into the fused flush
            self.coalescer.charge(nbytes, Direction.D2H,
                                  op_class=oc.KV_SPILL_D2H)
        else:
            # metadata-only spill: priced + recorded like any crossing so it
            # still appears on the bridge tape
            self.gateway.charge_crossing(nbytes, Direction.D2H,
                                         op_class=oc.KV_SPILL_D2H)
        self.host_store[token_hash] = HostBlock(
            token_hash, nbytes, self.seen_counts.get(token_hash, 0), host,
            wire_bytes=wire, codec=qb.codec if qb else "", qblock=qb,
            shape=tuple(payload.shape) if payload is not None else (),
            dtype=payload.dtype if payload is not None else None)
        self.stats.spilled_blocks += 1
        self.stats.spilled_bytes += nbytes
        if self.obs is not None:
            self.obs.registry.counter("offload/spilled_blocks").inc()
            self.obs.registry.counter("offload/spilled_bytes").inc(nbytes)
        return True

    # -- restore -------------------------------------------------------------------------

    def _widen(self, hits: list, arrived: list) -> list:
        """The restored tensor of each block from its uploaded bytes, or
        None where the wire held no content (metadata-only, opaque).  A
        block that crossed as its own bytes is viewed as the spilled
        tensor; every block that holds codes is widened by one
        ``decode_many`` (one dequant launch on the card)."""
        out = [None] * len(hits)
        coded = []
        for i, (block, dev) in enumerate(zip(hits, arrived)):
            qb = block.qblock
            if block.payload is None:
                continue
            if qb is None or qb.clamped:
                out[i] = dev.view(block.dtype).reshape(block.shape)
                continue
            if qb.opaque:
                continue
            codes, scales = split_wire(dev, qb.codes.numel())
            coded.append((i, dataclasses.replace(qb, codes=codes,
                                                 scales=scales)))
        if coded:
            widened = get_codec(coded[0][1].codec).decode_many(
                [qb for _, qb in coded])
            for (i, _), t in zip(coded, widened):
                out[i] = t
        return out

    def restore(self, token_hashes: list, *,
                key: Optional[str] = None) -> tuple[int, int]:
        """Restore a prefix's blocks from the host store.  Default: bulk,
        pooled, blocking (drained pattern).  With `pipelined_restore` and
        >= 2 pool contexts, the prefix is split into channel-sized chunks
        double-buffered across the pool so restore overlaps subsequent
        decode steps (only the pipeline fill blocks).  The restored tensors
        land in ``restored``.  `key` names the request whose KV this
        restore feeds; when given and blocks were restored, every
        `on_restore_done` subscriber is called with ``(key, done_t)``.
        Returns (hits, bytes_restored)."""
        hits = [self.host_store[h] for h in token_hashes if h in self.host_store]
        misses = len(token_hashes) - len(hits)
        self.stats.restore_hits += len(hits)
        self.stats.restore_misses += misses
        total = sum(b.payload_bytes for b in hits)
        done_t = self.gateway.clock.now
        faults = getattr(self.gateway, "faults", None)
        ladder = faults.ladder if faults is not None else None
        if hits:
            quantized = any(b.codec for b in hits)
            if quantized:
                # the bridge moves each block's *wire* bytes; the raw width
                # rides on the record for the un-quantize replay, and the
                # widening itself is charged as dequant compute below
                payloads = [b.payload if b.payload is not None
                            else np.zeros(b.wire_bytes or b.payload_bytes,
                                          np.uint8) for b in hits]
                raw_list = [b.payload_bytes if b.codec else 0 for b in hits]
                codec = next(b.codec for b in hits if b.codec)
                wire_total = sum(p.nbytes for p in payloads)
            else:
                payloads = [b.payload if b.payload is not None
                            else np.zeros(b.payload_bytes, np.uint8)
                            for b in hits]
                raw_list, codec = None, ""
                wire_total = total
            sync_forced = ladder is not None and ladder.sync_restore_forced
            use_pipelined = (self.pipelined_restore
                             and self.gateway.pool.n_workers >= 2
                             and not sync_forced)
            if use_pipelined:
                arrived, result = pipelined_h2d(
                    self.gateway, payloads,
                    chunk_bytes=max(1, self.restore_chunk_bytes),
                    tags=(oc.QUANTIZED,) if quantized else (),
                    raw_total=total if quantized else 0,
                    codec=codec)
                self.stats.pipelined_restores += 1
                self.stats.restore_fill_s += result.fill_s
                self.stats.restore_overlap_s += result.overlap_s
                done_t = result.done_t
            else:
                if self.pipelined_restore and sync_forced:
                    self.stats.sync_restores_forced += 1
                arrived = self.gateway.bulk_h2d_pooled(
                    payloads,
                    op_class=oc.KV_RESTORE_Q if quantized
                    else oc.KV_RESTORE_H2D,
                    tags=(oc.QUANTIZED,) if quantized else (),
                    raw_bytes=raw_list, codec=codec)
                done_t = self.gateway.clock.now
            for block, restored in zip(hits, self._widen(hits, arrived)):
                if restored is not None:
                    self.restored[block.token_hash] = restored
            if quantized:
                self.stats.quantized_restores += 1
                self.stats.restored_wire_bytes += wire_total
                if self.compute_model is not None:
                    # widening back to full width is device compute, engine-
                    # serial (the kernels/dequant pass) — never bridge time
                    dq = self.compute_model.dequant_charge(total, wire_total)
                    self.gateway.charge_compute(
                        dq.seconds, op_class=oc.DEQUANT_COMPUTE,
                        tags=(oc.QUANTIZED,), bound=dq.bound)
                    self.stats.dequant_s += dq.seconds
                    done_t = max(done_t, self.gateway.clock.now)
            if faults is not None:
                # integrity verify after the transfer lands.  The pipelined
                # path MACs the whole prefix as one stream, so a reject
                # re-sends everything; the sync path verifies per block and
                # re-sends exactly one (the asymmetry the sync-restore rung
                # trades for).  Redos are bounded by the restore policy and
                # the final verify is forced clean.  A redo is charged, not
                # executed: what already landed in ``restored`` stands.
                attempt = 0
                while faults.restore_corrupted(attempt, key=key or ""):
                    # redos re-send what actually crosses: wire bytes for a
                    # quantized restore, full width otherwise
                    if use_pipelined:
                        redo_bytes = wire_total
                    else:
                        b = hits[attempt % len(hits)]
                        redo_bytes = ((b.wire_bytes or b.payload_bytes)
                                      if quantized else b.payload_bytes)
                    redo = self.gateway.charge_crossing(
                        redo_bytes, Direction.H2D,
                        op_class=oc.KV_RESTORE_H2D, tags=(oc.RETRY,))
                    faults.note_restore_redo(redo)
                    self.stats.restore_retries += 1
                    done_t = max(done_t, self.gateway.clock.now)
                    attempt += 1
            self.stats.restored_blocks += len(hits)
            self.stats.restored_bytes += total
            if key is not None:
                # per-key completion: concurrent keyed restores each keep
                # their own landing time
                self.restore_done_t[key] = max(
                    done_t, self.restore_done_t.get(key, 0.0))
                for cb in list(self.on_restore_done):
                    # a raising subscriber must not poison the completion
                    # path for its peers; isolate, log, count
                    try:
                        cb(key, done_t)
                    except Exception:
                        self.stats.callback_errors += 1
                        logger.exception(
                            "on_restore_done subscriber %r failed for "
                            "key=%r", cb, key)
            if self.obs is not None:
                self.obs.registry.counter("offload/restores").inc()
                self.obs.registry.histogram(
                    "offload/restore_bytes").observe(total)
                self.obs.registry.histogram(
                    "offload/restore_inflight_s").observe(
                        max(0.0, done_t - self.gateway.clock.now))
        self.last_restore_done_t = done_t
        return len(hits), total

    # -- intra-CVM migration -------------------------------------------------------------

    def migrate(self, token_hashes: list) -> tuple[int, int]:
        """Move resident KV blocks between a TP tenant's devices over the
        fabric (``gateway.p2p``: never the bridge).  Only blocks present in
        the host-visible store are movable.  Returns ``(blocks_moved,
        bytes_moved)``; the move itself is priced, not executed."""
        hits = [self.host_store[h] for h in token_hashes
                if h in self.host_store]
        total = sum(b.payload_bytes for b in hits)
        if hits:
            self.gateway.p2p(total, op_class=oc.P2P_KV_MIGRATE)
            self.stats.migrated_blocks += len(hits)
            self.stats.migrated_bytes += total
            if self.obs is not None:
                self.obs.registry.counter("offload/migrated_blocks").inc(
                    len(hits))
                self.obs.registry.counter("offload/migrated_bytes").inc(total)
        return len(hits), total


def churn_workload(manager: OffloadManager, *, n_requests: int,
                   prefix_blocks: int, unique_blocks: int,
                   block_bytes: int, churn: int = 3) -> OffloadStats:
    """The §6.2 churn shape: `n_requests` share a `prefix_blocks`-long prefix
    but the pool only fits one request's working set, so every request evicts
    its predecessor's pages (churn) and restores the shared prefix.

    Under SPILL_ALL every unique block spills each round (multi-GiB D2H);
    REUSE_AWARE spills only the shared prefix (seen >= threshold) — MiB scale.
    """
    manager.block_bytes = block_bytes
    prefix = [("prefix", i) for i in range(prefix_blocks)]
    for r in range(n_requests):
        uniq = [("req", r, i) for i in range(unique_blocks)]
        for h in prefix:
            manager.observe(hash(h))
        for h in uniq:
            manager.observe(hash(h))
        # restore shared prefix if available (warm TTFT path)
        manager.restore([hash(h) for h in prefix])
        # request finishes; pool churns: everything evicts
        for h in prefix + uniq:
            manager.evict(hash(h), payload_bytes=block_bytes)
    return manager.stats
