"""CC-aware context-pooled model loader (paper §6.1).

The loader ladder, each variant one bridge-law lesson:

  baseline        serialized parse + stage + single-context transfer
                  (287 s for GPT-OSS-120B — identical on B300 and Pro 6000:
                  the tell that the bottleneck is the software path)
  threads8        parallel host staging, transfers still one context
  fastsafetensors zero-copy parse; single-context transfer now dominates
  naive_pool      per-use secure contexts: lifecycle on the critical path
                  (5.2 s create + 3.9 s destroy per 8 workers — 253.66 s)
  pooled          persistent 8-worker context pool (bandwidth from contexts,
                  L4): 19.99 s
  prewarmed       pool prewarmed before the weight iterator, torn down
                  asynchronously after: lifecycle off the critical path
                  entirely — 8.36 s

PyTorch counterpart of ``repro.loader.pooled_loader``.  `load()` moves the
real tensors onto the device (one upload a tensor, through the gateway
module's ``_to_device``, where the reference calls ``jax.device_put``) while charging each variant's modeled time to the
virtual clock, exactly as the reference charges it; component rates are
calibrated to the paper's measured ladder (constants below, validated in
benchmarks).  Weight-only quantization changes the charges only: the
tensors returned are the checkpoint's full-width values, as in the
reference.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.bridge import BridgeModel, Direction, StagingKind
from repro_torch.core.channels import SecureChannelPool, VirtualClock
from repro_torch.core.gateway import TransferGateway
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.trace import opclasses as oc

from .sharded_weights import ShardedCheckpoint, _np_dtype, as_torch

GB = 1e9


class LoaderVariant(enum.Enum):
    BASELINE = "baseline"
    THREADS8 = "threads8"
    FASTSAFETENSORS = "fastsafetensors"
    NAIVE_POOL = "naive_pool"
    POOLED = "pooled"
    PREWARMED = "prewarmed"


@dataclass(frozen=True)
class LoaderRates:
    """Host-path component rates (calibrated to the paper's B300 ladder)."""

    #: single-thread deserialize+pin+copy staging rate (the 287 s bottleneck)
    host_stage_rate: float = 0.2252 * GB
    #: staging thread-scaling efficiency (8 threads -> 56.82 s)
    thread_efficiency: float = 0.6878
    #: zero-copy (mmap) read rate, single stream (fastsafetensors path)
    disk_read_rate: float = 2.065 * GB
    #: zero-copy read scaling across pool workers
    disk_parallel_efficiency: float = 0.65
    #: same-GPU peer-copy assembly rate (26.8-32.7 GB/s observed)
    assemble_rate: float = 30.0 * GB
    #: naive per-use context churn: context (re)creates per load
    #: (per-transfer-group secure-context thrash measured at 253.66 s)
    naive_context_uses: int = 196


class PooledLoader:
    def __init__(self, bridge: BridgeModel, *, n_workers: int = 8,
                 rates: Optional[LoaderRates] = None,
                 clock: Optional[VirtualClock] = None,
                 gateway: Optional[TransferGateway] = None,
                 arena=None,
                 weight_quant: str = "", accuracy_budget: float = 0.05):
        self.bridge = bridge
        self.n_workers = n_workers
        self.rates = rates or LoaderRates()
        #: weight-only quantization (DESIGN.md §13): shards cross at wire
        #: width (1/2–1/4 of the 34x path's bytes), the widening is a
        #: dequant compute term, and the codec must clear the accuracy
        #: budget or construction refuses
        self.weight_codec = None
        if weight_quant:
            from repro_torch.quant import select_codec
            self.weight_codec = select_codec(weight_quant, accuracy_budget)
        #: optional: when set, per-shard transfer crossings are recorded
        #: through the gateway (so loads appear on the bridge tape) and the
        #: loader shares its virtual clock
        self.gateway = gateway
        #: optional bridge_opt.StagingArena: shard staging becomes slab-backed
        #: — equal-sized shards share one registered slot, so only the first
        #: pays the fresh toll (the per-shard 44x component collapses)
        self.arena = arena
        if gateway is not None and clock is not None and clock is not gateway.clock:
            raise ValueError(
                "loader clock must be the gateway's clock when both are "
                "given: the load-time charge is split between the lump "
                "host-side components and per-shard gateway crossings, and "
                "splitting it across two clocks undercounts both")
        if gateway is not None and (
                gateway.bridge.profile.name != bridge.profile.name
                or gateway.bridge.cc_on != bridge.cc_on):
            raise ValueError(
                f"loader bridge ({bridge.profile.name}, cc_on={bridge.cc_on}) "
                f"must match the gateway's ({gateway.bridge.profile.name}, "
                f"cc_on={gateway.bridge.cc_on}): shard crossings are priced "
                f"by the loader but stamped with the gateway's tape meta")
        self.clock = clock or (gateway.clock if gateway else VirtualClock())

    # -- cost model (virtual clock) -------------------------------------------------------

    def modeled_load_time(self, total_bytes: int, n_shards: int,
                          variant: LoaderVariant, *,
                          staging: Optional[list[StagingKind]] = None) -> dict:
        """Per-component load-time breakdown in seconds.

        `staging` (one kind per shard, from the arena) replaces the default
        every-shard-FRESH toll: arena-hit shards pay the warm toll only.
        """
        r = self.rates
        p = self.bridge.profile
        single_bw = self.bridge.aggregate_bandwidth(Direction.H2D, 1)
        pool_bw = self.bridge.aggregate_bandwidth(Direction.H2D, self.n_workers)
        lifecycle = self.bridge.pool_lifecycle_cost(self.n_workers)
        # each shard's first transfer stages through a freshly pinned bounce
        # buffer: full fresh toll + allocation/registration (the 44x class)
        # — unless a staging arena turned the slot persistent
        fresh = p.cc_fresh_toll + p.cc_fresh_alloc
        if staging is None:
            toll = n_shards * fresh
        else:
            toll = sum(fresh if k is StagingKind.FRESH else p.cc_registered_toll
                       for k in staging)
        comp = {"stage": 0.0, "transfer": 0.0, "lifecycle": 0.0,
                "assemble": 0.0, "toll": toll}

        if variant is LoaderVariant.BASELINE:
            comp["stage"] = total_bytes / r.host_stage_rate
            comp["transfer"] = total_bytes / single_bw
        elif variant is LoaderVariant.THREADS8:
            comp["stage"] = total_bytes / (
                r.host_stage_rate * self.n_workers * r.thread_efficiency)
            comp["transfer"] = total_bytes / single_bw
        elif variant is LoaderVariant.FASTSAFETENSORS:
            comp["stage"] = total_bytes / r.disk_read_rate
            comp["transfer"] = total_bytes / single_bw
        elif variant is LoaderVariant.NAIVE_POOL:
            comp["stage"] = total_bytes / (
                r.disk_read_rate * self.n_workers * r.disk_parallel_efficiency)
            comp["transfer"] = total_bytes / single_bw   # churn kills overlap
            # per-use context churn: every transfer group pays create+destroy
            # on the critical path (measured 253.66 s — within 1.2x of the
            # 287 s baseline despite parallel reads: lifecycle ate the win)
            comp["lifecycle"] = r.naive_context_uses * (
                p.context_create + p.context_destroy)
            comp["assemble"] = total_bytes / r.assemble_rate
        elif variant in (LoaderVariant.POOLED, LoaderVariant.PREWARMED):
            comp["stage"] = total_bytes / (
                r.disk_read_rate * self.n_workers * r.disk_parallel_efficiency)
            comp["transfer"] = total_bytes / pool_bw
            comp["assemble"] = total_bytes / r.assemble_rate
            if variant is LoaderVariant.POOLED:
                # mid-load context creation breaks the read/transfer/assemble
                # pipeline: components serialize (paper: 19.99 s)
                comp["lifecycle"] = (lifecycle["create"] + lifecycle["destroy"]
                                     + lifecycle["pinned_alloc"])
            else:
                # prewarmed pool: transfers/assembly pipeline behind the
                # zero-copy reads; only the non-overlappable tail remains
                overlap = 0.35
                comp["transfer"] *= 1 - overlap
                comp["assemble"] *= 1 - overlap
        comp["total"] = sum(comp.values())
        return comp

    # -- weight-only quantization (DESIGN.md §13) ---------------------------------------------

    def shard_wire_bytes(self, ckpt: ShardedCheckpoint, shard: int) -> int:
        """Wire size of one shard under the weight codec: per tensor, one
        byte per value plus per-block scales (quant.wire_bytes), summed —
        the dtype-aware 1/2 (bf16) to 1/4 (f32) of the raw shard."""
        from repro_torch.quant import wire_bytes as quant_wire
        wire = 0
        for name in ckpt.shard_tensors(shard):
            meta = ckpt.index["tensors"][name]
            dt = _np_dtype(meta["dtype"])
            count = int(np.prod(meta["shape"])) if meta["shape"] else 1
            wire += quant_wire(count * dt.itemsize, itemsize=dt.itemsize)
        return wire

    # -- real load ---------------------------------------------------------------------------

    def load(self, ckpt: ShardedCheckpoint, variant: LoaderVariant,
             *, device: DeviceLike = None,
             tp_degree: int = 1) -> tuple[dict, dict]:
        """Load all tensors (real uploads to ``device``: the card unless the
        caller asks for the CPU), charging modeled time.

        ``tp_degree > 1`` adds tensor-parallel shard placement (DESIGN.md
        §12): the checkpoint crosses the bridge exactly once — the CVM
        ingress, the only toll-paying movement — and is then scattered to
        the tenant's other ``tp-1`` devices over the fabric, recorded as a
        ``p2p_shard_exchange`` crossing of ``(tp-1)/tp`` of the weight
        bytes.  Bridge bytes are identical to a TP=1 load; only fabric
        bytes grow with the degree.

        Returns (tensors, breakdown): tensors by name on ``device``, bf16
        as ``torch.bfloat16``.
        """
        if tp_degree < 1:
            raise ValueError(f"tp_degree must be >= 1, got {tp_degree}")
        device = resolve_device(device)
        total = ckpt.total_bytes()
        quantized = self.weight_codec is not None
        # everything byte-rated — staging reads, bridge transfer, assembly,
        # arena slabs — sees the *wire* width under weight-only quant; only
        # the per-shard tolls (count-priced) and the dequant term don't
        if quantized:
            xfer_shards = [self.shard_wire_bytes(ckpt, s)
                           for s in range(ckpt.n_shards)]
        else:
            xfer_shards = [ckpt.shard_bytes(s) for s in range(ckpt.n_shards)]
        xfer_total = sum(xfer_shards)
        kinds = tags = None
        if self.arena is not None:
            # satellite fix: slabs keyed by what actually stages (wire
            # bytes), so quantized shards hit the smaller size classes
            acq = [self.arena.acquire(xfer_shards[s])
                   for s in range(ckpt.n_shards)]
            kinds = [k for k, _ in acq]
            tags = [(t,) for _, t in acq]
        breakdown = self.modeled_load_time(xfer_total, ckpt.n_shards, variant,
                                           staging=kinds)
        if quantized:
            # widening wire -> full width on device: an HBM-bound stream
            # (read codes+scales, write raw) priced at the platform roofline;
            # profiles without a ComputeSpec charge nothing rather than
            # guessing (the byte accounting stays exact either way)
            try:
                from repro_torch.core.compute import spec_for_profile
                hbm_bw = spec_for_profile(self.bridge.profile.name).hbm_bw
                breakdown["dequant"] = self.bridge.hbm_time(
                    total + xfer_total, hbm_bw)
            except ValueError:
                breakdown["dequant"] = 0.0
            breakdown["total"] += breakdown["dequant"]
        # transfer + toll components are charged per shard through the
        # gateway when one is attached (same total, tape-visible crossings);
        # host-side components (stage/lifecycle/assemble) stay a lump charge
        per_shard = breakdown["transfer"] + breakdown["toll"]
        if self.gateway is not None:
            # dequant is charged below as a tape-visible compute record
            self.clock.advance(breakdown["total"] - per_shard
                               - breakdown.get("dequant", 0.0))
        else:
            self.clock.advance(breakdown["total"])

        pool = None
        if variant in (LoaderVariant.POOLED, LoaderVariant.PREWARMED):
            pool = SecureChannelPool(self.bridge, self.n_workers, clock=self.clock)
            if variant is LoaderVariant.PREWARMED:
                pool.prewarm()          # off the critical path by contract
            else:
                pool.ensure_ready()

        tensors = {}
        for shard in range(ckpt.n_shards):
            shard_bytes = 0
            for name, arr in ckpt.iter_shard(shard):
                shard_bytes += int(arr.nbytes)
                tensors[name] = as_torch(arr, ckpt.is_bf16(name), device)
            if self.gateway is not None:
                # staging matches the toll component the cost embeds (fresh
                # setup + alloc per shard without an arena; warm toll on
                # arena hits), so replaying a loader tape under the identity
                # counterfactual re-prices the same toll class
                wire_i = xfer_shards[shard] if quantized else shard_bytes
                frac = (wire_i / xfer_total if xfer_total
                        else 1.0 / ckpt.n_shards)
                p = self.bridge.profile
                if kinds is None:
                    toll_i = breakdown["toll"] / ckpt.n_shards
                    staging_i, tags_i = StagingKind.FRESH, ()
                else:
                    staging_i, tags_i = kinds[shard], tags[shard]
                    toll_i = (p.cc_fresh_toll + p.cc_fresh_alloc
                              if staging_i is StagingKind.FRESH
                              else p.cc_registered_toll)
                self.gateway.record_modeled(
                    wire_i, Direction.H2D,
                    breakdown["transfer"] * frac + toll_i,
                    op_class=(oc.WEIGHT_SHARD_Q if quantized
                              else oc.LOADER_SHARD_H2D),
                    staging=staging_i,
                    tags=(tuple(tags_i) + (oc.QUANTIZED,) if quantized
                          else tags_i),
                    raw_bytes=shard_bytes if quantized else 0,
                    codec=self.weight_codec.name if quantized else "")
        if quantized and self.gateway is not None and breakdown["dequant"] > 0:
            self.gateway.charge_compute(
                breakdown["dequant"], op_class=oc.DEQUANT_COMPUTE,
                tags=(oc.QUANTIZED,), bound="memory")
        if pool is not None:
            pool.teardown(async_=(variant is LoaderVariant.PREWARMED))
        if tp_degree > 1 and self.gateway is not None:
            # scatter each device's 1/tp slice from the ingress device over
            # the tenant fabric: (tp-1)/tp of the weights move as one
            # kind="p2p" exchange — no staging, no toll, no bridge bytes
            # (wire-width slices under quant: each device widens its own)
            exchange = int(xfer_total * (tp_degree - 1) / tp_degree)
            cost = self.gateway.p2p(exchange, op_class=oc.P2P_SHARD_EXCHANGE)
            breakdown["shard_exchange"] = cost
            breakdown["total"] += cost
        return tensors, breakdown
