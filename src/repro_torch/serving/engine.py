"""Continuous-batching serving engine with CC-aware scheduling policies.

PyTorch counterpart of ``repro.serving.engine``.  The engine is real:
requests, slot allocation, one-shot prefill, packed ragged decode over the
resident KV cache, per-slot sampling.  Every host<->device crossing goes
through the TransferGateway, which (a) executes the real copy to or from
the card and (b) charges the bridge-law cost of that crossing to the
engine's virtual clock, tagged with its op class.  The prompt, tokens,
positions and slot ids the model consumes are the tensors the gateway
moved, so every crossing on the tape is a real copy.

Policy structure per decode step (paper §5):
  SYNC_DRAIN    prep (batched, REGISTERED staging) -> forward -> sample ->
                one small D2H drain -> continue.
  ASYNC_OVERLAP vLLM default: drain issued "non-blocking" + per-step fresh
                staging for the scatter/sampling-index uploads.  Under CC
                the gateway blocks anyway (L2) and fresh staging pays the
                bounce-buffer toll (L3): the measured 44x op class.
  WORKER_DRAIN  v10c: the blocking drain runs on a real worker thread (a
                blocked crossing releases the GIL); the engine thread keeps
                preparing step N+1.  Input crossings return to warm staging.

Differences from the reference:
  * the model owns its weights (``models.model.Model``); ``seed`` seeds
    only the sampling generator (``seed + 1``, as the reference's key);
  * decode writes K/V in place and the paged kernel reads the resident
    cache (xLSTM, Mamba-2: the stepping rows' state is read at their slots
    and written back in place), so there is no gather/scatter of whole caches;
  * a packed step is padded, as the reference's is, but to one width, the
    engine's ``max_batch`` (``_bucket``), not to a power of two: on the
    card cuBLAS runs a projection's GEMM by one algorithm for M <= 8 rows
    and by another for M >= 17, so a row's bits would move with the
    step's width, and powers of two up to 8 are widths of their own.  The
    call takes the dense step's layout (row i is slot i) with each slot
    that does not step copying the first stepping row, whose writes carry
    identical values (``_decode_packed``).  Accounting prices the stepping
    rows, as in both packages;
  * with bridge_opt on (``cc_aware_defaults(..., bridge_opt=True)``)
    staging goes through a ``StagingArena`` and sub-threshold crossings
    through a ``CrossingCoalescer``, as in the reference; the tensors a
    coalesced upload returns are real uploads, so the model still reads
    what crossed.

Tensor parallelism is pricing only, as in the reference: a compute model
with ``tp_degree > 1`` adds each step's fabric allreduce to the clock
(``_charge_allreduce``) while one device runs the whole model, so token
streams are identical at every degree.
"""

from __future__ import annotations

import queue
import threading
import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.bridge_opt import CrossingCoalescer, StagingArena
from repro_torch.core.bridge import TPU_V5E, BridgeModel
from repro_torch.core.channels import VirtualClock
from repro_torch.core.compute import ComputeModel
from repro_torch.core.gateway import TransferGateway
from repro_torch.core.policy import (RuntimeDefaults, SchedulingPolicy,
                                     cc_aware_defaults)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model
from repro_torch.obs import Observatory, span
from repro_torch.trace import opclasses as oc

from .kv_cache import RaggedBatch
from .overlap import OverlapScheduler
from .sampler import SamplingParams, sample


@dataclass
class Request:
    request_id: str
    prompt: list
    sampling: SamplingParams = field(default_factory=SamplingParams)
    state: str = "queued"             # queued|running|finished|preempted
    output_tokens: list = field(default_factory=list)
    slot: int = -1
    index: int = 0                    # current sequence length in cache
    enqueue_t: float = 0.0
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    decode_steps: int = 0
    restarts: int = 0                 # straggler/preemption requeues
    #: prompt tokens whose prefill compute is already accounted elsewhere
    #: (a restored warm prefix, or an admission layer that prices prompt
    #: processing itself).  The engine charges compute only for the cold tail.
    warm_tokens: int = 0


@dataclass
class StepTrace:
    """One decode step's crossing profile (replayed by benchmarks)."""
    step: int
    active: int
    prep_crossings: int
    prep_bytes: int
    drain_bytes: int
    policy: str
    virtual_t: float
    #: slots that sat this step out because their KV restore pipeline was
    #: still draining (slot-masked decode; 0 on every unmasked step)
    deferred: int = 0
    #: rows the packed step stepped (its executed width is the engine's
    #: ``_bucket``); 0 on dense steps
    packed: int = 0


class ServingEngine:
    def __init__(self, model: Model, *, max_batch: int = 8, max_len: int = 256,
                 gateway: Optional[TransferGateway] = None,
                 policy: Optional[SchedulingPolicy] = None,
                 cc_on: bool = False,
                 bridge: Optional[BridgeModel] = None,
                 defaults: Optional[RuntimeDefaults] = None,
                 compute_model: Optional[ComputeModel] = None,
                 obs: Optional[Observatory] = None,
                 seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lies on {model.device}, engine asked "
                             f"for {self.device}")
        self.model = model
        self.cfg = model.cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.bridge = bridge or BridgeModel(TPU_V5E, cc_on=cc_on)
        self.defaults = defaults or cc_aware_defaults(self.bridge.cc_on)
        self.policy = policy or self.defaults.scheduling
        if gateway is None:
            # bridge_opt: staging becomes a budgeted arena when defaults ask
            arena = (StagingArena(self.defaults.staging_arena_bytes)
                     if self.defaults.staging_arena_bytes else None)
            gateway = TransferGateway(
                self.bridge, self.defaults,
                pool_workers=self.defaults.loader_pool_workers or 1,
                device=self.device, arena=arena)
        elif gateway.device != self.device:
            raise ValueError(f"gateway uploads to {gateway.device}, engine "
                             f"runs on {self.device}")
        self.gateway = gateway
        #: bridge_opt: sub-threshold crossings queue here and flush fused.
        #: Under WORKER_DRAIN the worker takes the fused D2H flushes off the
        #: engine clock (worker x coalescer composition).
        self.coalescer = (CrossingCoalescer(
            self.gateway,
            worker_flush=self.policy is SchedulingPolicy.WORKER_DRAIN)
            if self.defaults.coalesce_small_crossings else None)
        self.clock: VirtualClock = self.gateway.clock
        #: compute-charged clock: per-step prefill/decode compute priced by
        #: the roofline and charged like any interval
        self.compute = compute_model or (
            ComputeModel(self.cfg, self.bridge)
            if self.defaults.charge_compute else None)
        #: restore-aware scheduling: barrier is law, preference is a flag
        self.overlap = OverlapScheduler(
            self.clock, self.gateway.pool,
            prefer_overlap=self.defaults.overlap_scheduler)
        #: observatory: metric registry + request spans, fed from the
        #: gateway's record stream and the lifecycle points below.  Passive.
        self.obs = obs if obs is not None else (
            Observatory() if self.defaults.observability else None)
        if self.obs is not None:
            self.obs.attach_gateway(self.gateway)

        self.caches = model.init_cache(max_batch, max_len)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        #: every slot, for the dense step (all rows step, in slot order)
        self._all_slots = torch.arange(max_batch, device=self.device)

        self.free_slots = list(range(max_batch))
        self.queue: list[Request] = []
        self.active: dict[int, Request] = {}
        self.finished: list[Request] = []
        self.trace: list[StepTrace] = []
        self.step_count = 0
        self._worker: Optional[threading.Thread] = None
        self._drain_q: "queue.Queue" = queue.Queue()
        #: worker-drain join deadline at close(); a thread that outlives it
        #: is surfaced loudly (closed_dirty + RuntimeWarning)
        self.drain_join_timeout_s: float = 5.0
        self.closed_dirty = False
        # worker x coalescer composition: with a coalescer the drains queue
        # and the worker's seat is a secure channel the fused flushes
        # serialize on — prewarm the pool so the first flush never pays
        # context creation.  Without one the worker is a real thread doing
        # blocking drains.
        if self.policy is SchedulingPolicy.WORKER_DRAIN:
            if self.coalescer is None:
                self._start_worker()
            else:
                self.gateway.pool.prewarm()

    # -- worker thread (v10c) --------------------------------------------------------

    def _start_worker(self):
        def loop():
            while True:
                item = self._drain_q.get()
                if item is None:
                    return
                arr, cb = item
                host = self.gateway.d2h(arr, op_class=oc.WORKER_DRAIN)
                cb(host)
        self._worker = threading.Thread(target=loop, daemon=True)
        self._worker.start()

    def close(self):
        if self.coalescer is not None:
            self.coalescer.barrier()
        if self._worker is not None:
            self._drain_q.put(None)
            self._worker.join(timeout=self.drain_join_timeout_s)
            if self._worker.is_alive():
                self.closed_dirty = True
                warnings.warn(
                    f"ServingEngine.close(): worker drain thread failed to "
                    f"join within {self.drain_join_timeout_s}s — a drain is "
                    f"wedged and its crossing is stranded (closed_dirty=True)",
                    RuntimeWarning, stacklevel=2)
            self._worker = None

    # -- request lifecycle -------------------------------------------------------------

    def submit(self, request: Request) -> None:
        request.enqueue_t = self.clock.now
        request.state = "queued"
        self.queue.append(request)
        if self.obs is not None:
            self.obs.spans.on_enqueue(request.request_id, request.enqueue_t)

    def mark_restore(self, request_id: str, done_t: float) -> None:
        """Register that `request_id`'s KV restore lands at virtual `done_t`."""
        self.overlap.note_restore(request_id, done_t)

    def restore_barrier(self, request_id: str) -> float:
        """Block until the restore pipeline for `request_id` has drained.
        Returns virtual seconds waited."""
        return self.overlap.restore_barrier(request_id)

    def _admit(self) -> None:
        # restore-aware admission, as the reference: a request whose restore
        # is still draining defers while other work can fill the window
        if self.compute is not None:
            step_cost = self.compute.decode_step_masked_s(self._ready_lens())
        else:
            step_cost = 0.0
        i = 0
        admitted = False
        while self.free_slots and i < len(self.queue):
            req = self.queue[i]
            others = bool(self.active) or admitted or i + 1 < len(self.queue)
            if others and self.overlap.should_defer(req.request_id,
                                                    step_cost_s=step_cost):
                self.overlap.record_deferral(req.request_id)
                i += 1
                continue
            self.queue.pop(i)
            slot = self.free_slots.pop()
            with span("engine/admit", req.request_id):
                self._prefill_into_slot(req, slot)
            admitted = True

    def _ready_lens(self) -> list:
        """Per-slot KV lengths of the resident slots that would step now."""
        if not self.active:
            return []
        if self.defaults.slot_masked_decode and self.overlap.pending:
            key_of = {s: r.request_id for s, r in self.active.items()}
            mask = self.overlap.ready_mask(key_of)
            return [float(r.index) for s, r in self.active.items() if mask[s]]
        return [float(r.index) for r in self.active.values()]

    def _prefill_into_slot(self, req: Request, slot: int) -> None:
        if self.obs is not None:
            self.obs.spans.on_admit(req.request_id, self.clock.now)
        # first read of restored KV happens here: the barrier is the law
        waited = self.overlap.restore_barrier(req.request_id)
        if waited:
            self._poll()                # the barrier wait moved the clock
            if self.obs is not None:
                self.obs.spans.on_restore_wait(req.request_id, waited)
        prompt = np.asarray(req.prompt, np.int32)[None]     # (1, P)
        # prompt upload crosses the bridge (coalesced when bridge_opt is
        # on); the model reads what it moved
        up = self.coalescer or self.gateway
        prompt_dev = up.h2d(prompt, op_class=oc.PROMPT_H2D)
        logits, pre_cache, idx0 = self.model.prefill(prompt_dev, self.max_len)
        if self.compute is not None:
            cold = max(0, len(req.prompt) - req.warm_tokens)
            if cold:
                charge = self.compute.prefill_charge(cold)
                self.gateway.charge_compute(
                    charge.seconds, op_class=oc.PREFILL_COMPUTE,
                    bound=charge.bound)
                self._poll()            # prefill compute moved the clock
                # TP prefill allreduces over the prompt's activations (the
                # per-token payload is the same shape as a decode batch row)
                self._charge_allreduce(cold)
        self._insert_slot_cache(pre_cache, slot)
        first = sample(logits, self.generator, req.sampling)
        first_host = up.d2h(first, op_class=oc.SAMPLE_D2H)
        tok = int(first_host[0])
        req.output_tokens.append(tok)
        req.first_token_t = self.clock.now
        if self.obs is not None:
            self.obs.spans.on_token(req.request_id, req.first_token_t)
        req.state = "running"
        req.slot = slot
        req.index = idx0
        req.decode_steps = 0
        self.active[slot] = req

    def _insert_slot_cache(self, pre_cache, slot: int) -> None:
        """Copy a one-row prefill cache into ``slot`` of the resident cache,
        every top-level entry (``block0`` too): the slot axis is 1 for the
        leaves of a scan-stacked config's ``blocks`` and 0 elsewhere.  A
        leaf the prefill returns narrower (Mamba-2's bf16 conv history) is
        widened to the resident dtype, as the reference's ``.at[].set``
        does."""
        def walk(full, one, stacked: bool):
            if isinstance(full, dict):
                for key in full:
                    walk(full[key], one[key], stacked)
            elif isinstance(full, list):
                for f, o in zip(full, one):
                    walk(f, o, stacked)
            elif stacked:
                full[:, slot].copy_(one[:, 0])
            else:
                full[slot].copy_(one[0])

        for key, sub in self.caches.items():
            walk(sub, pre_cache[key], self.cfg.scan_layers and key == "blocks")

    def _release(self, req: Request, *, state: str = "finished") -> None:
        if req.slot >= 0:
            self.active.pop(req.slot, None)
            self.free_slots.append(req.slot)
            req.slot = -1
        req.state = state
        if state == "finished":
            req.finish_t = self.clock.now
            self.finished.append(req)
            if self.obs is not None:
                self.obs.spans.on_finish(req.request_id, req.finish_t)
        else:
            req.restarts += 1
            req.output_tokens.clear()
            self.queue.append(req)
            if self.obs is not None:
                self.obs.spans.on_preempt(req.request_id, self.clock.now)

    # -- degradation ladder (resilience) -----------------------------------------------

    def _ladder(self):
        """The fault injector's degradation ladder, when one is attached to
        the gateway (duck-typed: the engine never imports resilience)."""
        faults = getattr(self.gateway, "faults", None)
        return faults.ladder if faults is not None else None

    def _degraded_tags(self) -> tuple:
        """DEGRADED on every compute charge while the ladder sits above
        level 0: the tape shows exactly which intervals ran degraded."""
        ladder = self._ladder()
        if ladder is not None and ladder.level > 0:
            return (oc.DEGRADED,)
        return ()

    def _sync_ladder(self) -> None:
        """Per-step ladder bookkeeping: recovery hysteresis on the virtual
        clock, and the coalescer-bypass rung applied or released (entering
        bypass barrier-flushes both queues so nothing is stranded)."""
        ladder = self._ladder()
        if ladder is None:
            return
        ladder.maybe_recover(self.clock.now)
        if (self.coalescer is not None
                and self.coalescer.bypass != ladder.coalescer_bypassed):
            self.coalescer.set_bypass(ladder.coalescer_bypassed)

    # -- tensor-parallel allreduce -------------------------------------------------------

    def _charge_allreduce(self, batch: int) -> None:
        """Charge one step's TP ring allreduce over the tenant fabric.

        Only a TP>1 compute model owes one (a single-device replica has
        nothing to reduce, so TP=1 tapes carry no such record).  The bytes
        ride ``gateway.p2p``: kind="p2p", priced at the fabric rate (or the
        TCP fallback for a stale or unattested tenant), never the bridge.
        Execution is untouched: one device runs the whole model, which is
        why TP token streams are identical to TP=1's.
        """
        if self.compute is None or self.compute.tp_degree == 1:
            return
        nbytes = self.compute.allreduce_bytes(batch)
        if nbytes == 0:
            return
        # per-device clock skew: the ring closes when the slowest device
        # arrives, so the skew spread rides the p2p charge as extra seconds
        self.gateway.p2p(nbytes, op_class=oc.P2P_ALLREDUCE,
                         extra_s=self.compute.allreduce_skew_s())
        self._poll()            # the allreduce moved the clock

    # -- the decode step under each policy ------------------------------------------------

    def _ready_slots(self, slots: list) -> tuple[list, list]:
        """Split this step's slots into (ready, deferred) by restore state
        (slot-masked decode; every slot is ready without restores)."""
        if not self.defaults.slot_masked_decode or not self.overlap.pending:
            return list(slots), []
        key_of = {s: self.active[s].request_id for s in slots}
        mask = self.overlap.ready_mask(key_of)
        ready = [s for s in slots if mask[s]]
        deferred = [s for s in slots if not mask[s]]
        if not ready:
            # law, not preference: nothing can step — pay the nearest
            # pipeline's barrier, then re-ask
            nearest = min(
                deferred, key=lambda s: self.overlap.pending_done_t(key_of[s]))
            waited = self.overlap.restore_barrier(key_of[nearest])
            if waited:
                self._poll()            # the barrier wait moved the clock
                if self.obs is not None:
                    self.obs.spans.on_restore_wait(key_of[nearest], waited)
            mask = self.overlap.ready_mask(key_of)
            ready = [s for s in slots if mask[s]]
            deferred = [s for s in slots if not mask[s]]
        for s in ready:
            self.overlap.restore_barrier(key_of[s])
        for s in deferred:
            self.overlap.record_slot_deferral(key_of[s])
        if deferred:
            # deferral masks slots, never flushes: crossings queued by
            # deferred slots keep aging toward the coalescer's deadline
            self._poll(source="deferral")
        return ready, deferred

    def step(self) -> int:
        """One engine iteration; returns number of sequences stepped.

        With ``packed_decode`` on (the default) the step runs over exactly
        the ready slots (``_step_packed``); otherwise over every slot
        (``_step_dense``).  Greedy token streams are identical.  The
        degradation ladder's last rung forces the dense step.  While
        ``torch.profiler`` records, the step is the range ``engine/step``,
        with ``engine/admit`` (one per admitted request, its id as the
        range's args), ``engine/prep``, ``engine/decode``,
        ``engine/sample``, ``engine/drain`` and ``engine/consume`` inside."""
        with span("engine/step"):
            self._sync_ladder()
            self._admit()
            if not self.active:
                return 0
            self.step_count += 1
            slots = sorted(self.active)
            ready, deferred = self._ready_slots(slots)
            ladder = self._ladder()
            if self.defaults.packed_decode and not (
                    ladder is not None and ladder.dense_step_forced):
                return self._step_packed(slots, ready, deferred)
            return self._step_dense(slots, ready, deferred)

    def _step_dense(self, slots: list, ready: list, deferred: list) -> int:
        """Dense decode step: the forward runs over all ``max_batch`` rows,
        with non-resident rows as zero padding (their write lands in a free
        slot, which the next prefill overwrites whole) and deferred rows as
        idempotent rewrites."""
        b = self.max_batch
        tokens = np.zeros((b, 1), np.int32)
        index = np.zeros((b,), np.int32)
        for s in slots:
            req = self.active[s]
            tokens[s, 0] = req.output_tokens[-1]
            index[s] = req.index

        small_inputs = [tokens, index] + [
            np.zeros((len(ready),), np.int32) for _ in range(4)]
        with span("engine/prep"):
            tokens_dev, index_dev = self._emit_prep(small_inputs)[:2]
        self._whole_batch_barrier(slots)

        with span("engine/decode"):
            logits, self.caches = self.model.decode_step(
                self.caches, tokens_dev, index_dev, self._all_slots,
                max_len=self.max_len)
        if self.compute is not None:
            if deferred:
                charge = self.compute.decode_charge_masked(
                    [float(index[s]) for s in ready])
                self.gateway.charge_compute(
                    charge.seconds, op_class=oc.DECODE_MASKED,
                    tags=(oc.MASKED,) + (oc.DEFERRED,) * len(deferred)
                    + self._degraded_tags(),
                    bound=charge.bound)
            else:
                kv_len = float(np.mean([index[s] for s in ready]))
                charge = self.compute.decode_charge(len(ready), kv_len=kv_len)
                self.gateway.charge_compute(
                    charge.seconds, op_class=oc.DECODE_COMPUTE,
                    tags=self._degraded_tags(),
                    bound=charge.bound)
            self._charge_allreduce(len(ready))
        # batch sampling params come from the lowest resident slot
        with span("engine/sample"):
            next_tokens = sample(logits, self.generator,
                                 self.active[slots[0]].sampling)
            drain_tokens = next_tokens[ready] if deferred else next_tokens
        with span("engine/drain"):
            host_tokens = self._drain(drain_tokens)

        self.trace.append(StepTrace(
            step=self.step_count, active=len(ready),
            prep_crossings=len(small_inputs),
            prep_bytes=sum(a.nbytes for a in small_inputs),
            drain_bytes=int(host_tokens.nbytes),
            policy=self.policy.value, virtual_t=self.clock.now,
            deferred=len(deferred)))

        with span("engine/consume"):
            self._consume(ready, host_tokens, by_position=bool(deferred))
        self._poll()        # compute moved the clock this step
        return len(ready)

    def _step_packed(self, slots: list, ready: list, deferred: list) -> int:
        """Packed ragged decode step (the default path).

        The ready slots step, each writing its K/V in place at its own
        position, through ``_decode_packed`` at the executed width
        ``_bucket(n)``.  Prep crossings, the compute charge, sampling and
        the drain all cover the packed set and nothing else.  The slot ids
        ride the first of the step's four per-step index uploads (same
        shape, dtype and bytes as the reference's placeholder), so the rows
        the kernel reads are named by what crossed the bridge.
        """
        batch = RaggedBatch.from_slots(
            [(s, self.active[s].index) for s in ready])
        n = batch.size
        tokens = np.asarray(
            [[self.active[s].output_tokens[-1]] for s in ready], np.int32)
        index = np.asarray(batch.kv_lens, np.int32)

        small_inputs = [tokens, index, batch.slot_array()] + [
            np.zeros((n,), np.int32) for _ in range(3)]
        with span("engine/prep"):
            tokens_dev, index_dev, slots_dev = self._emit_prep(
                small_inputs)[:3]
        self._whole_batch_barrier(slots)

        with span("engine/decode"):
            rows = slots_dev.to(torch.int64)
            logits = self._decode_packed(tokens_dev, index_dev,
                                         slots_dev)[rows]

        if self.compute is not None:
            charge = self.compute.decode_charge_packed(
                [float(k) for k in batch.kv_lens])
            self.gateway.charge_compute(
                charge.seconds, op_class=oc.DECODE_PACKED,
                tags=(oc.PACKED,) + (oc.DEFERRED,) * len(deferred)
                + self._degraded_tags(),
                bound=charge.bound)
            # on the packed rows, the reference's unpadded count
            self._charge_allreduce(n)
        with span("engine/sample"):
            next_tokens = sample(logits, self.generator,
                                 self.active[slots[0]].sampling)
        with span("engine/drain"):
            host_tokens = self._drain(next_tokens)

        self.trace.append(StepTrace(
            step=self.step_count, active=n,
            prep_crossings=len(small_inputs),
            prep_bytes=sum(a.nbytes for a in small_inputs),
            drain_bytes=int(host_tokens.nbytes),
            policy=self.policy.value, virtual_t=self.clock.now,
            deferred=len(deferred), packed=n))

        with span("engine/consume"):
            self._consume(ready, host_tokens, by_position=True)
        self._poll()        # compute moved the clock this step
        return n

    def _bucket(self, n: int) -> int:
        """The executed width of a packed step of ``n`` rows: always
        ``max_batch`` (the reference's rule pads to a power of two), so
        every decode call of this engine has one row count and a row's
        bits never depend on how many rows step beside it."""
        return self.max_batch

    def _decode_packed(self, tokens: torch.Tensor, index: torch.Tensor,
                       slots: torch.Tensor) -> torch.Tensor:
        """One decode call for the rows at ``slots`` (n distinct resident
        slots, ascending; ``tokens`` (n, 1) and ``index`` (n,) in the same
        order, all on the card) at the executed width ``_bucket(n)``, in
        the dense step's layout: row i of the call is slot i.  A slot that
        does not step gets a copy of the first stepping row (its token,
        index and slot), as the reference pads, so a pad row writes only
        where that row writes, identical values, and never into another
        slot's K/V or state.  The executed tensors are built on the card
        from the uploaded ones (no crossing).  Returns the call's logits,
        row i for slot i."""
        width = self._bucket(slots.numel())
        rows = slots.to(torch.int64)
        logits, self.caches = self.model.decode_step(
            self.caches,
            tokens[:1].repeat(width, 1).index_copy_(0, rows, tokens),
            index[:1].repeat(width).index_copy_(0, rows, index),
            slots[:1].repeat(width).index_copy_(0, rows, slots),
            max_len=self.max_len)
        return logits

    # -- shared step plumbing (dense + packed) -----------------------------------------

    def _poll(self, *, source: str = "clock") -> None:
        """Let the coalescer's aged queues meet their deadline after a
        charge that moved the clock (no-op without bridge_opt)."""
        if self.coalescer is not None:
            self.coalescer.poll(source=source)

    def _emit_prep(self, small_inputs: list) -> list:
        """Upload one step's small input arrays under the active policy —
        coalesced (bridge_opt), fresh staging per array (async, the 44x
        class) or one batched registered crossing (sync/worker) — and
        return them on the card."""
        if self.coalescer is not None:
            prep_class = (oc.ALLOC_H2D
                          if self.policy is SchedulingPolicy.ASYNC_OVERLAP
                          else oc.PREP_BATCHED_H2D)
            return [self.coalescer.h2d(arr, op_class=prep_class)
                    for arr in small_inputs]
        if self.policy is SchedulingPolicy.ASYNC_OVERLAP:
            return [self.gateway.h2d(arr, op_class=oc.ALLOC_H2D,
                                     reuse_staging=False)
                    for arr in small_inputs]
        return self.gateway.batch_h2d(small_inputs,
                                      op_class=oc.PREP_BATCHED_H2D)

    def _whole_batch_barrier(self, slots: list) -> None:
        """Flag-off restore barrier: a decode step reads every stepping
        slot's KV, so any restore still in flight must land first."""
        if self.defaults.slot_masked_decode or not self.overlap.pending:
            return
        waited = 0.0
        for s in slots:
            w = self.overlap.restore_barrier(self.active[s].request_id)
            if w and self.obs is not None:
                self.obs.spans.on_restore_wait(self.active[s].request_id, w)
            waited += w
        if waited:
            self._poll()        # the barrier wait moved the clock

    def _drain(self, drain_tokens: torch.Tensor) -> np.ndarray:
        """Drain one step's sampled tokens to the host under the active
        policy (the policy-defining crossing)."""
        if self.coalescer is not None:
            # bridge_opt: token values land now; the drain's toll joins the
            # fused flush
            return self.coalescer.d2h(drain_tokens, op_class=oc.DRAIN_D2H)
        if self.policy is SchedulingPolicy.WORKER_DRAIN:
            done = threading.Event()
            result = {}
            self._drain_q.put((drain_tokens, lambda h: (result.update(h=h),
                                                        done.set())))
            done.wait()
            return result["h"]
        op = (oc.DRAIN_D2H_NONBLOCKING
              if self.policy is SchedulingPolicy.ASYNC_OVERLAP
              else oc.DRAIN_D2H)
        return self.gateway.d2h(drain_tokens, op_class=op)

    def _consume(self, ready: list, host: np.ndarray, *,
                 by_position: bool) -> None:
        """Append each ready slot's drained token and retire finished
        requests.  ``by_position`` indexes ``host`` by packed row position;
        otherwise by slot id (full dense steps)."""
        for pos, s in enumerate(ready):
            req = self.active[s]
            tok = int(host[pos] if by_position else host[s])
            req.output_tokens.append(tok)
            if self.obs is not None:
                self.obs.spans.on_token(req.request_id, self.clock.now)
            req.index += 1
            req.decode_steps += 1
            sp = req.sampling
            if (len(req.output_tokens) >= sp.max_new_tokens
                    or tok == sp.stop_token or req.index >= self.max_len - 1):
                self._release(req)

    def run(self, max_steps: int = 10_000) -> dict:
        steps = 0
        while (self.queue or self.active) and steps < max_steps:
            if self.step() == 0 and not self.queue:
                break
            steps += 1
        if self.coalescer is not None:
            self.coalescer.barrier()    # nothing queued survives a run
        return self.stats()

    def stats(self) -> dict:
        total_tokens = sum(len(r.output_tokens) for r in self.finished)
        ttfts = [r.first_token_t - r.enqueue_t for r in self.finished
                 if r.first_token_t is not None]
        return {
            "finished": len(self.finished),
            "total_tokens": total_tokens,
            "virtual_time_s": self.clock.now,
            "bridge_time_s": self.gateway.stats.bridge_time_s,
            "compute_time_s": self.gateway.stats.compute_time_s,
            "crossings": (self.gateway.stats.h2d_crossings
                          + self.gateway.stats.d2h_crossings),
            "mean_ttft_s": float(np.mean(ttfts)) if ttfts else 0.0,
            "steps": self.step_count,
            "overlap": self.overlap.stats_dict(),
            "closed_dirty": self.closed_dirty,
        }
