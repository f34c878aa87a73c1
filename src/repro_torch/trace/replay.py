"""TraceReplayer — counterfactual repricing of a recorded crossing stream.

The paper's method (§5) is to explain and recover the CC serving gap by
re-pricing the *same* op stream under patched disciplines, not by comparing
noisy end-to-end runs.  The replayer is that method over a BridgeTape: take
the exact crossing stream one engine run produced and answer "what would
this run have cost on H200 / with CC off / under sync-drain / with an
8-wide channel pool" — orders of magnitude faster than re-running engines,
and deterministic.

Repricing never invents crossings: byte counts and stream order come from
the tape.  A policy rewrite transforms the stream the way the engine's
discipline would have (batching per-step fresh uploads into one registered
crossing; moving blocking drains onto a worker thread), then every crossing
is re-priced under the counterfactual BridgeModel.  The result carries a
§5.2-style per-op-class attribution table built on core.accounting.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Sequence, Union

from repro_torch.core.accounting import Attribution, OpClassRow
from repro_torch.core.bridge import (PROFILES, BridgeModel, Crossing, Direction,
                               StagingKind)
from repro_torch.core.fabric import p2p_bandwidth
from repro_torch.core.policy import SchedulingPolicy

from . import opclasses as oc
from .tape import BridgeTape, TapeRecord

US = 1e-6

#: drain classes a worker thread can take off the engine's critical path
#: (a fused coalesced drain is still a drain — it offloads the same way)
WORKER_OFFLOADABLE = frozenset({oc.DRAIN_D2H, oc.DRAIN_D2H_NONBLOCKING,
                                oc.WORKER_DRAIN, oc.COALESCED_D2H})


@dataclass(frozen=True)
class ReplaySpec:
    """The counterfactual: any field left None inherits from the tape."""

    profile: Optional[str] = None          # BridgeProfile name
    cc_on: Optional[bool] = None
    pool_workers: Optional[int] = None     # channel-pool width (L4 lever)
    #: rewrite the stream to another scheduling discipline before pricing
    policy: Optional[Union[str, SchedulingPolicy]] = None
    aesni: bool = True                     # §4.3 cipher ablation lever
    #: fabric-P2P lever (DESIGN.md §12): None re-prices each kind="p2p"
    #: record as recorded (FABRIC_FALLBACK-tagged ones at the TCP fallback
    #: rate, the rest at full fabric rate); True/False forces every P2P
    #: record up or down — "what would this TP run cost if the tenant's
    #: fabric had been healthy / had lapsed the whole time"
    fabric_up: Optional[bool] = None
    #: quantization lever (DESIGN.md §13): None replays as recorded; "" is
    #: the *un-quantize* counterfactual — every quantized crossing
    #: (raw_bytes > 0) re-prices at its full raw width and the modeled
    #: dequant compute is dropped ("what would this run have cost without
    #: the codec"); a codec name ("fp8"/"int8") force-quantizes the
    #: quantizable full-width classes at that codec's wire ratio ("what
    #: would the codec have saved") — optimistically, without adding the
    #: dequant compute the engine would actually charge
    quantize: Optional[str] = None
    label: str = ""

    def policy_value(self) -> str:
        if self.policy is None:
            return ""
        if isinstance(self.policy, SchedulingPolicy):
            return self.policy.value
        return str(self.policy)


@dataclass(frozen=True)
class RewrittenCrossing:
    """One crossing after policy rewrite: what to price + what it cost as
    recorded (coalesced crossings carry the sum of their sources)."""

    op_class: str
    direction: str
    nbytes: int
    staging: str
    recorded_s: float
    source_calls: int = 1
    #: "crossing" or "compute" — compute intervals pass through every policy
    #: rewrite untouched and re-price at parity, never as bridge traffic
    kind: str = "crossing"
    #: roofline boundness of a compute record ("compute"/"memory"/"" for
    #: pre-boundness tapes) — selects which parity factor reprices it
    bound: str = ""
    #: kind="p2p" only: the record was charged at the TCP fallback rate
    #: (FABRIC_FALLBACK tag) — RewrittenCrossing drops tags, so the pricing
    #: decision is carried explicitly for the as-recorded replay
    fallback: bool = False
    #: quantized crossings (tape v5): full-width byte count (`nbytes` is
    #: then the wire count actually moved) and the codec that produced it
    raw_bytes: int = 0
    codec: str = ""


def rewrite_for_policy(records: Sequence[TapeRecord],
                       policy: str) -> list[RewrittenCrossing]:
    """Transform the stream the way the target discipline would have.

    sync/worker: runs of consecutive per-step prep uploads coalesce into one
    registered batched crossing (§8 rule 1); drains are renamed to the
    discipline's drain class.  async: prep crossings take fresh staging (the
    44x class).  A v3 coalesced record carries its constituent crossings in
    ``sources``, so an async rewrite *un-fuses* it — each constituent is
    re-priced as its own fresh-staged upload (or non-blocking drain), with
    the recorded time prorated by bytes.  Pre-v3 coalesced records (no
    sources) re-stage without un-batching, as before — byte splits are
    unknowable from the fused record alone.
    """
    out: list[RewrittenCrossing] = []
    batch: list[TapeRecord] = []

    def flush() -> None:
        if not batch:
            return
        out.append(RewrittenCrossing(
            op_class=oc.PREP_BATCHED_H2D, direction=Direction.H2D.value,
            nbytes=sum(r.nbytes for r in batch),
            staging=StagingKind.REGISTERED.value,
            recorded_s=sum(r.duration_s for r in batch),
            source_calls=len(batch)))
        batch.clear()

    for r in records:
        if r.is_compute or r.is_p2p:
            # compute and fabric P2P are not bridge traffic: no policy moves
            # them, but they do break a run of prep uploads (the engine
            # charged the interval between one step's preps and the next's)
            flush()
            out.append(RewrittenCrossing(r.op_class, r.direction, r.nbytes,
                                         r.staging, r.duration_s,
                                         kind=r.kind, bound=r.bound,
                                         fallback=oc.FABRIC_FALLBACK in r.tags,
                                         raw_bytes=r.raw_bytes, codec=r.codec))
            continue
        if policy in (SchedulingPolicy.SYNC_DRAIN.value,
                      SchedulingPolicy.WORKER_DRAIN.value):
            if r.op_class in oc.PREP_CLASSES and r.direction == Direction.H2D.value:
                batch.append(r)
                continue
            flush()
            op = r.op_class
            if op in WORKER_OFFLOADABLE:
                op = (oc.DRAIN_D2H if policy == SchedulingPolicy.SYNC_DRAIN.value
                      else oc.WORKER_DRAIN)
            out.append(RewrittenCrossing(op, r.direction, r.nbytes, r.staging,
                                         r.duration_s,
                                         raw_bytes=r.raw_bytes, codec=r.codec))
        elif policy == SchedulingPolicy.ASYNC_OVERLAP.value:
            coalesced = r.op_class in (oc.COALESCED_H2D, oc.COALESCED_D2H)
            if coalesced and r.sources:
                # v3: un-fuse the flush into its constituents — async would
                # have issued each one eagerly.  H2D constituents become the
                # per-call fresh-staged 44x class; D2H become "non-blocking"
                # drains.  Recorded time prorates by bytes (equal split when
                # every constituent is zero-byte metadata).
                total = sum(nb for _, nb in r.sources)
                for _, nb in r.sources:
                    share = (nb / total if total > 0
                             else 1.0 / len(r.sources))
                    if r.direction == Direction.H2D.value:
                        op, staging = oc.ALLOC_H2D, StagingKind.FRESH.value
                    else:
                        op, staging = oc.DRAIN_D2H_NONBLOCKING, r.staging
                    out.append(RewrittenCrossing(
                        op, r.direction, nb, staging,
                        r.duration_s * share))
                continue
            op, staging = r.op_class, r.staging
            if r.op_class in oc.PREP_CLASSES and r.direction == Direction.H2D.value:
                op, staging = oc.ALLOC_H2D, StagingKind.FRESH.value
            elif r.op_class in (oc.DRAIN_D2H, oc.WORKER_DRAIN):
                op = oc.DRAIN_D2H_NONBLOCKING
            out.append(RewrittenCrossing(op, r.direction, r.nbytes, staging,
                                         r.duration_s,
                                         raw_bytes=r.raw_bytes, codec=r.codec))
        else:
            raise ValueError(f"unknown scheduling policy {policy!r}")
    flush()
    return out


#: full-width crossing classes a force-quantize counterfactual may shrink
#: (the classes the engine's kv_quant / weight_quant knobs actually route)
QUANTIZABLE = frozenset({oc.KV_RESTORE_H2D, oc.KV_RESTORE_PIPELINED,
                         oc.KV_SPILL_D2H, oc.LOADER_SHARD_H2D})

#: class mapping between the quantized and full-width spellings of a
#: crossing (pipelined restores and spills keep their class either way —
#: the QUANTIZED tag / raw_bytes field is what marks them on the tape)
_UNQUANT_CLASS = {oc.KV_RESTORE_Q: oc.KV_RESTORE_H2D,
                  oc.WEIGHT_SHARD_Q: oc.LOADER_SHARD_H2D}
_QUANT_CLASS = {v: k for k, v in _UNQUANT_CLASS.items()}


def rewrite_for_quant(stream: Sequence[RewrittenCrossing],
                      lever: str) -> list[RewrittenCrossing]:
    """Apply the quantization counterfactual to an already-rewritten stream.

    ``lever == ""`` *un-quantizes*: every crossing recorded at wire width
    (``raw_bytes > 0``) is re-priced at its full raw width under the
    full-width op class, and ``dequant_compute`` records are dropped — the
    counterfactual engine never decoded anything.  ``lever == "fp8"/"int8"``
    *force-quantizes*: full-width crossings in the quantizable classes
    shrink to that codec's wire width (per-block scale overhead included).
    Force-quantize is optimistic by construction: it does not synthesize the
    dequant compute the real engine would charge, so it bounds the codec's
    best-case bridge saving from above.

    Pure function of the stream: recorded_s is preserved untouched (the tape
    stays the ground truth; only the counterfactual pricing inputs change).
    """
    out: list[RewrittenCrossing] = []
    if lever == "":
        for rc in stream:
            if rc.kind == "compute" and rc.op_class == oc.DEQUANT_COMPUTE:
                continue  # no codec, no decode step
            if rc.kind == "crossing" and rc.raw_bytes > 0:
                rc = replace(rc, op_class=_UNQUANT_CLASS.get(rc.op_class,
                                                             rc.op_class),
                             nbytes=rc.raw_bytes, raw_bytes=0, codec="")
            out.append(rc)
        return out
    # force-quantize: validate the codec name and price at its wire ratio
    from repro_torch.quant import get_codec, wire_bytes as quant_wire
    codec = get_codec(lever)
    for rc in stream:
        if (rc.kind == "crossing" and rc.raw_bytes == 0
                and rc.op_class in QUANTIZABLE and rc.nbytes > 0):
            # recorded full-width bytes were bf16-ish KV/weight payloads;
            # model them at 2-byte elements (the repo's KV dtype) so the
            # wire ratio matches what the engine's knob would produce
            wire = quant_wire(rc.nbytes, itemsize=2)
            rc = replace(rc, op_class=_QUANT_CLASS.get(rc.op_class,
                                                       rc.op_class),
                         nbytes=wire, raw_bytes=rc.nbytes, codec=codec.name)
        out.append(rc)
    return out


@dataclass
class ReplayResult:
    """A tape re-priced under one counterfactual."""

    tape_label: str
    profile: str
    cc_on: bool
    pool_workers: int
    policy: str
    rows: list[OpClassRow]
    total_recorded_s: float
    total_replayed_s: float
    #: critical-path time under the counterfactual discipline (worker-drain
    #: overlaps offloadable drains with subsequent engine work)
    wall_s: float
    n_crossings: int

    @property
    def gap_s(self) -> float:
        """Recorded minus replayed: what the counterfactual would save."""
        return self.total_recorded_s - self.total_replayed_s

    def attribution(self) -> Attribution:
        """§5.2-style table per op class, sorted so the dominant class leads.

        Reuses the accounting rows with recorded in the ``cc_on`` column and
        replayed in the ``cc_off`` column; that labeling is literal only for
        a CC-off counterfactual of a CC-on tape (the paper's case) — use
        :meth:`format` for output with honest recorded/replayed headers.
        """
        rows = sorted(self.rows, key=lambda r: r.total_delta_s, reverse=True)
        return Attribution(rows=rows, total_gap_s=self.gap_s)

    def dominant(self) -> OpClassRow:
        return self.attribution().dominant()

    def format(self) -> str:
        attr = self.attribution()
        lines = [
            (f"replay[{self.tape_label or 'tape'}] -> profile={self.profile} "
             f"cc_on={self.cc_on} pool={self.pool_workers} "
             f"policy={self.policy or '(as recorded)'} "
             f"wall={self.wall_s:.4f}s"),
            (f"{'op class':<24}{'calls':>8}{'replayed avg':>14}"
             f"{'recorded avg':>14}{'rec/rep':>10}{'delta(s)':>10}"),
        ]
        for r in attr.rows:
            lines.append(
                f"{r.op_class:<24}{r.calls:>8}{r.cc_off_avg_us:>12.1f}us"
                f"{r.cc_on_avg_us:>12.1f}us{r.per_call_slowdown:>9.1f}x"
                f"{r.total_delta_s:>10.3f}")
        lines.append(
            f"replayed {self.total_replayed_s:.3f}s vs recorded "
            f"{self.total_recorded_s:.3f}s (gap {self.gap_s:+.3f}s); "
            f"dominant: {attr.dominant().op_class}")
        return "\n".join(lines)


class TraceReplayer:
    def __init__(self, tape: BridgeTape):
        self.tape = tape

    def _resolve(self, spec: ReplaySpec) -> tuple[BridgeModel, int, str]:
        meta = self.tape.meta
        profile_name = spec.profile or meta.profile
        if profile_name not in PROFILES:
            raise ValueError(f"unknown bridge profile {profile_name!r}; "
                             f"have {sorted(PROFILES)}")
        cc_on = meta.cc_on if spec.cc_on is None else spec.cc_on
        pool = spec.pool_workers or meta.pool_workers
        model = BridgeModel(PROFILES[profile_name], cc_on=cc_on,
                            aesni=spec.aesni)
        return model, pool, spec.policy_value()

    def reprice(self, spec: ReplaySpec = ReplaySpec()) -> ReplayResult:
        model, pool, policy = self._resolve(spec)
        if policy and policy != self.tape.meta.policy:
            stream = rewrite_for_policy(self.tape.records, policy)
        else:
            policy = policy or self.tape.meta.policy
            stream = [RewrittenCrossing(r.op_class, r.direction, r.nbytes,
                                        r.staging, r.duration_s, kind=r.kind,
                                        bound=r.bound,
                                        fallback=oc.FABRIC_FALLBACK in r.tags,
                                        raw_bytes=r.raw_bytes, codec=r.codec)
                      for r in self.tape.records]
        if spec.quantize is not None:
            stream = rewrite_for_quant(stream, spec.quantize)

        # compute re-prices at parity (L5: device-local work is ~unaffected
        # by CC): recorded = t_ideal / parity_rec, counterfactual =
        # t_ideal / parity_new.  Replay holds the accelerator itself fixed —
        # a cross-profile replay re-prices crossings, not the silicon.  The
        # record's `bound` picks WHICH parity factor: a memory-bound step
        # scales by hbm_parity (B300: 0.912 — a real CC tax), a
        # compute-bound one by compute_parity (0.998 — near-free);
        # pre-boundness records fall back to compute_parity (conservative).
        rec_profile = PROFILES.get(self.tape.meta.profile)

        def _parity(profile, cc_on: bool, bound: str) -> float:
            if profile is None or not cc_on:
                return 1.0
            return (profile.hbm_parity if bound == "memory"
                    else profile.compute_parity)

        def compute_scale(bound: str) -> float:
            return (_parity(rec_profile, self.tape.meta.cc_on, bound)
                    / _parity(model.profile, model.cc_on, bound))

        per_class: dict[str, list[tuple[int, float, float]]] = {}
        wall = 0.0
        worker_until = 0.0
        total_replayed = 0.0
        total_recorded = 0.0
        worker_mode = policy == SchedulingPolicy.WORKER_DRAIN.value
        for rc in stream:
            if rc.kind == "compute":
                cost = rc.recorded_s * compute_scale(rc.bound)
            elif rc.kind == "p2p":
                # fabric P2P re-prices against the counterfactual profile's
                # fabric, never the bridge; CC on/off is irrelevant (the one
                # path CC does not serialize).  A profile without a fabric
                # (fabric_p2p_bw == 0) prices at its TCP fallback.
                up = (not rc.fallback if spec.fabric_up is None
                      else spec.fabric_up)
                bw = p2p_bandwidth(model.profile, fabric_up=up)
                if bw <= 0:
                    bw = model.profile.fabric_fallback_bw
                cost = rc.nbytes / bw if rc.nbytes else 0.0
            else:
                crossing = Crossing(rc.nbytes, Direction(rc.direction),
                                    StagingKind(rc.staging))
                cost = model.crossing_time(crossing, n_contexts=pool)
            total_replayed += cost
            total_recorded += rc.recorded_s
            per_class.setdefault(rc.op_class, []).append(
                (rc.source_calls, rc.recorded_s, cost))
            if worker_mode and rc.op_class in WORKER_OFFLOADABLE:
                start = max(wall, worker_until)
                worker_until = start + cost
            else:
                wall += cost
        wall = max(wall, worker_until)

        rows = []
        for op_class, entries in sorted(per_class.items()):
            calls = len(entries)
            rec_s = sum(e[1] for e in entries)
            rep_s = sum(e[2] for e in entries)
            rows.append(OpClassRow(
                op_class=op_class, calls=calls,
                cc_off_avg_us=rep_s / calls / US,
                cc_on_avg_us=rec_s / calls / US))
        return ReplayResult(
            tape_label=self.tape.meta.label, profile=model.profile.name,
            cc_on=model.cc_on, pool_workers=pool, policy=policy,
            rows=rows, total_recorded_s=total_recorded,
            total_replayed_s=total_replayed, wall_s=wall,
            n_crossings=sum(len(e) for e in per_class.values()))

    def counterfactuals(self, specs: Sequence[ReplaySpec]) -> list[ReplayResult]:
        return [self.reprice(s) for s in specs]
