"""Canonical op-class vocabulary for bridge crossings (paper §5.2).

Every call site that moves bytes through the TransferGateway tags the
crossing with one of these classes; the tape replayer and the conformance
checker key their per-class attribution and policy rewrites on them.  Keep
the strings stable — they are part of the bridge-tape/v1 format and appear
in checked-in golden tapes (tests/golden/).
"""

from __future__ import annotations

# -- serving engine (per decode step) ------------------------------------------------
#: fresh-staging per-step input upload — the paper's 44x `aten::_to_copy` class
ALLOC_H2D = "alloc_h2d"
#: batched per-step input upload (one registered crossing for all small inputs)
PREP_BATCHED_H2D = "prep_batched_h2d"
#: prompt upload at prefill admission
PROMPT_H2D = "prompt_h2d"
#: first-token drain at prefill
SAMPLE_D2H = "sample_d2h"
#: per-step output drain, sync (blocking by design)
DRAIN_D2H = "drain_d2h"
#: per-step output drain issued "non-blocking" (blocks anyway under CC — L2)
DRAIN_D2H_NONBLOCKING = "drain_d2h_nonblocking"
#: per-step output drain executed on a worker thread (v10c)
WORKER_DRAIN = "worker_drain"

# -- KV offload (§6.2) ----------------------------------------------------------------
KV_SPILL_D2H = "kv_spill_d2h"
KV_RESTORE_H2D = "kv_restore_h2d"
#: quantized KV restore (DESIGN.md §13): wire bytes crossed, raw bytes
#: widened back by the dequant kernel on device.  A separate class from
#: KV_RESTORE_H2D so attribution and replay never average wire-priced and
#: full-width restores together.
KV_RESTORE_Q = "kv_restore_q"

# -- loader (§6.1) --------------------------------------------------------------------
LOADER_SHARD_H2D = "loader_shard_h2d"
#: weight-only-quant shard upload (DESIGN.md §13): the 34x load path at
#: 1/2–1/4 the bytes; wire bytes cross, raw bytes carried for un-quantize
#: replay
WEIGHT_SHARD_Q = "weight_shard_q"

# -- resilience (fault injection + recovery; DESIGN.md §11) ---------------------------
#: secure-session teardown recovery: one context re-established, charged the
#: fixed setup toll (context create + pinned slot registration)
CHAN_REESTABLISH = "chan_reestablish"
#: attestation-expiry recovery: re-attestation round trip for a quarantined
#: tenant/replica (SPDM GET_MEASUREMENTS + verifier)
REATTEST = "reattest"

# -- fabric P2P (in-tenant device-to-device; DESIGN.md §12) ---------------------------
# P2P semantics hang off the record's `kind` field (kind == "p2p"), like
# compute: the bridge law L1-L4 does not apply — these crossings never
# transit host memory, carry no staging discipline, and are priced at
# `fabric.p2p_bandwidth` (or the TCP fallback when the tenant's fabric is
# down / attestation lapsed — see the FABRIC_FALLBACK tag).
#: intra-CVM KV migration between a tenant's devices (never the bridge)
P2P_KV_MIGRATE = "p2p_kv_migrate"
#: per-step TP ring allreduce over the tenant fabric (2(tp-1)/tp x activations)
P2P_ALLREDUCE = "p2p_allreduce"
#: intra-tenant weight-shard exchange at load (only CVM ingress pays the toll)
P2P_SHARD_EXCHANGE = "p2p_shard_exchange"

# -- bridge_opt (arena + coalescer + pipelined restore; DESIGN.md §6) -----------------
#: fused flush of queued sub-threshold H2D crossings (one toll for many)
COALESCED_H2D = "coalesced_h2d"
#: fused flush of queued sub-threshold D2H crossings (amortized drain buffer)
COALESCED_D2H = "coalesced_d2h"
#: chunked, double-buffered KV restore over the channel pool (§6.2 recovery)
KV_RESTORE_PIPELINED = "kv_restore_pipelined"

# -- device-local compute (kind="compute" records; DESIGN.md §7) ----------------------
# Compute semantics hang off the record's `kind` field, not these strings:
# replay pass-through, the L3 exemption and the L1 compute/crossing edge all
# key on kind == "compute", so a new compute op class needs only to be
# emitted via `TransferGateway.charge_compute` (which stamps the kind).
#: one batched decode step's forward+sample compute (ComputeModel roofline)
DECODE_COMPUTE = "decode_compute"
#: a slot-masked decode step's compute (DESIGN.md §8): only the ready slots
#: (restores landed) stepped; priced for the masked batch, never the full
#: one.  A separate class from DECODE_COMPUTE so tapes distinguish masked
#: steps — replay and attribution must not average the two shapes together.
DECODE_MASKED = "decode_masked"
#: a packed ragged decode step's compute (DESIGN.md §10): the forward ran
#: over exactly the packed ready rows — no dense padding to the widest slot
#: set — priced per slot-KV-length like DECODE_MASKED (the two charge
#: identically for equal lengths; the parity property pins it).  A separate
#: class so tapes distinguish packed execution from the dense/masked legacy
#: shapes in attribution and replay.
DECODE_PACKED = "decode_packed"
#: prompt-processing compute at admission (cold tokens only — restored/warm
#: prefix tokens skip the forward and therefore the charge)
PREFILL_COMPUTE = "prefill_compute"
#: on-device widening of a quantized payload after a wire-priced restore
#: (kernels/dequant; priced by ComputeModel.dequant_charge).  The bytes the
#: bridge *didn't* move are paid for here, as HBM-bound compute — never
#: folded into the crossing's duration.
DEQUANT_COMPUTE = "dequant_compute"

#: record *tags* (additive tape metadata, not op classes): how the staging
#: arena resolved a crossing's staging buffer
ARENA_HIT = "arena_hit"
ARENA_MISS = "arena_miss"
#: slot-masked decode tags on DECODE_MASKED compute records: MASKED appears
#: once per masked step, DEFERRED once per slot that step deferred — so a
#: tape's tag counts read directly as (masked steps, deferred slot-steps).
#: A step with an all-ready mask takes the plain DECODE_COMPUTE path and
#: carries neither.
MASKED = "masked"
DEFERRED = "deferred"
#: packed ragged decode tags on DECODE_PACKED compute records: PACKED once
#: per packed step; DEFERRED (above) once per slot that step deferred — so
#: tag counts read as (packed steps, deferred slot-steps), mirroring the
#: MASKED/DEFERRED convention.
PACKED = "packed"
#: resilience tags (DESIGN.md §11): RETRY marks a fault-recovery re-charge —
#: a failed crossing attempt re-recorded with backoff, or a restore-redo
#: transfer after an integrity reject.  DEGRADED marks compute records
#: emitted while the degradation ladder sits above level 0, so a tape shows
#: exactly which step intervals ran in a degraded mode.
RETRY = "retry"
DEGRADED = "degraded"
#: fabric-P2P tag (DESIGN.md §12): the tenant's fabric was down (STALE /
#: DEGRADED partition state, lapsed attestation evidence, or a fabric-less
#: profile) when this kind="p2p" record was charged, so it was priced at the
#: CC-compatible TCP fallback rate instead of `fabric_p2p_bw`.
FABRIC_FALLBACK = "fabric_fallback"
#: quantized-crossing tag (DESIGN.md §13): stamped on every record whose
#: payload crossed in codec form (wire bytes < raw bytes) and on the
#: DEQUANT_COMPUTE records that widen it back.  The conformance Q-law keys
#: on it: a quantized *crossing* must carry raw_bytes > 0, a codec id, and
#: wire <= raw.
QUANTIZED = "quantized"
#: recovery op classes (charged on the engine-serial path with zero-byte
#: registered-h2d crossings so replay repricing stays total)
RECOVERY_CLASSES = frozenset({CHAN_REESTABLISH, REATTEST})
#: compute op classes (kind == "compute" records) — the canonical set for
#: attribution and replay summaries that enumerate compute classes
COMPUTE_CLASSES = frozenset({DECODE_COMPUTE, DECODE_MASKED, DECODE_PACKED,
                             PREFILL_COMPUTE, DEQUANT_COMPUTE})
#: quantized crossing classes (kind == "crossing" records that moved wire
#: bytes) — the conformance Q-law requires each to carry the QUANTIZED tag,
#: raw_bytes > 0 and nbytes <= raw_bytes.
QUANT_CLASSES = frozenset({KV_RESTORE_Q, WEIGHT_SHARD_Q})
#: fabric-P2P op classes (kind == "p2p" records) — conformance enforces the
#: bijection: every record with one of these classes has kind "p2p", and
#: every kind-"p2p" record carries one of these classes on channel -1.
P2P_CLASSES = frozenset({P2P_KV_MIGRATE, P2P_ALLREDUCE, P2P_SHARD_EXCHANGE})

#: classes whose crossings are per-step input preparation (candidates for
#: batching into one registered crossing in a counterfactual replay).  The
#: worker-offloadable drain set lives in replay.WORKER_OFFLOADABLE — it is a
#: replay-policy decision (sample_d2h stays synchronous under every policy).
PREP_CLASSES = frozenset({ALLOC_H2D, PREP_BATCHED_H2D, COALESCED_H2D})
