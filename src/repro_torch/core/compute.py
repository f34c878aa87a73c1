"""ComputeModel — per-step prefill/decode compute as a virtual-clock charge.

The paper's recovery story (§5.4–§5.5) only exists because decode compute
gives the bridge a window to hide crossings in: the scheduling flag recovers
57% and the worker-thread drain up to 92% *of a gap measured against steps
that spend most of their time in the forward pass*.  The Hopper CC benchmark
study (arXiv 2409.03992) makes the same point from the other side — whether
CC overhead is hideable is exactly the compute/crossing ratio.  A simulator
that charges crossings but not compute therefore cannot say anything about
recovery: its coalescing deadlines never come due and its restore-overlap
windows are fictional.

This module prices one engine step's compute the same way the repo prices
one crossing: a small analytic model over quantities the engine already has
(the ``ModelConfig`` shapes), evaluated against a per-platform roofline
(peak FLOPs + HBM bandwidth) with the CC parity factors the bridge law
already encodes (``BridgeModel.compute_time`` / ``hbm_time`` — device-local
work is at parity, L5).  Decode is weight-read memory-bound for every
serving-scale config; prefill is FLOPs-bound for long prompts.  The charges
land on the tape as ``kind="compute"`` records (see trace/tape.py), so
replay attribution and the conformance checker see the full step anatomy,
not just its crossings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

from .bridge import BridgeModel


@dataclass(frozen=True)
class ComputeSpec:
    """Device roofline constants (FLOPs/s dense, bytes/s HBM)."""

    peak_flops: float
    hbm_bw: float


#: per-bridge-profile rooflines.  TPU v5e matches launch/dryrun.PEAK_FLOPS;
#: the GPU entries are the platforms' public dense-BF16 / HBM figures — the
#: law-level claims (parity, hideability ordering) do not depend on their
#: exact values, only on compute being charged at all.
COMPUTE_SPECS = {
    "b300-hgx": ComputeSpec(peak_flops=2.25e15, hbm_bw=8.0e12),
    "rtx-pro-6000": ComputeSpec(peak_flops=2.5e14, hbm_bw=1.8e12),
    "h200": ComputeSpec(peak_flops=9.9e14, hbm_bw=4.8e12),
    "tpu-v5e": ComputeSpec(peak_flops=197e12, hbm_bw=819e9),
}

DEFAULT_SPEC = COMPUTE_SPECS["tpu-v5e"]


def spec_for_profile(profile_name: str) -> ComputeSpec:
    """Roofline for a bridge profile — unknown names are an error.

    The silent historical fallback (unknown -> TPU v5e) mispriced every
    charge on an unrecognized platform by ~10x without a word, which
    corrupts exactly the compute/crossing ratio the recovery numbers are
    measured against.  A caller with a platform we have no roofline for
    must say what it costs (``ComputeModel(..., spec=...)``).
    """
    try:
        return COMPUTE_SPECS[profile_name]
    except KeyError:
        known = ", ".join(sorted(COMPUTE_SPECS))
        raise ValueError(
            f"no ComputeSpec for bridge profile {profile_name!r} "
            f"(known: {known}); pass spec= explicitly") from None


def _dtype_bytes(dtype) -> int:
    """Element width of a torch dtype (a numpy dtype is accepted too)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return int(np.dtype(dtype).itemsize)


@dataclass(frozen=True)
class ComputeCharge:
    """One priced unit of device compute (what the gateway charges)."""

    kind: str             # "prefill" | "decode"
    flops: float
    hbm_bytes: float
    seconds: float
    bound: str            # "compute" | "memory" — which roofline term won

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)


class ComputeModel:
    """Roofline pricing of engine steps against the active bridge profile.

    Pure and deterministic, like ``BridgeModel``: the engine (or a
    benchmark) asks for a step's seconds and charges them through
    ``TransferGateway.charge_compute``.  The model and the executed network
    are deliberately decoupled — benchmarks run the tiny smoke model for
    token correctness while pricing compute against the paper's 27B serving
    config, exactly as the crossing side prices B300 tolls on CPU.
    """

    def __init__(self, cfg: ModelConfig, bridge: BridgeModel, *,
                 spec: Optional[ComputeSpec] = None, tp_degree: int = 1,
                 skew: Optional[Sequence[float]] = None):
        if tp_degree < 1:
            raise ValueError(f"tp_degree must be >= 1, got {tp_degree}")
        self.cfg = cfg
        self.bridge = bridge
        self.spec = spec if spec is not None else spec_for_profile(
            bridge.profile.name)
        self.active_params = float(cfg.active_param_count())
        self.bytes_per_param = _dtype_bytes(cfg.dtype)
        #: tensor-parallel degree (DESIGN.md §12): per-device FLOPs and HBM
        #: traffic divide by it (weights, KV and activations are sharded
        #: across the tenant's partition), and each decode/prefill step owes
        #: a ring allreduce over the tenant fabric — priced separately by
        #: ``allreduce_seconds`` and charged by the engine as a
        #: ``p2p_allreduce`` record, never folded into the compute interval.
        self.tp_degree = int(tp_degree)
        #: per-device clock skew within the TP group, seconds (one entry per
        #: device).  A ring collective completes when its slowest member
        #: arrives, so each step's allreduce waits out the skew *spread*
        #: (max - min) on top of the bandwidth term — stragglers become
        #: priceable instead of invisible.  None/zero vector = no skew, and
        #: the surcharge is exactly 0.0, so skew-free tapes (all goldens)
        #: are unchanged.
        if skew is not None:
            skew = tuple(float(s) for s in skew)
            if len(skew) != self.tp_degree:
                raise ValueError(
                    f"skew vector has {len(skew)} entries for "
                    f"tp_degree={self.tp_degree}")
            if any(s < 0 for s in skew):
                raise ValueError(f"skew entries must be >= 0, got {skew}")
        self.skew = skew

    # -- per-token byte/flop terms ------------------------------------------------------

    def kv_bytes_per_token(self) -> float:
        """KV-cache bytes one cached token contributes per decode step."""
        if self.cfg.is_attention_free:
            # SSM state is O(1) in sequence length; fold it into weights
            return 0.0
        per_layer = 2 * self.cfg.n_kv_heads * self.cfg.head_dim * self.bytes_per_param
        return float(per_layer * self.cfg.n_layers)

    # -- decode -------------------------------------------------------------------------

    def decode_charge(self, batch: int, *, kv_len: float = 0.0) -> ComputeCharge:
        """One batched decode step: every active param touched once (weight
        reads dominate), plus the KV read for each sequence's cached prefix.

        An empty batch charges zero seconds: the engine's nothing-ready path
        takes the pipeline barrier, never a forward — the old
        ``max(1, batch)`` clamp billed one slot's FLOPs *and* the full
        weight stream for a step that never ran.
        """
        batch = max(0, int(batch))
        if batch == 0:
            return ComputeCharge("decode", 0.0, 0.0, 0.0, "compute")
        flops = 2.0 * self.active_params * batch
        hbm = (self.active_params * self.bytes_per_param
               + batch * max(0.0, kv_len) * self.kv_bytes_per_token())
        return self._charge("decode", flops, hbm)

    def decode_step_s(self, batch: int, *, kv_len: float = 0.0) -> float:
        return self.decode_charge(batch, kv_len=kv_len).seconds

    # -- masked decode (slot-masked execution; DESIGN.md §8) ----------------------------

    def decode_charge_masked(self, kv_lens: "Sequence[float]") -> ComputeCharge:
        """One slot-masked decode step priced for exactly the ready slots.

        The engine steps only slots whose KV restores have landed; deferred
        slots stay resident but contribute neither FLOPs nor KV reads this
        step.  The weight-read term is batch-independent (every active param
        streams once per step regardless of how many slots consume it), so a
        masked step is cheaper than the full batch only by the deferred
        slots' FLOPs and KV traffic — which is exactly the charge the
        coalescer deadlines and restore-overlap windows must see, or the
        clock would bill deferred work that never ran.  Per-slot ``kv_lens``
        (not a batch mean) because the ready set's prefix lengths are known.

        An empty ready set charges zero (see ``decode_charge``): zero ready
        slots means no forward ran, so billing one phantom slot — as the
        old ``max(1, len(kv_lens))`` did — charged a full weight stream for
        nothing.
        """
        ready = len(kv_lens)
        if ready == 0:
            return ComputeCharge("decode", 0.0, 0.0, 0.0, "compute")
        flops = 2.0 * self.active_params * ready
        hbm = (self.active_params * self.bytes_per_param
               + sum(max(0.0, k) for k in kv_lens) * self.kv_bytes_per_token())
        return self._charge("decode", flops, hbm)

    def decode_step_masked_s(self, kv_lens: "Sequence[float]") -> float:
        return self.decode_charge_masked(kv_lens).seconds

    # -- packed ragged decode (DESIGN.md §10) -------------------------------------------

    def decode_charge_packed(self, kv_lens: "Sequence[float]") -> ComputeCharge:
        """One packed ragged decode step priced for the packed set.

        Packing is an *execution* change — the forward runs over exactly the
        packed rows instead of a dense batch padded to the widest slot set —
        not a pricing change: the packed set's charge is identical to a
        slot-masked step over the same per-slot KV lengths (weights stream
        once regardless of how the rows are laid out; KV traffic sums the
        packed prefixes).  Kept as its own entry point so the engine's
        DECODE_PACKED records and the parity property
        (``packed == masked == dense`` for equal lengths) both have a named
        subject, and so a future paged-attention packed kernel can diverge
        here without touching the masked path.
        """
        return self.decode_charge_masked(kv_lens)

    def decode_step_packed_s(self, kv_lens: "Sequence[float]") -> float:
        return self.decode_charge_packed(kv_lens).seconds

    # -- prefill ------------------------------------------------------------------------

    def prefill_charge(self, tokens: int) -> ComputeCharge:
        """Prompt processing for ``tokens`` new tokens (restored/warm tokens
        are the caller's to exclude — they skip the forward entirely)."""
        tokens = max(0, int(tokens))
        if tokens == 0:
            return ComputeCharge("prefill", 0.0, 0.0, 0.0, "compute")
        flops = 2.0 * self.active_params * tokens
        hbm = (self.active_params * self.bytes_per_param
               + tokens * self.kv_bytes_per_token())
        return self._charge("prefill", flops, hbm)

    def prefill_s(self, tokens: int) -> float:
        return self.prefill_charge(tokens).seconds

    # -- tensor-parallel allreduce (DESIGN.md §12) --------------------------------------

    def allreduce_bytes(self, batch: int) -> int:
        """Per-device wire bytes of one step's TP ring allreduces.

        A TP transformer layer allreduces twice (attention output + MLP
        output), each over the step's activations (batch x d_model).  A ring
        over ``tp_degree`` devices moves ``2 (tp-1)/tp`` x payload per
        device (reduce-scatter + all-gather).  Zero when tp == 1 (nothing to
        reduce) or the batch is empty (no forward ran — the phantom-charge
        rule applies to collectives too).
        """
        batch = max(0, int(batch))
        if self.tp_degree == 1 or batch == 0:
            return 0
        payload = 2 * self.cfg.n_layers * batch * self.cfg.d_model * self.bytes_per_param
        return int(2 * (self.tp_degree - 1) / self.tp_degree * payload)

    def allreduce_skew_s(self) -> float:
        """Straggler wait of one ring collective: the skew *spread* (max -
        min) across the TP group — the fastest device idles until the
        slowest arrives.  0.0 without a skew vector or below tp=2."""
        if not self.skew or self.tp_degree == 1:
            return 0.0
        return max(self.skew) - min(self.skew)

    def allreduce_seconds(self, batch: int, p2p_bw: float) -> float:
        """One step's allreduce time over the tenant fabric at ``p2p_bw``,
        plus the straggler wait when a skew vector is set."""
        nbytes = self.allreduce_bytes(batch)
        if nbytes == 0:
            return 0.0
        return nbytes / p2p_bw + self.allreduce_skew_s()

    # -- dequantization (quantized crossings; DESIGN.md §13) ----------------------------

    def dequant_charge(self, raw_bytes: int, wire_bytes: int) -> ComputeCharge:
        """On-device widening of a quantized payload after a wire-priced
        restore (the ``kernels/dequant`` pass): read the codes + scales
        (``wire_bytes``), write full width (``raw_bytes``), ~2 flops per
        emitted value (decode + scale multiply).  Memory-bound by
        construction — its arithmetic intensity is ~2 flops per 3 bytes —
        which is the point: the bytes the bridge didn't move are paid for
        in HBM stream time, never hidden.  Zero raw bytes charge nothing
        (the phantom-charge rule)."""
        raw = max(0, int(raw_bytes))
        wire = max(0, int(wire_bytes))
        if raw == 0:
            return ComputeCharge("dequant", 0.0, 0.0, 0.0, "compute")
        flops = 2.0 * wire  # one code byte per value
        hbm = float(wire + raw)
        return self._charge("dequant", flops, hbm)

    def dequant_s(self, raw_bytes: int, wire_bytes: int) -> float:
        return self.dequant_charge(raw_bytes, wire_bytes).seconds

    # -- the roofline -------------------------------------------------------------------

    def _charge(self, kind: str, flops: float, hbm_bytes: float) -> ComputeCharge:
        """Per-device roofline: under TP the weights, KV and activations are
        sharded, so one device sees 1/tp of the step's FLOPs and HBM bytes
        (the allreduce that glues the shards back together is priced
        separately — it is fabric traffic, not device compute)."""
        flops /= self.tp_degree
        hbm_bytes /= self.tp_degree
        ct = self.bridge.compute_time(flops, self.spec.peak_flops)
        mt = self.bridge.hbm_time(hbm_bytes, self.spec.hbm_bw)
        if ct >= mt:
            return ComputeCharge(kind, flops, hbm_bytes, ct, "compute")
        return ComputeCharge(kind, flops, hbm_bytes, mt, "memory")
