"""The serialized-bridge performance law (paper §4).

Under confidential computing the host<->accelerator bridge becomes a
serialized, high-setup-cost channel.  Four measured properties define it
(paper §4.4):

  L1  Within a context, cross-device transfers serialize on a fixed pool of
      secure copy channels; stream-level overlap is a fiction under CC.
  L2  Asynchrony is revoked: "non-blocking" copies block the calling CPU
      thread for the full transfer.
  L3  Every crossing pays a fixed setup toll (~330 us observed), so many
      small crossings are catastrophically worse than few large ones.
  L4  Additional bandwidth requires additional contexts, each with an
      expensive secure lifecycle; compute and device-local memory stay at
      parity.

``BridgeProfile`` encodes the constants of that law for a concrete platform;
``BridgeModel`` turns the law into computable transfer times.  The profiles
below are calibrated to the paper's own measurements (B300 HGX, RTX Pro 6000,
H200 boundary check), plus a TPU v5e profile expressing the analogous facts
for the host<->TPU PCIe path (the adaptation target; see DESIGN.md §2).

Everything downstream — the decode-step simulator (simulator.py), the
transfer gateway (gateway.py), the pooled loader (loader/) and the KV-offload
policy (serving/offload.py) — is this law applied at a different layer.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass
from typing import Optional

US = 1e-6
MS = 1e-3
GB = 1e9
GIB = 1 << 30


class Direction(enum.Enum):
    H2D = "h2d"
    D2H = "d2h"
    #: in-tenant fabric P2P — never transits host memory, so it carries no
    #: staging discipline and no bridge serialization (DESIGN.md §12).  Only
    #: kind="p2p" tape records use it; bridge pricing paths never see it.
    P2P = "p2p"


class StagingKind(enum.Enum):
    """How the host-side staging buffer for a crossing was obtained.

    The paper's profiler accounting (§5.2) shows the toll is a property of
    the *staging path*, not of the byte count:

      * FRESH      — freshly allocated pinned buffer: pays full bounce-buffer
                     setup (~330 us) plus allocation/registration; 44x class.
      * REGISTERED — pre-allocated, previously used staging: warm path, pays
                     only a small per-crossing delta (1.0-1.2x class).
    """

    FRESH = "fresh"
    REGISTERED = "registered"


@dataclass(frozen=True)
class BridgeProfile:
    """Constants of the serialized-bridge law for one platform.

    All times in seconds, all bandwidths in bytes/second.
    """

    name: str

    # ---- native (CC-off) bridge -------------------------------------------------
    native_h2d_bw: float
    native_d2h_bw: float
    #: per-crossing dispatch latency CC-off, registered staging (small-copy floor)
    native_toll: float
    #: fresh pinned-allocation cost CC-off (aten::_to_copy at 31.7 us, §5.2)
    native_fresh_alloc: float
    #: fractional bandwidth gain available from extra streams CC-off (paper: ~24%)
    native_stream_scaling: float

    # ---- CC-on bridge: the serialized channel ------------------------------------
    #: sustained per-context secure-channel bandwidth (one context, large copies)
    cc_channel_h2d_bw: float
    cc_channel_d2h_bw: float
    #: fixed bounce-buffer setup toll per crossing with FRESH staging (L3)
    cc_fresh_toll: float
    #: additional fresh-pinned allocation + registration cost (host side)
    cc_fresh_alloc: float
    #: per-crossing latency with REGISTERED staging (warm small-copy floor)
    cc_registered_toll: float
    #: aggregate ceiling over all contexts, as a fraction of native bw (L4)
    cc_multi_context_ceiling_h2d: float
    cc_multi_context_ceiling_d2h: float
    #: system-wide secure copy channel limit -> max useful contexts
    max_secure_contexts: int

    # ---- context lifecycle (L4) ---------------------------------------------------
    context_create: float      # per context
    context_destroy: float     # per context
    pinned_slot_alloc: float   # per context staging slot

    # ---- device-local parity (the "organizing fact") ------------------------------
    compute_parity: float      # CC-on/CC-off matmul throughput ratio
    hbm_parity: float          # CC-on/CC-off device-memory harness ratio

    # ---- CPU cipher path (§4.3 ablation) -------------------------------------------
    #: duplex plateau with full AES-NI/PCLMUL (GB/s level the channel law sets)
    cipher_duplex_bw: float
    #: collapsed bandwidth with AES-NI+PCLMUL disabled (cipher becomes the limiter)
    cipher_duplex_bw_no_aesni: float
    #: relative cost of disabling only the wide-vector VAES/VPCLMUL forms
    vaes_ablation_cost: float

    # ---- fabric (§7): the path the bridge law does NOT serialize --------------------
    fabric_p2p_bw: float       # NVLink-in-CVM / ICI analogue
    fabric_fallback_bw: float  # CC-compatible TCP fallback (NCCL without NVLink)

    def channel_bw(self, direction: Direction, cc_on: bool) -> float:
        if not cc_on:
            return self.native_h2d_bw if direction is Direction.H2D else self.native_d2h_bw
        return self.cc_channel_h2d_bw if direction is Direction.H2D else self.cc_channel_d2h_bw

    def aggregate_ceiling(self, direction: Direction) -> float:
        frac = (
            self.cc_multi_context_ceiling_h2d
            if direction is Direction.H2D
            else self.cc_multi_context_ceiling_d2h
        )
        native = self.native_h2d_bw if direction is Direction.H2D else self.native_d2h_bw
        return frac * native


# ---------------------------------------------------------------------------------
# Calibrated profiles.  Constants are the paper's own measurements where given;
# derived constants are noted inline.
# ---------------------------------------------------------------------------------

B300 = BridgeProfile(
    name="b300-hgx",
    native_h2d_bw=55.48 * GB,            # §4.1 table
    native_d2h_bw=57.38 * GB,
    native_toll=17.0 * US,               # §4.2 small-copy CC-off single stream
    native_fresh_alloc=14.7 * US,
    native_stream_scaling=0.24,          # §4.2: 17 -> 13 us at 16 streams
    cc_channel_h2d_bw=11.26 * GB,        # §4.1: 0.203x
    cc_channel_d2h_bw=12.08 * GB,        # §4.1: 0.211x
    cc_fresh_toll=330.0 * US,            # §4.2 / §5.2 bounce-buffer setup
    cc_fresh_alloc=1027.0 * US,          # derived: 1389 us aten::_to_copy − 330 toll − ~32 us base
    cc_registered_toll=40.0 * US,        # §4.2 small-copy CC-on floor
    cc_multi_context_ceiling_h2d=0.615,  # §4.1 multiprocess best
    cc_multi_context_ceiling_d2h=0.697,
    max_secure_contexts=24,              # §4.2 context sweep knee / NVIDIA ops guide
    context_create=5.20 / 8,             # §6.1: 5.2 s cuCtxCreate for 8 workers
    context_destroy=3.90 / 8,
    pinned_slot_alloc=0.30 / 8,
    compute_parity=0.998,                # §4.1 BF16 matmul
    hbm_parity=0.912,                    # §4.1 HBM harness
    cipher_duplex_bw=40.4 * GB,          # §4.3
    cipher_duplex_bw_no_aesni=5.5 * GB,
    vaes_ablation_cost=0.034,
    fabric_p2p_bw=510.4 * GB,            # §7.1 NVLink P2P inside CVM
    fabric_fallback_bw=10e6,             # §7.1 NCCL TCP fallback ~10 MB/s
)

RTX_PRO_6000 = BridgeProfile(
    name="rtx-pro-6000",
    native_h2d_bw=55.0 * GB,             # PCIe Gen5 (same class as B300 PCIe path)
    native_d2h_bw=55.0 * GB,
    native_toll=17.0 * US,
    native_fresh_alloc=14.7 * US,
    native_stream_scaling=0.24,
    cc_channel_h2d_bw=11.6 * GB,         # §4.2: "same 11.5-11.7 GB/s level"
    cc_channel_d2h_bw=11.6 * GB,
    cc_fresh_toll=330.0 * US,
    cc_fresh_alloc=1027.0 * US,
    cc_registered_toll=40.0 * US,
    cc_multi_context_ceiling_h2d=0.64,   # §4.2: ~35 GB/s at 24 contexts
    cc_multi_context_ceiling_d2h=0.64,
    max_secure_contexts=24,
    context_create=5.20 / 8,
    context_destroy=3.90 / 8,
    pinned_slot_alloc=0.30 / 8,
    compute_parity=0.998,
    hbm_parity=0.95,
    cipher_duplex_bw=40.4 * GB,
    cipher_duplex_bw_no_aesni=5.5 * GB,
    vaes_ablation_cost=0.034,
    fabric_p2p_bw=0.0,                   # no NVLink on this platform
    fabric_fallback_bw=10e6,
)

H200 = BridgeProfile(
    name="h200",
    native_h2d_bw=55.32 * GB,            # §4.2 boundary experiment
    native_d2h_bw=55.14 * GB,
    native_toll=15.0 * US,
    native_fresh_alloc=14.7 * US,
    native_stream_scaling=0.24,
    cc_channel_h2d_bw=10.03 * GB,
    cc_channel_d2h_bw=10.35 * GB,
    cc_fresh_toll=330.0 * US,
    cc_fresh_alloc=1027.0 * US,
    cc_registered_toll=35.0 * US,        # §4.2: 35 -> 34 us flat
    cc_multi_context_ceiling_h2d=0.62,
    cc_multi_context_ceiling_d2h=0.62,
    max_secure_contexts=24,
    context_create=5.20 / 8,
    context_destroy=3.90 / 8,
    pinned_slot_alloc=0.30 / 8,
    compute_parity=0.998,
    hbm_parity=0.93,
    cipher_duplex_bw=40.4 * GB,
    cipher_duplex_bw_no_aesni=5.5 * GB,
    vaes_ablation_cost=0.034,
    fabric_p2p_bw=0.0,                   # NVLinks blocked in the CC-off comparison
    fabric_fallback_bw=10e6,
)

#: TPU v5e adaptation profile (DESIGN.md §2).  There is no TPU confidential mode;
#: this profile expresses the *analogous* serialized regime for the host<->TPU
#: PCIe path so the same runtime discipline can be exercised and unit-costed:
#: a single per-device transfer stream (streams never scale), a per-`device_put`
#: dispatch+layout toll, and ICI as the fabric path the bridge does not touch.
TPU_V5E = BridgeProfile(
    name="tpu-v5e",
    native_h2d_bw=32.0 * GB,             # PCIe Gen4 x16 host link (per host, 4 chips)
    native_d2h_bw=32.0 * GB,
    native_toll=25.0 * US,               # runtime dispatch + reformat floor
    native_fresh_alloc=20.0 * US,
    native_stream_scaling=0.0,           # single transfer stream per device already
    cc_channel_h2d_bw=8.0 * GB,          # modeled secure-staging regime
    cc_channel_d2h_bw=8.0 * GB,
    cc_fresh_toll=330.0 * US,
    cc_fresh_alloc=1027.0 * US,
    cc_registered_toll=45.0 * US,
    cc_multi_context_ceiling_h2d=0.65,
    cc_multi_context_ceiling_d2h=0.65,
    max_secure_contexts=16,
    context_create=5.20 / 8,
    context_destroy=3.90 / 8,
    pinned_slot_alloc=0.30 / 8,
    compute_parity=1.0,
    hbm_parity=1.0,
    cipher_duplex_bw=40.4 * GB,
    cipher_duplex_bw_no_aesni=5.5 * GB,
    vaes_ablation_cost=0.034,
    fabric_p2p_bw=50.0 * GB,             # one ICI link direction
    fabric_fallback_bw=10e6,
)

PROFILES = {p.name: p for p in (B300, RTX_PRO_6000, H200, TPU_V5E)}


@dataclass(frozen=True)
class Crossing:
    """One host<->device crossing, the unit the bridge law prices."""

    nbytes: int
    direction: Direction
    staging: StagingKind = StagingKind.REGISTERED


class BridgeModel:
    """Computable form of the serialized-bridge law.

    All methods are pure; scheduling across channels is handled by the
    discrete-event simulator (simulator.py) on top of these primitives.
    """

    def __init__(self, profile: BridgeProfile, cc_on: bool, *, aesni: bool = True,
                 vaes: bool = True):
        self.profile = profile
        self.cc_on = cc_on
        self.aesni = aesni
        self.vaes = vaes

    # -- single crossing -----------------------------------------------------------

    def crossing_time(self, crossing: Crossing, *, n_contexts: int = 1) -> float:
        """Wall time for one crossing, given `n_contexts` pooled secure contexts.

        CC-off: toll + bytes/native_bw.
        CC-on : staging toll (FRESH: alloc + 330 us setup; REGISTERED: warm floor)
                + bytes over the secure channel(s), capped by the multi-context
                ceiling and the cipher plateau (§4.3).
        """
        p = self.profile
        if not self.cc_on:
            bw = p.channel_bw(crossing.direction, cc_on=False)
            toll = p.native_toll
            if crossing.staging is StagingKind.FRESH:
                toll += p.native_fresh_alloc
            return toll + crossing.nbytes / bw

        if crossing.staging is StagingKind.FRESH:
            toll = p.cc_fresh_toll + p.cc_fresh_alloc
        else:
            toll = p.cc_registered_toll
        bw = self.aggregate_bandwidth(crossing.direction, n_contexts)
        return toll + crossing.nbytes / bw

    # -- bandwidth law ---------------------------------------------------------------

    def aggregate_bandwidth(self, direction: Direction, n_contexts: int) -> float:
        """Sustained large-transfer bandwidth with ``n_contexts`` contexts (L1+L4).

        One context = one secure channel.  Contexts scale linearly until the
        system ceiling (fraction of native bw); the CPU cipher plateau also
        caps the path (it binds only when AES-NI is ablated — §4.3).
        """
        p = self.profile
        if not self.cc_on:
            return p.channel_bw(direction, cc_on=False)
        n = max(1, min(n_contexts, p.max_secure_contexts))
        linear = n * p.channel_bw(direction, cc_on=True)
        ceiling = p.aggregate_ceiling(direction)
        bw = min(linear, ceiling)
        return min(bw, self._cipher_cap())

    def _cipher_cap(self) -> float:
        p = self.profile
        if not self.aesni:
            return p.cipher_duplex_bw_no_aesni
        cap = p.cipher_duplex_bw
        if not self.vaes:
            cap *= 1.0 - p.vaes_ablation_cost
        return cap

    def stream_scaling(self, direction: Direction, n_streams: int) -> float:
        """Per-copy latency for small same-context copies vs stream count (L1).

        CC-on: flat — streams share one serialized channel (paper: 40 -> 39 us).
        CC-off: modest scaling (paper: 17 -> 13 us at 16 streams, ~24%).
        """
        p = self.profile
        if self.cc_on:
            base = p.cc_registered_toll
            # ~2.5% total improvement from 1 to 16 streams (queueing jitter only)
            frac = 0.025 * (1.0 - 1.0 / max(1, n_streams))
            return base * (1.0 - frac)
        base = p.native_toll
        frac = p.native_stream_scaling * (1.0 - 1.0 / max(1, n_streams))
        return base * (1.0 - frac)

    # -- batch pricing (what the gateway uses) ------------------------------------------

    def batch_time(self, crossings: list[Crossing], *, n_contexts: int = 1) -> float:
        """Serialized cost of a list of crossings within one context pool.

        Under CC, same-context crossings serialize (L1): total = sum of tolls +
        total bytes over the aggregate channel.  CC-off, crossings pipeline on
        abundant DMA: total = max(per-crossing) + queued dispatch.
        """
        if not crossings:
            return 0.0
        if self.cc_on:
            return sum(self.crossing_time(c, n_contexts=n_contexts) for c in crossings)
        # CC-off: dispatch serializes lightly; byte movement pipelines.
        p = self.profile
        dispatch = p.native_toll * len(crossings)
        bytes_by_dir = {d: 0 for d in Direction}
        for c in crossings:
            bytes_by_dir[c.direction] += c.nbytes
        move = max(
            bytes_by_dir[d] / p.channel_bw(d, cc_on=False) for d in Direction
        )
        return dispatch + move

    # -- device-local parity ------------------------------------------------------------

    def compute_time(self, flops: float, peak_flops: float) -> float:
        """Device compute is at parity under CC (L5)."""
        parity = self.profile.compute_parity if self.cc_on else 1.0
        return flops / (peak_flops * parity)

    def hbm_time(self, nbytes: float, hbm_bw: float) -> float:
        parity = self.profile.hbm_parity if self.cc_on else 1.0
        return nbytes / (hbm_bw * parity)

    # -- context lifecycle ---------------------------------------------------------------

    def pool_lifecycle_cost(self, n_workers: int) -> dict[str, float]:
        p = self.profile
        return {
            "create": p.context_create * n_workers,
            "destroy": p.context_destroy * n_workers,
            "pinned_alloc": p.pinned_slot_alloc * n_workers,
        }

    # -- convenience ratios (benchmarks assert these against the paper) --------------------

    def sustained_ratio(self, direction: Direction, *, n_contexts: int = 1) -> float:
        """CC-on / CC-off sustained bandwidth ratio for large transfers."""
        cc = self.aggregate_bandwidth(direction, n_contexts)
        native = self.profile.channel_bw(direction, cc_on=False)
        return cc / native


def bridge_pair(profile: BridgeProfile) -> tuple[BridgeModel, BridgeModel]:
    """(CC-off, CC-on) model pair for a platform."""
    return BridgeModel(profile, cc_on=False), BridgeModel(profile, cc_on=True)
