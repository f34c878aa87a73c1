"""Confidential fabric tenancy (paper §7), adapted to the TPU ICI mesh.

On B300 HGX the confidential tenant is a *partition of an NVSwitch fabric*:
a fixed vocabulary of 1/2/4/8-GPU shapes, activated per tenant by a
host-trusted Fabric Manager, with NVLink P2P (510 GB/s) inside the tenant —
the one data path GPU-CC does not serialize.  The TPU analogue: a tenant is a
sub-block of the pod's ICI torus; the scheduling object is a fabric-valid
mesh partition, and ICI is the path the (modeled) bridge tax never touches.

This module provides:
  * the partition vocabulary and its enumeration (15 partitions on an
    8-device unit: one 8, two 4, four 2, eight 1 — §7.1),
  * tenant activation with FM-style health gating and lifecycle timing,
  * concurrent-tenant isolation checks (disjointness, no management plane
    exposure),
  * the attestation-evidence model, including the fabric-attestation *gap*
    (§7.3): what a tenant can and cannot verify.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from dataclasses import dataclass, field
from typing import Optional

from .bridge import BridgeProfile

#: fabric-valid tenant shapes (§7.1: "a fixed 1/2/4/8 partition vocabulary
#: that becomes the scheduling API")
PARTITION_VOCABULARY = (1, 2, 4, 8)

#: fmpm -a / -d activation window, seconds (§7.1: 10-20 s per tenant)
ACTIVATE_SECONDS = (10.0, 20.0)


class FabricState(enum.Enum):
    HEALTHY = "completed/healthy"
    STALE = "stale-partition-state"     # the FM cache-staleness failure mode
    DEGRADED = "degraded"


@dataclass(frozen=True)
class PartitionDef:
    """One fabric partition definition (FM vocabulary entry)."""

    partition_id: int
    device_ids: tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.device_ids)


def enumerate_partitions(n_devices: int = 8) -> list[PartitionDef]:
    """FM-style partition enumeration: contiguous power-of-two blocks.

    For 8 devices this yields 15 definitions: 1x8, 2x4, 4x2, 8x1 (§7.1).
    """
    if n_devices & (n_devices - 1):
        raise ValueError("fabric unit must be a power of two")
    parts: list[PartitionDef] = []
    pid = itertools.count()
    size = n_devices
    while size >= 1:
        if size in PARTITION_VOCABULARY:
            for start in range(0, n_devices, size):
                parts.append(PartitionDef(next(pid), tuple(range(start, start + size))))
        size //= 2
    return parts


@dataclass
class AttestationEvidence:
    """What the tenant can (and cannot) verify — §7.3.

    Verifiable today: CVM evidence, device CC mode + ready state, device
    attestation reports, guest-visible fabric health/topology.
    NOT verifiable (the gap): the Fabric Manager binary/config that
    programmed the partition, and the switch routing tables.
    """

    cvm_evidence: bool = True
    device_cc_mode: bool = True
    device_ready_state: bool = True
    device_attestation_report: bool = True
    guest_fabric_health: bool = True
    guest_fabric_topology: bool = True
    # --- the attestation gap (host-trusted control plane) ---
    fabric_manager_identity: bool = False
    fabric_manager_config: bool = False
    switch_routing_tables: bool = False

    def verified_claims(self) -> list[str]:
        return [f.name for f in dataclasses.fields(self) if getattr(self, f.name)]

    def gap(self) -> list[str]:
        return [f.name for f in dataclasses.fields(self) if not getattr(self, f.name)]


@dataclass
class Tenant:
    tenant_id: str
    partition: PartitionDef
    fabric_state: FabricState = FabricState.HEALTHY
    cc_on: bool = True
    evidence: AttestationEvidence = field(default_factory=AttestationEvidence)
    activation_seconds: float = 15.0

    def visible_devices(self) -> tuple[int, ...]:
        """Each tenant sees exactly its partition's devices (§7.1 isolation)."""
        return self.partition.device_ids


class FabricManager:
    """Host-side fabric control plane (deliberately OUTSIDE tenant trust).

    Models partition activation with health gating — the paper's operational
    lesson: "stale FM partition state surfacing as guest FLA remap validation
    errors argue for fabric-state health checks as a scheduling precondition".
    """

    def __init__(self, profile: BridgeProfile, n_devices: int = 8):
        self.profile = profile
        self.n_devices = n_devices
        self.partitions = enumerate_partitions(n_devices)
        self.active: dict[str, Tenant] = {}
        self._partition_state: dict[int, FabricState] = {
            p.partition_id: FabricState.HEALTHY for p in self.partitions}

    # -- scheduling API: allocate fabric-valid shapes, never arbitrary sets --------------

    def find_partition(self, size: int, *,
                       require_healthy: bool = False) -> Optional[PartitionDef]:
        if size not in PARTITION_VOCABULARY:
            raise ValueError(
                f"requested shape {size} not in partition vocabulary {PARTITION_VOCABULARY}")
        busy = {d for t in self.active.values() for d in t.partition.device_ids}
        for p in self.partitions:
            if p.size != size or (set(p.device_ids) & busy):
                continue
            if require_healthy and \
                    self._partition_state[p.partition_id] is not FabricState.HEALTHY:
                continue
            return p
        return None

    def activate(self, tenant_id: str, size: int, *,
                 require_healthy: bool = True) -> Tenant:
        """fmpm -a analogue: activate a partition for a tenant.

        `require_healthy` is the scheduling precondition the paper argues
        for; with it off, a stale partition activates and the tenant hits
        guest-side remap validation errors (modeled as RuntimeError at use).
        With it on, unhealthy partitions are skipped during the search — a
        stale partition 0 must not shadow a healthy free partition 1.
        """
        part = self.find_partition(size, require_healthy=require_healthy)
        if part is None:
            if require_healthy:
                # Distinguish "fabric full" from "free capacity exists but
                # the health gate vetoed it" — the latter is the paper's
                # stale-FM scheduling precondition firing.
                unhealthy = self.find_partition(size)
                if unhealthy is not None:
                    state = self._partition_state[unhealthy.partition_id]
                    raise RuntimeError(
                        f"fabric-state health gate: partition "
                        f"{unhealthy.partition_id} is {state.value}")
            raise RuntimeError(f"no free {size}-device partition")
        state = self._partition_state[part.partition_id]
        tenant = Tenant(tenant_id, part, fabric_state=state,
                        activation_seconds=sum(ACTIVATE_SECONDS) / 2)
        self.active[tenant_id] = tenant
        return tenant

    def deactivate(self, tenant_id: str) -> None:
        self.active.pop(tenant_id, None)

    def mark_stale(self, partition_id: int) -> None:
        """Inject the FM cache-staleness failure mode (§7.1 n=8 blocker)."""
        self._partition_state[partition_id] = FabricState.STALE

    # -- isolation checks (§7.1 "concurrent tenant isolation") ----------------------------

    def check_isolation(self) -> dict[str, object]:
        seen: dict[int, str] = {}
        for t in self.active.values():
            for d in t.partition.device_ids:
                if d in seen:
                    return {"isolated": False,
                            "conflict": (seen[d], t.tenant_id, d)}
                seen[d] = t.tenant_id
        return {
            "isolated": True,
            "tenants": {t.tenant_id: t.visible_devices() for t in self.active.values()},
            "management_nics_exposed": False,
        }


def p2p_bandwidth(profile: BridgeProfile, *, fabric_up: bool) -> float:
    """In-tenant device-to-device bandwidth (bytes/s).

    Fabric up: full P2P (510 GB/s NVLink-in-CVM / ICI analogue) — two orders
    of magnitude above the CVM<->device bridge, and it does not transit host
    memory: the one path CC does not serialize.
    Fabric down: CC-compatible TCP fallback (~10 MB/s measured).
    """
    return profile.fabric_p2p_bw if fabric_up else profile.fabric_fallback_bw


class FabricTransport:
    """The tenant-side view of its fabric: prices P2P crossings (DESIGN §12).

    Attached to a `TransferGateway` as `gateway.fabric`, this is what decides
    whether a P2P crossing rides the full in-tenant fabric rate or the
    CC-compatible TCP fallback.  Fabric is *up* for a tenant only when all of
    the following hold:

      * its partition's fabric state is HEALTHY (a STALE/DEGRADED tenant hits
        guest FLA remap validation errors and must fall back),
      * its attestation evidence is current (`attested()` hook — wired to
        `TenantManager` freshness in the cluster layer; evidence that lapses
        mid-flight reprices subsequent P2P traffic, tape-visibly),
      * the profile has a fabric at all (`fabric_p2p_bw > 0`; RTX Pro 6000 /
        H200 single-device profiles never had one).

    The decision is re-evaluated per crossing, so a `mark_stale` or a lapsed
    TTL between two migrations is visible as a pricing step in the tape.
    """

    def __init__(self, profile: BridgeProfile, tenant: Optional[Tenant] = None,
                 *, attested=None):
        self.profile = profile
        self.tenant = tenant
        self._attested = attested

    def fabric_up(self) -> bool:
        if self.profile.fabric_p2p_bw <= 0:
            return False
        if self.tenant is not None and \
                self.tenant.fabric_state is not FabricState.HEALTHY:
            return False
        if self._attested is not None and not self._attested():
            return False
        return True

    def bandwidth(self) -> float:
        return p2p_bandwidth(self.profile, fabric_up=self.fabric_up())
