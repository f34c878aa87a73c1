"""Tenant lifecycle on the fabric partition vocabulary (paper §7).

Maps serving replicas onto 1/2/4/8 fabric partitions with the operational
disciplines the paper argues for:

  * fabric-state *health gating* as a scheduling precondition (stale FM
    partition state otherwise surfaces as guest remap-validation errors),
  * *attestation gating*: a CC tenant is only handed to the serving layer
    once its verifiable claims check out; the claims a tenant cannot verify
    (FM identity/config, switch routing tables — §7.3) are surfaced as the
    attestation gap rather than silently trusted,
  * *activation lifecycle timing* (fmpm -a/-d, 10-20 s per tenant) accounted
    on the control plane, off the serving clock.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.bridge import BridgeProfile
from repro_torch.core.fabric import (ACTIVATE_SECONDS, PARTITION_VOCABULARY,
                               AttestationEvidence, FabricManager, Tenant)


class AttestationError(RuntimeError):
    """A required tenant claim failed verification."""


#: claims a CC tenant must verify before serving traffic (§7.3); the rest of
#: AttestationEvidence's fields are the host-trusted gap
REQUIRED_CLAIMS = (
    "cvm_evidence",
    "device_cc_mode",
    "device_ready_state",
    "device_attestation_report",
    "guest_fabric_health",
)


@dataclass(frozen=True)
class ProvisionRecord:
    tenant_id: str
    partition_id: int
    size: int
    activation_seconds: float
    attested: bool


class TenantManager:
    """Replica-facing front of the (untrusted) FabricManager control plane."""

    def __init__(self, profile: BridgeProfile, n_devices: int = 8, *,
                 cc_on: bool = True):
        self.fm = FabricManager(profile, n_devices)
        self.cc_on = cc_on
        self.records: list[ProvisionRecord] = []
        #: cumulative fmpm -a/-d wall time (control plane, not serving path)
        self.control_plane_seconds = 0.0
        #: re-attestation round trips served (DESIGN.md §11): attestation
        #: evidence carries a TTL under the resilience model; an expired
        #: replica quarantines until this re-verification passes.  The
        #: serving-clock cost of each round trip is charged by the replica's
        #: FaultInjector (a tape-visible ``reattest`` record) — the ledger
        #: here is the fleet-wide count.
        self.reattests = 0

    # -- provisioning ----------------------------------------------------------------

    def capacity(self, size: int) -> int:
        """How many more `size`-device tenants the fabric can host."""
        if size not in PARTITION_VOCABULARY:
            raise ValueError(f"{size} not in vocabulary {PARTITION_VOCABULARY}")
        busy = {d for t in self.fm.active.values()
                for d in t.partition.device_ids}
        return sum(1 for p in self.fm.partitions
                   if p.size == size and not (set(p.device_ids) & busy))

    def provision(self, tenant_id: str, size: int, *,
                  require_healthy: bool = True,
                  require_attestation: bool = True,
                  evidence: Optional[AttestationEvidence] = None) -> Tenant:
        """Activate a partition for a tenant, health- and attestation-gated.

        `evidence` overrides the tenant's attestation evidence (testing /
        degraded-platform injection).
        """
        if tenant_id in self.fm.active:
            raise ValueError(f"tenant {tenant_id!r} already active")
        tenant = self.fm.activate(tenant_id, size,
                                  require_healthy=require_healthy)
        tenant.cc_on = self.cc_on
        if evidence is not None:
            tenant.evidence = evidence
        attested = False
        if self.cc_on and require_attestation:
            report = self.attest(tenant)
            if not report["ok"]:
                self.fm.deactivate(tenant_id)
                raise AttestationError(
                    f"tenant {tenant_id!r} failed required claims: "
                    f"{report['failed']}")
            attested = True
        self.control_plane_seconds += tenant.activation_seconds
        self.records.append(ProvisionRecord(
            tenant_id, tenant.partition.partition_id, size,
            tenant.activation_seconds, attested))
        return tenant

    def decommission(self, tenant_id: str) -> None:
        if tenant_id in self.fm.active:
            # fmpm -d is the same lifecycle window as activation
            self.control_plane_seconds += sum(ACTIVATE_SECONDS) / 2
        self.fm.deactivate(tenant_id)

    # -- verification ----------------------------------------------------------------

    def attest(self, tenant: Tenant) -> dict:
        """Check the tenant's verifiable claims; report the gap explicitly."""
        ev = tenant.evidence
        failed = [c for c in REQUIRED_CLAIMS if not getattr(ev, c)]
        return {
            "ok": not failed,
            "failed": failed,
            "verified": ev.verified_claims(),
            "gap": ev.gap(),
        }

    def reattest(self, tenant: Tenant) -> dict:
        """Re-verify an active tenant whose attestation TTL lapsed.

        Same claim set as provisioning-time attestation — expiry does not
        weaken the policy.  Returns the attest report; the caller (Replica)
        stays quarantined unless ``report["ok"]``.
        """
        report = self.attest(tenant)
        self.reattests += 1
        return report

    def isolation_report(self) -> dict:
        """Concurrent-tenant isolation check (§7.1) across active tenants."""
        return self.fm.check_isolation()
