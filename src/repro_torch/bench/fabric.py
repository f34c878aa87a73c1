"""§7.1: confidential fabric tenancy qualification (ICI-mesh analogue).

Partition vocabulary enumeration, concurrent tenant isolation, in-tenant P2P
bandwidth vs bridge bandwidth (the one path CC does not serialize), the TCP
fallback cliff, and the attestation-evidence gap.

The port's counterpart of ``benchmarks/bench_fabric.py``: the same rows, on the
virtual clock only (no model, no device).

    PYTHONPATH=src python -m repro_torch.bench.fabric
"""

from __future__ import annotations

from repro_torch.core.bridge import B300, BridgeModel, Direction
from repro_torch.core.fabric import (AttestationEvidence, FabricManager,
                                     enumerate_partitions, p2p_bandwidth)

GB = 1e9


def rows() -> list[tuple[str, float, str]]:
    out = []
    parts = enumerate_partitions(8)
    sizes = sorted(p.size for p in parts)
    out.append(("7.1/partition_definitions", float(len(parts)),
                "paper=15 (one 8, two 4, four 2, eight 1)"))
    out.append(("7.1/vocab_8", float(sizes.count(8)), "paper=1"))
    out.append(("7.1/vocab_4", float(sizes.count(4)), "paper=2"))
    out.append(("7.1/vocab_2", float(sizes.count(2)), "paper=4"))
    out.append(("7.1/vocab_1", float(sizes.count(1)), "paper=8"))

    fm = FabricManager(B300)
    t1 = fm.activate("tenant-a", 2)
    t2 = fm.activate("tenant-b", 2)
    iso = fm.check_isolation()
    out.append(("7.1/concurrent_n2_tenants_isolated", float(iso["isolated"]),
                f"paper: each sees exactly its 2 GPUs {iso['tenants']}"))
    out.append(("7.1/activation_seconds", t1.activation_seconds,
                "paper=10-20 s per tenant (fmpm -a/-d)"))

    # stale-FM health gate (the operational failure mode)
    fm2 = FabricManager(B300)
    fm2.mark_stale(fm2.partitions[0].partition_id)
    gated = False
    try:
        fm2.activate("tenant-c", 8)
    except RuntimeError:
        gated = True
    out.append(("7.2/stale_fm_health_gate_fires", float(gated),
                "paper: fabric-state health checks as scheduling precondition"))

    # P2P inside the tenant vs the bridge: two orders of magnitude
    p2p = p2p_bandwidth(B300, fabric_up=True)
    bridge_bw = BridgeModel(B300, cc_on=True).aggregate_bandwidth(Direction.H2D, 1)
    out.append(("7.1/in_tenant_p2p_gbps", p2p / GB, "paper=510.4 (NVLink in CVM)"))
    out.append(("7.1/p2p_over_bridge_x", p2p / bridge_bw,
                "paper: two orders of magnitude above the CVM-GPU bridge"))
    out.append(("7.1/tcp_fallback_mbps", p2p_bandwidth(B300, fabric_up=False) / 1e6,
                "paper~10 MB/s (NCCL TCP fallback with NVLink disabled)"))

    ev = AttestationEvidence()
    out.append(("7.3/verifiable_claims", float(len(ev.verified_claims())),
                f"tenant can verify: {ev.verified_claims()}"))
    out.append(("7.3/attestation_gap_claims", float(len(ev.gap())),
                f"host-trusted today: {ev.gap()}"))
    return out


def run() -> list[str]:
    return [f"fabric/{n},{v:.3f},{d}" for n, v, d in rows()]


if __name__ == "__main__":
    print("\n".join(run()))
