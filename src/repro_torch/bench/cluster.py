"""Cluster serving layer: shared secure-context budget (§4 L4 fleet-level),
prefix-affinity routing over KV/offload inventories (§6.2), and concurrent
confidential tenants on disjoint fabric partitions (§7.1).

Three claims, all on the virtual clock with the real engine:
  (a) CC-on cluster throughput degrades vs CC-off under the shared budget,
  (b) prefix-affinity routing beats least-loaded on warm TTFT with offload
      enabled (evidence stays concentrated, prefixes restore instead of
      recomputing),
  (c) concurrent tenants on disjoint partitions pass isolation checks while
      serving simultaneously.

The port's counterpart of ``benchmarks/bench_cluster.py``: the same rows.
``run(device)`` serves the smoke olmo-1b (``trace.harness.smoke_model``)
on ``device``, the card unless the caller asks for the CPU; the row
functions take any ``model`` (``chip_smoke.py`` passes full-width
olmo-1b).  Every row is virtual-clock time or a count: none is host wall
time.

    PYTHONPATH=src python -m repro_torch.bench.cluster [--device cpu]
"""

from __future__ import annotations

import numpy as np

from repro_torch.bench import bench_main
from repro_torch.cluster import RoutingPolicy, SecureContextBudget, build_cluster
from repro_torch.core.bridge import TPU_V5E
from repro_torch.serving.engine import Request
from repro_torch.serving.sampler import SamplingParams
from repro_torch.trace.harness import smoke_model

PREFIX = list(range(1, 17))          # 2 shared 8-token prefix blocks


def _serve_waves(cluster, n_requests: int, max_new_tokens: int = 4):
    """Sequential sessions sharing a prompt prefix (the §6.2 churn shape):
    each request drains before the next arrives, so eviction feeds the
    reuse evidence the next arrival can hit."""
    for i in range(n_requests):
        cluster.submit(Request(
            f"r{i}", prompt=PREFIX + [100 + i] * 8,
            sampling=SamplingParams(max_new_tokens=max_new_tokens)))
        cluster.run()
    return cluster.stats()


def budget_throughput_rows(model) -> list[tuple[str, float, str]]:
    """(a) CC tax at cluster level + the context-redistribution law."""
    out = []
    tps = {}
    for cc in (False, True):
        cluster = build_cluster(model, cc_on=cc, n_replicas=2,
                                partition_size=2,
                                routing=RoutingPolicy.LEAST_LOADED)
        st = _serve_waves(cluster, 12)
        tps[cc] = st["tokens_per_s"]
        tag = "on" if cc else "off"
        out.append((f"cluster/cc_{tag}_tokens_per_s", st["tokens_per_s"],
                    f"2 replicas, leases={st['leased_contexts']}, "
                    f"finished={st['finished']}"))
        cluster.close()
    out.append(("cluster/cc_degradation_pct", 100 * (tps[True] / tps[False] - 1),
                "paper: 13-27% serving loss under GPU-CC (same drained "
                "schedule both modes; the residual is the bridge itself)"))

    # redistribution: the budget is system-wide, so fleet growth shrinks
    # every replica's lease instead of adding bridge bandwidth
    budget = SecureContextBudget(TPU_V5E, cc_on=True)
    for n in (2, 4, 8):
        grants = budget.fair_share(n, requested=8)
        out.append((f"cluster/lease_per_replica_{n}r", float(grants[0]),
                    f"sum={sum(grants)} <= system limit "
                    f"{TPU_V5E.max_secure_contexts} (L4: redistributes, "
                    f"not multiplies)"))
    return out


def routing_rows(model) -> list[tuple[str, float, str]]:
    """(b) prefix-affinity vs bridge-cost-aware least-loaded, warm TTFT."""
    out = []
    warm_ttft = {}
    for routing in (RoutingPolicy.LEAST_LOADED, RoutingPolicy.PREFIX_AFFINITY):
        cluster = build_cluster(model, cc_on=True, n_replicas=4,
                                partition_size=2, routing=routing)
        st = _serve_waves(cluster, 12)
        # warm window: requests arriving after reuse evidence can exist
        ttfts = [t["ttft_s"] for t in cluster.ttfts()
                 if int(t["request_id"][1:]) >= 2]
        warm_ttft[routing] = float(np.mean(ttfts))
        out.append((f"cluster/{routing.value}_warm_ttft_ms",
                    warm_ttft[routing] * 1e3,
                    f"affinity_hits={st['affinity_hits']}, "
                    f"warm_blocks_restored={st['warm_blocks_restored']}"))
        cluster.close()
    out.append(("cluster/affinity_warm_ttft_speedup_x",
                warm_ttft[RoutingPolicy.LEAST_LOADED]
                / warm_ttft[RoutingPolicy.PREFIX_AFFINITY],
                "affinity concentrates reuse evidence -> restores instead of "
                "recomputing (§6.2 at cluster scale; >1 = affinity wins)"))
    return out


def tenancy_rows(model) -> list[tuple[str, float, str]]:
    """(c) concurrent confidential tenants serving simultaneously."""
    out = []
    cluster = build_cluster(model, cc_on=True, n_replicas=2, partition_size=2,
                            routing=RoutingPolicy.LEAST_LOADED)
    # put live traffic on both tenants, then isolation-check mid-serving
    for i in range(4):
        cluster.submit(Request(f"t{i}", prompt=PREFIX + [200 + i] * 8,
                               sampling=SamplingParams(max_new_tokens=6)))
    for r in cluster.replicas:
        r.tick()
    both_active = all(r.engine.active or r.engine.queue
                      for r in cluster.replicas)
    iso = cluster.tenant_manager.isolation_report()
    devices = [set(r.tenant.visible_devices()) for r in cluster.replicas]
    out.append(("cluster/tenants_serving_simultaneously", float(both_active),
                "both replicas had live requests at the check"))
    out.append(("cluster/tenants_isolated", float(iso["isolated"]),
                f"paper §7.1: each sees exactly its partition {iso['tenants']}"))
    out.append(("cluster/tenant_devices_disjoint",
                float(not (devices[0] & devices[1])),
                f"partitions {sorted(devices[0])} vs {sorted(devices[1])}"))
    st = cluster.run()
    out.append(("cluster/tenants_finished_all", float(st["finished"] == 4),
                f"finished={st['finished']} across "
                f"{st['n_replicas']} tenants"))
    attested = all(rec.attested for rec in cluster.tenant_manager.records)
    out.append(("cluster/tenants_attestation_gated", float(attested),
                "replicas only serve after required §7.3 claims verify"))
    cluster.close()
    return out


def run(device=None) -> list[str]:
    model = smoke_model(device=device)
    lines = []
    for fn in (budget_throughput_rows, routing_rows, tenancy_rows):
        for name, val, derived in fn(model):
            lines.append(f"{name},{val:.4f},{derived}")
    return lines


def main(argv=None) -> None:
    bench_main(argv, doc=__doc__, run=run)


if __name__ == "__main__":
    main()
