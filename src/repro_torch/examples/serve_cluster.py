"""Multi-tenant cluster serving demo: replicas on fabric partitions, a
shared secure-context budget, prefix-affinity routing, and an autoscaler
decision — all deterministic on the virtual clock.

    PYTHONPATH=src python -m repro_torch.examples.serve_cluster \\
        [--arch olmo-1b] [--replicas 2] [--requests 10] [--cc-off] \\
        [--device cpu]

Submits sequential sessions that share a prompt prefix (the §6.2 churn
shape) to a cluster of confidential tenants, then prints per-replica
placement, warm restores, the isolation report, the attestation gap, and
what the autoscaler would do next.  The port's counterpart of
``examples/serve_cluster.py``: the same lines, every replica serving on
the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

from repro_torch.cluster import Autoscaler, RoutingPolicy, build_cluster
from repro_torch.configs.base import ARCH_IDS, get_config, smoke_config
from repro_torch.models.model import Model
from repro_torch.serving.engine import Request
from repro_torch.serving.sampler import SamplingParams


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="olmo-1b")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--cc-off", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    cc_on = not args.cc_off

    model = Model(smoke_config(get_config(args.arch)), seed=0,
                  device=args.device)
    cluster = build_cluster(model, cc_on=cc_on, n_replicas=args.replicas,
                            partition_size=2,
                            routing=RoutingPolicy.PREFIX_AFFINITY)

    print(f"cluster: {args.replicas} replicas x 2-device partitions, "
          f"CC {'on' if cc_on else 'off'}, "
          f"context leases {[r.lease.n_contexts for r in cluster.replicas]} "
          f"(system-wide budget "
          f"{cluster.budget.limit if cluster.budget.limit else 'unlimited'})")
    for rec in cluster.tenant_manager.records:
        print(f"  {rec.tenant_id}: partition {rec.partition_id} "
              f"({rec.size} devices), activated in "
              f"{rec.activation_seconds:.0f}s, attested={rec.attested}")

    prefix = list(range(1, 17))
    for i in range(args.requests):
        cluster.submit(Request(f"r{i}", prompt=prefix + [100 + i] * 8,
                               sampling=SamplingParams(max_new_tokens=6)))
        cluster.run()

    print(f"\n{'request':8s} {'replica':10s} {'affinity':>8s} "
          f"{'warm_blocks':>11s} {'ttft_ms':>8s}")
    for t in cluster.ttfts():
        print(f"{t['request_id']:8s} {t['replica_id']:10s} "
              f"{str(t['affinity']):>8s} {t['warm_blocks']:>11d} "
              f"{t['ttft_s']*1e3:>8.2f}")

    st = cluster.stats()
    print(f"\nfinished={st['finished']}  tokens={st['total_tokens']}  "
          f"throughput={st['tokens_per_s']:.1f} tok/s  "
          f"warm_blocks_restored={st['warm_blocks_restored']}")
    iso = st["isolation"]
    print(f"isolation: {iso['isolated']}  tenants={iso['tenants']}")
    gap = cluster.tenant_manager.attest(cluster.replicas[0].tenant)["gap"]
    print(f"attestation gap (host-trusted today): {gap}")

    scaler = Autoscaler(cluster.budget)
    verdict = scaler.evaluate([r.metrics() for r in cluster.replicas])
    print(f"autoscaler: {verdict['decision'].value} "
          f"(queue delay {verdict['mean_queue_delay_s']*1e3:.2f} ms, "
          f"bridge fraction {verdict['bridge_fraction']:.1%}, "
          f"budget available {verdict['budget_available']})")
    cluster.close()
    return st


if __name__ == "__main__":
    main()
