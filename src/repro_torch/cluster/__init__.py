"""Multi-tenant cluster serving layer (paper §7 x §4 L4).

Composes the single-engine serving stack with the fabric tenancy model:
replicas bound to fabric partitions, a cluster-wide secure-context budget
(the §4 system-wide channel limit as a fleet resource), prefix-affinity
routing over exported KV/offload inventories (§6.2), and an autoscaler
that reads the virtual clock instead of wall time.
"""

from .autoscaler import Autoscaler, AutoscalerConfig, ScaleDecision
from .budget import (BudgetExhausted, ContextLease, PinnedBudget, PinnedLease,
                     SecureContextBudget)
from .replica import Replica, ReplicaConfig, ReplicaMetrics, prompt_prefix_hashes
from .router import ClusterRouter, RoutingPolicy, build_cluster
from .tenant_manager import AttestationError, TenantManager

__all__ = [
    "Autoscaler", "AutoscalerConfig", "ScaleDecision",
    "BudgetExhausted", "ContextLease", "PinnedBudget", "PinnedLease",
    "SecureContextBudget",
    "Replica", "ReplicaConfig", "ReplicaMetrics", "prompt_prefix_hashes",
    "ClusterRouter", "RoutingPolicy", "build_cluster",
    "AttestationError", "TenantManager",
]
