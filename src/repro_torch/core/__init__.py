"""The paper's primary contribution: the serialized-bridge law and the
CC-aware serving runtime built on it.

Layers (each applies the law at a different level of the stack):
  bridge.py      — the law itself + calibrated platform profiles
  channels.py    — secure contexts: pooling, lifecycle economics, virtual clock
  compute.py     — roofline pricing of prefill/decode steps (the clock's
                   compute charges; the other side of the hideability ratio)
  simulator.py   — decode-step pipeline model: policy inversion + recovery
  policy.py      — scheduling/offload policy vocabulary, CC-aware defaults
  accounting.py  — profiler attribution loop (closes the gap to op classes)
  gateway.py     — runtime crossing discipline (batch, drain, pool)
  fabric.py      — fabric partitions as the confidential scheduling unit
"""

from .bridge import (
    B300, H200, PROFILES, RTX_PRO_6000, TPU_V5E,
    BridgeModel, BridgeProfile, Crossing, Direction, StagingKind, bridge_pair,
)
from .channels import SecureChannelPool, SecureContext, VirtualClock
from .compute import (COMPUTE_SPECS, ComputeCharge, ComputeModel,
                      ComputeSpec)
from .policy import (
    OffloadPolicy, PolicyOutcome, RuntimeDefaults, SchedulingPolicy,
    cc_aware_defaults, detect_inversion, recovered_fraction,
)
from .simulator import (
    Observation, ServingWorkload, StepBreakdown, fit_workload,
    simulate_matrix, step_breakdown, tokens_per_s, tpot_ms,
)
from .accounting import Attribution, CopyRecord, OpClassRow, attribute, format_table
from .gateway import GatewayStats, TransferGateway
from .fabric import (
    PARTITION_VOCABULARY, AttestationEvidence, FabricManager, FabricState,
    PartitionDef, Tenant, enumerate_partitions, p2p_bandwidth,
)
