"""Bridge-tape subsystem: record, replay and verify crossing traces.

The paper's method is accounting over a crossing trace (§5); this package
makes that trace a first-class, versioned artifact:

  * ``tape``        — BridgeTape, the JSON-serializable crossing stream
  * ``recorder``    — TraceRecorder, captures a TransferGateway's stream
  * ``replay``      — TraceReplayer, counterfactual repricing + §5.2 tables
  * ``conformance`` — bridge-law (L1-L4) invariant checker
  * ``opclasses``   — the canonical op-class vocabulary call sites tag with
  * ``harness``     — engine-run recording helpers (import explicitly; not
                      re-exported so the trace core stays serving-free)
"""

from . import opclasses
from .conformance import (ConformanceError, ConformanceReport, Violation,
                          assert_conformant, check_tape)
from .recorder import TraceRecorder, record_gateway
from .replay import (ReplayResult, ReplaySpec, RewrittenCrossing,
                     TraceReplayer, rewrite_for_policy)
from .tape import (TAPE_FORMAT, BridgeTape, TapeFormatError, TapeMeta,
                   TapeRecord)

__all__ = [
    "opclasses",
    "TAPE_FORMAT", "BridgeTape", "TapeFormatError", "TapeMeta", "TapeRecord",
    "TraceRecorder", "record_gateway",
    "ReplayResult", "ReplaySpec", "RewrittenCrossing", "TraceReplayer",
    "rewrite_for_policy",
    "ConformanceError", "ConformanceReport", "Violation", "assert_conformant",
    "check_tape",
]
