"""CC-aware transfer optimization: close the small alloc-and-copy gap.

PyTorch counterpart of ``repro.bridge_opt``.  Three cooperating pieces:

  * ``arena``     — StagingArena: persistent, budgeted pinned staging with
                    LRU eviction; kills the 44x fresh-staging class.
  * ``coalescer`` — CrossingCoalescer: sub-threshold crossings queue per
                    direction and flush fused (one toll for many).
  * ``restore``   — pipelined_h2d: chunked, double-buffered KV restore over
                    the SecureChannelPool; attacks the +131% restore penalty.

The subsystem depends only on ``core`` and the trace op-class vocabulary —
serving wires it in, never the other way around.
"""

from .arena import ArenaSlot, ArenaStats, StagingArena
from .coalescer import CoalescerStats, CrossingCoalescer
from .restore import PipelinedRestoreResult, pipelined_h2d

__all__ = [
    "ArenaSlot", "ArenaStats", "StagingArena",
    "CoalescerStats", "CrossingCoalescer",
    "PipelinedRestoreResult", "pipelined_h2d",
]
