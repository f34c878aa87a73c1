"""Pipelined chunked KV restore — overlap the secure channel (PipeLLM shape).

The paper's +131% KV-restore penalty comes from restoring a whole prefix as
one blocking drain on the serialized channel: every decode step queued
behind it.  The recovery shape (PipeLLM, ASPLOS 2025) is to pipeline the
secure channel instead of paying it serially: split the prefix into
channel-sized chunks, double-buffer them across the SecureChannelPool's
contexts, and block the caller only for the *pipeline fill* (the first
chunk).  The remaining chunks drain in the background of subsequent decode
steps — they still serialize on their own secure channels (bridge law L1
holds per channel; nothing is free), but the engine's critical path no
longer waits for them.

On the tape, chunks are recorded uncharged (`charged=False`, like bulk
pooled transfers) with their secure-channel placement, under the
`kv_restore_pipelined` op class — so replay attribution can quantify how
much restore time left the critical path.

PyTorch counterpart of ``repro.bridge_opt.restore``: the payloads are
uploaded for real and returned on the gateway's device, where the offload
layer widens quantized blocks (``kernels/dequant``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from repro_torch.core.bridge import Crossing, Direction, StagingKind
from repro_torch.core.gateway import _to_device
from repro_torch.trace import opclasses as oc

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.gateway import TransferGateway


@dataclass(frozen=True)
class PipelinedRestoreResult:
    n_chunks: int
    total_bytes: int
    #: critical-path time the caller was charged (the pipeline fill)
    fill_s: float
    #: virtual time at which the last chunk lands (channels busy until then)
    done_t: float
    #: restore time moved off the critical path vs a blocking drain
    overlap_s: float


def pipelined_h2d(gateway: "TransferGateway", payloads: Sequence[np.ndarray], *,
                  chunk_bytes: int,
                  op_class: str = oc.KV_RESTORE_PIPELINED,
                  tags: tuple = (),
                  raw_total: int = 0,
                  codec: str = "",
                  ) -> tuple[list[torch.Tensor], PipelinedRestoreResult]:
    """Move `payloads` host->device as chunked, double-buffered pool traffic.

    The caller's clock advances only to the completion of the first chunk;
    later chunks overlap whatever the caller does next.  Chunk staging is
    REGISTERED by construction — the restore path owns a persistent pair of
    double buffers it cycles through.

    Quantized restores (DESIGN.md §13) pass ``raw_total``/``codec``: the
    payloads already hold *wire* bytes, and each chunk's record carries its
    proportional share of the full-width total so the un-quantize replay can
    reprice the stream chunk by chunk.

    Returns the payloads on the gateway's device, in order, and the result.
    """
    if chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes must be positive, got {chunk_bytes}")
    total = sum(int(np.asarray(p).nbytes) for p in payloads)
    t0 = gateway.clock.now
    if total == 0:
        return [_to_device(np.asarray(p), gateway.device) for p in payloads], \
            PipelinedRestoreResult(0, 0, 0.0, t0, 0.0)

    gateway.pool.ensure_ready()
    n_chunks = max(1, math.ceil(total / chunk_bytes))
    sizes = [chunk_bytes] * (n_chunks - 1)
    sizes.append(total - chunk_bytes * (n_chunks - 1))

    first_done = None
    last_done = t0
    raw_left = max(0, int(raw_total))
    wire_left = total
    for size in sizes:
        # proportional raw share, remainder-exact: the last chunk absorbs
        # rounding so per-chunk raw sums to raw_total
        raw_chunk = (raw_left * size) // wire_left if raw_left else 0
        if size == wire_left:
            raw_chunk = raw_left
        raw_left -= raw_chunk
        wire_left -= size
        crossing = Crossing(size, Direction.H2D, StagingKind.REGISTERED)
        _, _, done = gateway.pooled_crossing(crossing, op_class=op_class,
                                             tags=tags, raw_bytes=raw_chunk,
                                             codec=codec if raw_chunk else "")
        if first_done is None:
            first_done = done
        last_done = max(last_done, done)

    # block only for the pipeline fill; the rest overlaps subsequent work
    gateway.clock.advance_to(first_done)
    fill = gateway.clock.now - t0
    gateway.stats.bridge_time_s += fill
    arrays = [_to_device(np.asarray(p), gateway.device) for p in payloads]
    return arrays, PipelinedRestoreResult(
        n_chunks=n_chunks, total_bytes=total, fill_s=fill, done_t=last_done,
        overlap_s=max(0.0, last_done - first_done))
