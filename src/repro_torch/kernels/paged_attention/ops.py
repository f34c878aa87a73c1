"""Wrapper of the paged-attention decode kernel.

``paged_attention`` launches ``csrc/paged_attention.cu`` for tensors on the
card and runs the plain version (``ref.paged_attention_ref``) for tensors
on the CPU.  There is no fallback: a CUDA tensor the kernel does not take
raises, and so does an input that requires grad under grad mode (the
kernel has no backward).  ``paged_attention.launches`` counts kernel
launches (one per call).  Meta tensors (the dry run) run the plain
version as shape analysis under the region ``KERNEL_paged_attention``,
which also marks the launch on the card.

The kernel splits each row's pages over blocks (flash-decoding) and
merges the splits by log-sum-exp, so a row's output bits depend on where
its splits fall.  ``split_plan`` is the host's plan: the pages per split
of a page pool, from quantities fixed for the pool's lifetime (its rows
``P // pages_max``, KV, ``pages_max`` and the page size; the lengths stay
on the device), never from the number of rows a call packs.  So a row
gives the same bits whichever rows share its call (a serving engine's
packed step of any width), as the reference's decode attention does.
``pages_per_split`` is the rule, and ``split_ranges`` the pages each split
of a row covers, as the kernel computes them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import (host_counter, kernel_region, plain_on_meta,
                                 refuse_autograd)

from .ref import paged_attention_ref

#: tokens a split covers at least, so a block's set-up and merge are spread
#: over enough bytes
SPLIT_TOKENS = 64
#: blocks the grid may hold when every row the pool holds is full and in
#: the call (16 per SM of the H100's 132); beyond it splits grow.  A call
#: of fewer rows launches fewer blocks with the same splits
GRID_CAP = 16 * 132
#: query heads one block serves (the kernel's HEADS_MAX); further heads of
#: a KV head go to further head groups
HEADS_PER_BLOCK = 8
#: head dims the kernel is built for
HEAD_DIMS = (32, 64, 128, 192, 256)


def pages_per_split(rows: int, kv: int, pages_max: int, page: int) -> int:
    """Pages per split for a pool of ``rows`` rows of ``pages_max`` pages:
    ``SPLIT_TOKENS`` worth of pages, doubled while the grid of all the
    pool's rows, each full, would pass ``GRID_CAP`` blocks, at most
    ``pages_max``."""
    pps = max(1, -(-SPLIT_TOKENS // page))
    while pps < pages_max and rows * kv * -(-pages_max // pps) > GRID_CAP:
        pps *= 2
    return max(1, min(pps, pages_max))


def split_plan(k_pages: torch.Tensor, block_tables: torch.Tensor) -> int:
    """Pages per split of a call over ``k_pages`` (P, page, KV, D) through
    ``block_tables`` (B, pages_max): ``pages_per_split`` of the pool's rows,
    ``P // pages_max`` (at least 1).  B, the rows the call packs, is not
    read: every call on one pool splits each row alike."""
    pages_max = block_tables.shape[1]
    rows = max(1, k_pages.shape[0] // pages_max)
    return pages_per_split(rows, k_pages.shape[2], pages_max,
                           k_pages.shape[1])


def split_ranges(length: int, page: int, pages_max: int,
                 pps: int) -> list[tuple[int, int]]:
    """The page ranges [j0, j1) of a row's live splits: its
    min(ceil(length / page), pages_max) pages cut into runs of ``pps``."""
    n_pages = min(-(-max(length, 0) // page), pages_max)
    return [(j0, min(j0 + pps, n_pages)) for j0 in range(0, n_pages, pps)]


def _check(q, k_pages, v_pages, block_tables, lengths):
    if (q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape
            or block_tables.dim() != 2 or lengths.dim() != 1):
        raise ValueError("paged_attention: q (B,H,D), pages (P,page,KV,D), "
                         "block_tables (B,pages_max), lengths (B,)")
    b, h, d = q.shape
    if (k_pages.shape[3] != d or h % k_pages.shape[2]
            or block_tables.shape[0] != b or lengths.shape[0] != b):
        raise ValueError(f"paged_attention: mismatched q {tuple(q.shape)}, "
                         f"pages {tuple(k_pages.shape)}, block_tables "
                         f"{tuple(block_tables.shape)}, lengths "
                         f"{tuple(lengths.shape)} (H % KV must be 0)")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D); k_pages/v_pages: (P, page, KV, D); block_tables:
    (B, pages_max) int32; lengths: (B,) int32.  Returns (B, H, D)."""
    _check(q, k_pages, v_pages, block_tables, lengths)
    refuse_autograd("paged_attention", q, k_pages, v_pages)
    if q.device.type == "meta":
        return plain_on_meta("paged_attention", paged_attention_ref, q,
                             k_pages, v_pages, block_tables, lengths)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    for name, t, dtype in (("q", q, torch.bfloat16),
                           ("k_pages", k_pages, torch.bfloat16),
                           ("v_pages", v_pages, torch.bfloat16),
                           ("block_tables", block_tables, torch.int32),
                           ("lengths", lengths, torch.int32)):
        if t.device != q.device or t.dtype != dtype:
            raise ValueError(f"paged_attention: {name} must be {dtype} on "
                             f"{q.device}, got {t.dtype} on {t.device}")
        align = 16 if dtype == torch.bfloat16 else 4  # the kernel's loads
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"paged_attention: {name} must be contiguous "
                             f"and {align}-byte aligned")
    b, h, d = q.shape
    page, kv = k_pages.shape[1], k_pages.shape[2]
    pages_max = block_tables.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {d} not in {HEAD_DIMS}")
    if pages_max < 1 or b > 65535:
        raise ValueError(f"paged_attention: pages_max {pages_max} must be "
                         f">= 1 and B {b} <= 65535")
    if b == 0:
        return torch.empty_like(q)
    with kernel_region("paged_attention"):
        return _launch(q, k_pages, v_pages, block_tables, lengths)


def _launch(q, k_pages, v_pages, block_tables, lengths):
    b, h, d = q.shape
    page, kv = k_pages.shape[1], k_pages.shape[2]
    pages_max = block_tables.shape[1]
    out = torch.empty_like(q)
    pps = split_plan(k_pages, block_tables)
    splits = -(-pages_max // pps)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws = counters = None
    if splits > 1:
        rep = h // kv
        groups = -(-rep // HEADS_PER_BLOCK)
        hb = min(rep, HEADS_PER_BLOCK)
        ws = torch.empty(b * kv * groups * splits * hb * (d + 2),
                         dtype=torch.float32, device=q.device)
        counters = _tickets(q.device, stream, b * kv * groups)
    rc = _lib().paged_attention_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(),
        b, h, kv, d, page, pages_max, pps, 1.0 / math.sqrt(d), stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    paged_attention.launches += 1
    return out


host_counter(paged_attention, "launches")

#: (device index, stream) -> the split tickets of the calls on that stream:
#: zeroed when made, left at zero by every launch (the merging block resets
#: its entry), so one stream's calls share them in order and two streams
#: never share them.  Two threads racing on one stream at worst make one
#: more zeroed buffer.  A CUDA graph captured on a stream reads and writes
#: the buffer that stream had then, which its owner keeps alive for the
#: graph's life (``prepare_capture``): a wider capture on the same stream
#: later gives the stream a larger buffer, and the graph keeps its own.
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "paged_attention: no zeroed split tickets for the capturing "
                "stream; call prepare_capture before the capture")
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf


def prepare_capture(device: torch.device, stream: int):
    """Before a CUDA graph is captured on ``stream``: zero its split
    tickets, as many as any stream of ``device`` has needed (the graph's
    calls ran eagerly once before), outside the graph's memory pool, so
    the capture allocates and zeroes none.  Returns that buffer (None if
    no call has needed one), which the graph's owner keeps as long as the
    graph: the graph holds only its address."""
    n = max((buf.numel() for (index, _), buf in _TICKETS.items()
             if index == device.index), default=0)
    return _tickets(device, stream, n) if n else None


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load("paged_attention")
    fn = lib.paged_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
