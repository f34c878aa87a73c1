"""Decode calls recorded once as a CUDA graph and replayed.

``Model.decode_step`` on the card records one call of the functional
``decode_step`` as a ``torch.cuda.CUDAGraph`` and replays it for every
later call with the same key: the shapes and dtypes of its tokens, index
and slots, ``max_len``, and the storage of its caches (each leaf's data
pointer, shape, strides and dtype).  A replay launches every kernel of the
call at once, so the host no longer sits between each pair of them.  The
call's tokens, index and slots are copied into the graph's own buffers on
the device, and its logits come back as a copy of the graph's, so no
caller holds a buffer that the next replay overwrites.  The caches are
written in place, as an eager call writes them, and returned.

The first call with a key runs eagerly: whatever its kernels make at first
use is made outside any graph (libraries, the paged kernel's split
tickets, the rotary frequencies).  The second is captured on a side stream
(``capture``, in thread-local mode: another thread's copies cannot break
it) and replayed, the later ones are replayed.  A key goes when its caches
are freed (weak references to their leaves, checked at each call); a model
serving several engines (a cluster's replicas) keeps a graph for each.

A call stays eager where a graph could not replay it as it runs: off the
card or on DTensors (parameters or inputs), while a tool holds the model's
graphs off (``DecodeGraphs.eager``), while a cost counter listens
(it counts the ops as they run), under a sharding resolver or an
expert-parallel mesh (their collectives), and inside another capture.
Every family's decode call is one a capture can hold: it reads nothing
from the host and synchronises nothing once its first call has made its
constants (the rotary frequencies, GELU's two constants).

No Python runs in a replay: the program's host counters
(``kernels.HOST_COUNTERS``: kernel launches, the MoE layer's decode
assignments and slots) advance by what the captured call added to them,
once per replay, and the program's ranges inside ``model/decode_step`` do
not open (the replay runs inside that range).

``PrefillGraphs`` does the same for ``Model.prefill`` where the config
asks for it (``prefill_graphs``, the prompt shapes kept): a prompt shape's
first call runs eagerly, its second is captured and replayed, the later
ones replayed; the least recently used graph goes when a new shape would
pass that number.  A prefill reads no cache, so its key is the prompt's
shape and ``max_len``; what a replay returns (logits and the one-row
cache) are copies of the graph's.
"""

from __future__ import annotations

import collections
import contextlib
import sys
import weakref
from typing import Callable

import torch

from repro_torch.kernels import HOST_COUNTERS
from repro_torch.obs import span
from repro_torch.training.optimizer import leaves, tree_map

#: the side stream each device captures on
_STREAMS: dict = {}


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor; without importing their module (seconds
    on one core), which any DTensor has loaded."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and not is_dtensor(t)


def _capturing() -> bool:
    return torch.cuda.is_current_stream_capturing()


def graphable(tokens: torch.Tensor) -> bool:
    """Whether a call on ``tokens`` may replay: on the card, a plain
    tensor, no cost counter listening, no resolver or expert-parallel mesh
    installed, and no capture open."""
    from repro_torch.kernels import _LISTENERS

    from .layers import _ACTIVATION_RULES, _MOE_CONTEXT
    return (_on_card(tokens) and not _LISTENERS
            and _ACTIVATION_RULES["resolver"] is None
            and _MOE_CONTEXT["mesh"] is None and not _capturing())


def capture(call: Callable[[], torch.Tensor], device: torch.device):
    """``call()`` recorded as a CUDA graph on ``device``'s capture stream,
    after that stream's split tickets are zeroed.  Returns the graph, whose
    ``replay()`` runs it on the current stream, the tensor ``call()``
    returned, which each replay rewrites, and the split tickets the graph
    reads and writes (or None), which must live as long as it: a later,
    wider capture gives the stream a larger buffer."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    stream = _STREAMS.get(device.index)
    if stream is None:
        stream = _STREAMS[device.index] = torch.cuda.Stream(device=device)
    tickets = pa_ops.prepare_capture(device, stream.cuda_stream)
    graph = torch.cuda.CUDAGraph()
    # capture_begin itself, not torch.cuda.graph, which also synchronises
    # the device and empties the allocator's cache, so every cached block
    # would be freed and allocated again
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = call()
        finally:
            graph.capture_end()
    return graph, out, tickets


def _shape(t) -> tuple:
    return None if t is None else (tuple(t.shape), t.dtype, t.device)


class _Entry:
    """One key: weak references to its caches' leaves, and once captured
    the graph, its input buffers (tokens, index, slots or None), its
    logits, its split tickets and the host counters' steps per replay, as
    (owner, attribute, step)."""

    def __init__(self, tensors: list):
        self.refs = [weakref.ref(t) for t in tensors]
        self.graph = None
        self.inputs = self.logits = self.tickets = self.steps = None

    def alive(self) -> bool:
        return all(r() is not None for r in self.refs)


class DecodeGraphs:
    """A model's decode calls, each run eagerly, captured or replayed.
    ``run(caches, tokens, index, slots, max_len)`` is the eager call;
    ``on`` False keeps every call eager (the parameters are DTensors, or a
    tool holds the graphs off: ``eager``)."""

    def __init__(self, run: Callable, on: bool):
        self._run, self.on = run, on
        self._entries: dict = {}

    @contextlib.contextmanager
    def eager(self):
        """Every call inside runs eagerly, for a tool that patches or counts
        the functions a decode call runs (a replay runs none of them)."""
        on, self.on = self.on, False
        try:
            yield
        finally:
            self.on = on

    def __call__(self, caches, tokens, index, slots, max_len: int):
        """Returns (logits, caches, how the call ran: "eager", "captured"
        or "replayed")."""
        if not (self.on and graphable(tokens)):
            return (*self._run(caches, tokens, index, slots, max_len),
                    "eager")
        for key in [k for k, e in self._entries.items() if not e.alive()]:
            del self._entries[key]
        cache_leaves = leaves(caches)
        key = (_shape(tokens), _shape(index), _shape(slots), max_len,
               tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                     for t in cache_leaves))
        entry = self._entries.get(key)
        if entry is None:
            self._entries[key] = _Entry(cache_leaves)
            return (*self._run(caches, tokens, index, slots, max_len),
                    "eager")
        how = "replayed"
        if entry.graph is None:
            self._capture(entry, caches, tokens, index, slots, max_len)
            how = "captured"
        with span("model/decode_step"):
            for buf, t in zip(entry.inputs, (tokens, index, slots)):
                if buf is not None:
                    buf.copy_(t)
            entry.graph.replay()
            _advance(entry.steps)
            return entry.logits.clone(), caches, how

    def _capture(self, entry: _Entry, caches, tokens, index, slots,
                 max_len: int) -> None:
        inputs = [None if t is None else t.clone() for t in
                  (tokens, index, slots)]
        (entry.graph, entry.logits, entry.tickets), entry.steps = _counted(
            lambda: capture(lambda: self._run(caches, *inputs, max_len)[0],
                            tokens.device))
        entry.inputs = inputs


def _counted(record: Callable):
    """``record()`` (a capture) with the host counters put back as they
    were before it, and the steps it moved them by, as (owner, attribute,
    step): what each replay adds."""
    held = list(HOST_COUNTERS)
    before = [getattr(owner, name) for owner, name in held]
    try:
        got = record()
    finally:
        after = [getattr(owner, name) for owner, name in held]
        for (owner, name), value in zip(held, before):
            setattr(owner, name, value)
    return got, [(owner, name, a - b) for (owner, name), a, b
                 in zip(held, after, before) if a != b]


def _advance(steps: list) -> None:
    for owner, name, step in steps:
        setattr(owner, name, getattr(owner, name) + step)


class _Prefill:
    """One captured prompt shape: the graph, its prompt buffer, what it
    returns (logits, cache), the prompt's length as the call returned it,
    its split tickets and the host counters' steps per replay."""

    def __init__(self, graph, tokens, out, total, tickets, steps):
        self.graph, self.tokens, self.out = graph, tokens, out
        self.total, self.tickets, self.steps = total, tickets, steps


class PrefillGraphs:
    """A model's prefill calls, each run eagerly, captured or replayed.
    ``run(tokens, max_len)`` is the eager call, returning (logits, cache,
    next index); at most ``keep`` prompt shapes hold a graph (0: every
    call eager); ``on`` False keeps every call eager."""

    def __init__(self, run: Callable, on: bool, keep: int):
        self._run, self.on, self.keep = run, on, keep
        self._seen: set = set()
        self._graphs: collections.OrderedDict = collections.OrderedDict()

    def __call__(self, tokens, max_len: int):
        """Returns (logits, cache, next index, how the call ran: "eager",
        "captured" or "replayed")."""
        if not (self.on and self.keep and graphable(tokens)):
            return (*self._run(tokens, max_len), "eager")
        key = (_shape(tokens), max_len)
        entry = self._graphs.get(key)
        if entry is None and key not in self._seen:
            self._seen.add(key)
            return (*self._run(tokens, max_len), "eager")
        how = "replayed"
        if entry is None:
            while len(self._graphs) >= self.keep:
                self._graphs.popitem(last=False)
            entry = self._graphs[key] = self._capture(tokens, max_len)
            how = "captured"
        self._graphs.move_to_end(key)
        with span("model/prefill"):
            entry.tokens.copy_(tokens)
            entry.graph.replay()
            _advance(entry.steps)
            logits, cache = entry.out
            return (logits.clone(), tree_map(torch.clone, cache),
                    entry.total, how)

    def _capture(self, tokens, max_len: int) -> _Prefill:
        buf, got = tokens.clone(), {}

        def call():
            logits, cache, got["total"] = self._run(buf, max_len)
            return logits, cache
        (graph, out, tickets), steps = _counted(
            lambda: capture(call, tokens.device))
        return _Prefill(graph, buf, out, got["total"], tickets, steps)
