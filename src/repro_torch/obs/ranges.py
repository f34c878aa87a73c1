"""Wall-clock ranges on the profiler's clock, and their host totals.

``span(name, args="")`` marks a stretch of the program's host work
(``engine/step``, ``model/attention``, ``gateway/d2h``, ...).  While
``torch.profiler`` records on the calling thread, it opens a range of
that name, so the range lies on the clock of the device's activities:
every kernel launched inside it can be put down to it through its
launch, and every idle gap of the device falls inside or outside it.
With the profiler off it costs one check and returns a shared no-op.

The range is an op-scope record function (``_RecordFunctionFast``), as
an aten op's is, not a user-scope ``record_function``: a user-scope
range is copied onto the device's timeline as an annotation, which a
reader of device operations would have to know to leave out.

While a range records, its host seconds and entries are added to
``totals()`` under the path of ranges open on its thread, outermost
first, so a reader can split a step without the profile.

The profiler's state is per thread: a thread started before the
profiler (the engine's drain worker) records no range.
"""

from __future__ import annotations

import contextlib
import threading
import time

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast


#: what ``span`` returns with the profiler off
_OFF = contextlib.nullcontext()
_local = threading.local()
_lock = threading.Lock()
#: (range path, outermost first) -> [host seconds, entries]
_totals: dict[tuple, list] = {}


class _Range:
    __slots__ = ("_fn", "_name", "_path", "_t0")

    def __init__(self, name: str, args: str):
        # a None argument list aborts the process: pass only lists
        self._fn = (_RecordFunctionFast(name, [], {"args": args}) if args
                    else _RecordFunctionFast(name))
        self._name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self._name)
        self._path = tuple(stack)
        self._fn.__enter__()
        self._t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._fn.__exit__(*exc)
        _local.stack.pop()
        with _lock:
            got = _totals.get(self._path)
            if got is None:
                _totals[self._path] = [dt, 1]
            else:
                got[0] += dt
                got[1] += 1
        return False


def span(name: str, args: str = ""):
    """A context manager: the range ``name`` (``args`` recorded beside it
    when the profiler records inputs) while the profiler records on this
    thread, else a shared no-op."""
    if not _profiler_enabled():
        return _OFF
    return _Range(name, args)


def totals() -> dict:
    """``{path: (host seconds, entries)}`` of every range recorded since
    the last ``clear_totals()``; a path is the tuple of range names open
    on the thread, outermost first, ending in the range's own."""
    with _lock:
        return {path: (s, n) for path, (s, n) in _totals.items()}


def clear_totals() -> None:
    with _lock:
        _totals.clear()
