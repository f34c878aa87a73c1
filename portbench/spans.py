"""The program's own ranges (``repro_torch.obs.span``) in a run.

Each range has a path: the tuple of program ranges open on its thread
when it was entered, outermost first, ending in its own name
(``("engine/step", "engine/decode", "model/decode_step",
"model/attention")``).  Two sources give the same record, ``{path:
[host seconds, entries, device seconds]}``:

- ``program_totals()``: the host totals the program keeps while the
  profiler records (``obs.totals()``), so the whole profiled slice; the
  device seconds are None.  None where the program keeps none (a port
  without the ranges).
- ``read(events)``: the profiled slice itself, as ``events_of(prof)``
  gives it.  Each device operation (kernel, copy, set) is put down to the
  path open on the host when it was launched: its launch's correlation id
  names the innermost host record open at the launch (an aten op, or a
  program range where no op encloses the launch, as for a kernel launched
  through ``ctypes``), and that record's thread and start give the
  ranges around it.

``idle(events)`` reads the device's idle gaps against the same ranges.

The readers of ``metrics/`` take the first source today.  Reading the
slice needs ``trace.read_profile`` to pass ``events_of(prof)`` through
into the run's records.
"""

from __future__ import annotations

import bisect
import re
import sys

from .stats import merged

#: the first path component of every program range
PREFIXES = ("engine/", "gateway/", "model/", "kernel/", "train/")
#: the CUDA API calls the profiler records on the host
#: (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...):
#: their correlation ids are the runtime's, not the host records'
RUNTIME = re.compile(r"cu(da)?[A-Z]")


def program_totals():
    """``{path: [host s, entries, None]}`` from the program's own totals;
    None where the program keeps none."""
    mod = sys.modules.get("repro_torch.obs.ranges")
    totals = getattr(mod, "totals", None)
    if totals is None:
        return None
    return {path: [s, n, None] for path, (s, n) in totals().items()}


def moe_decode_slots():
    """(routed assignments, expert slots computed) over the run's decode
    calls of a MoE layer on one device; None where the program counts
    none."""
    mod = sys.modules.get("repro_torch.models.layers")
    block = getattr(mod, "moe_block", None)
    if block is None or not hasattr(block, "decode_slots"):
        return None
    return block.decode_assignments, block.decode_slots


# -- one record from the profiled slice -------------------------------------

def events_of(prof) -> list[dict]:
    """A finished ``torch.profiler.profile``'s events, each a dict of
    ``kind`` ("range": a host record, "launch": a runtime call, "device":
    an operation on the device, "annotation": a range's copy on the
    device's timeline), ``name``, ``start`` / ``end`` (microseconds, one
    clock), ``thread``, ``corr`` (a host record's correlation id) and
    ``link`` (a device operation's: the host record open at its launch, 0
    if none)."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            kind = "annotation" if e.is_user_annotation() else "device"
        elif RUNTIME.match(e.name()):
            kind = "launch"
        else:
            kind = "range"
        start = e.start_ns() / 1e3
        out.append(dict(kind=kind, name=e.name(), start=start,
                        end=start + e.duration_ns() / 1e3,
                        thread=e.start_thread_id(),
                        corr=e.correlation_id(),
                        link=e.linked_correlation_id()))
    return out


def _stacks(events):
    """Per thread, the program ranges sorted by start, each (start, end,
    path), and each host record's (thread, start) by correlation id."""
    by_thread: dict = {}
    where = {}
    for e in events:
        if e["kind"] != "range":
            continue
        where[e["corr"]] = (e["thread"], e["start"])
        if e["name"].startswith(PREFIXES):
            by_thread.setdefault(e["thread"], []).append(e)
    paths = {}
    for thread, ranges in by_thread.items():
        ranges.sort(key=lambda e: (e["start"], -e["end"]))
        open_: list = []
        out = []
        for e in ranges:
            while open_ and open_[-1]["end"] <= e["start"]:
                open_.pop()
            open_.append(e)
            out.append((e["start"], e["end"],
                        tuple(r["name"] for r in open_)))
        paths[thread] = out
    return paths, where


def _path_at(ranges, t: float) -> tuple:
    """The innermost path open at ``t`` among one thread's ranges (sorted
    by start, nested): the last to start before ``t`` that has not ended."""
    i = bisect.bisect_right(ranges, (t, float("inf"), ()))
    while i:
        i -= 1
        a, b, path = ranges[i]
        if b >= t:
            return path
    return ()


def read(events) -> dict:
    """``{path: [host s, entries, device s]}`` of a profiled slice; the
    device seconds no program range launched are under the path ``()``."""
    paths, where = _stacks(events)
    out: dict = {}
    for thread, ranges in paths.items():
        for a, b, path in ranges:
            rec = out.setdefault(path, [0.0, 0, 0.0])
            rec[0] += (b - a) * 1e-6
            rec[1] += 1
    for e in events:
        if e["kind"] != "device":
            continue
        launch = where.get(e["link"])
        path = (_path_at(paths.get(launch[0], ()), launch[1])
                if launch is not None else ())
        rec = out.setdefault(path, [0.0, 0, 0.0])
        rec[2] += (e["end"] - e["start"]) * 1e-6
    return out


def busy(events) -> list:
    """The device's busy intervals, merged: its operations only, never a
    range's annotation."""
    return merged([(e["start"], e["end"]) for e in events
                   if e["kind"] == "device"])


def idle(events) -> dict:
    """Idle seconds of the device between its first and last operation,
    by the innermost program range open on the host at each gap's middle
    (``""`` where none is)."""
    paths, _ = _stacks(events)
    spans = busy(events)
    out: dict = {}
    for (_, a), (b, _) in zip(spans, spans[1:]):
        t = (a + b) / 2
        inner = max((_path_at(r, t) for r in paths.values()), key=len,
                    default=())
        name = inner[-1] if inner else ""
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return out


def idle_inside(events, name: str) -> float:
    """Seconds the device sat idle while the host was inside a range
    ``name``, between the device's first and last operation."""
    spans = busy(events)
    gaps = [(a, b) for (_, a), (b, _) in zip(spans, spans[1:])]
    inside = merged([(e["start"], e["end"]) for e in events
                     if e["kind"] == "range" and e["name"] == name])
    total = 0.0
    for a, b in gaps:
        for lo, hi in inside:
            total += max(0.0, min(b, hi) - max(a, lo))
    return total * 1e-6


# -- what the readers take from a record ------------------------------------

def seconds(rec: dict, name: str, under: str = "", column: int = 0):
    """The sum of column ``column`` (0 host seconds, 1 entries, 2 device
    seconds) over the paths that end in ``name`` and pass ``under``."""
    return sum(v[column] for path, v in rec.items()
               if path and path[-1] == name
               and (not under or under in path[:-1]))


def entries(rec: dict, name: str, under: str = "") -> int:
    return seconds(rec, name, under, column=1)
