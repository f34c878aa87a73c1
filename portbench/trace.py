"""Spans the benchmark puts around the program, and the reading of a
profiled slice of the window.

``ModelProxy`` stands in the engine's ``model`` in a traced run: it wraps
``Model.prefill`` and ``Model.decode_step`` in ``record_function`` ranges
and logs each call's host time and shape (a prefill's prompt length, a
decode step's stepping rows' key counts).  The harness adds
``portbench.step`` around ``ServingEngine.step()`` and
``portbench.client`` around the clients' work.  ``read_profile`` turns a
``torch.profiler`` slice into device busy time, kernel time by name, the
device time of each model call and the device's idle gaps labelled by
what the host was doing.
"""

from __future__ import annotations

import time

from torch.profiler import record_function

from .stats import merged, union_length

STEP = "portbench.step"
CLIENT = "portbench.client"
PREFILL = "portbench.prefill"
DECODE = "portbench.decode_step"
#: kernel name fragments of the port's two attention kernels
PAGED_KERNEL = "paged_split_kernel"
FLASH_KERNEL = "flash_fwd_kernel"


class ModelProxy:
    """The engine's model, with each serving call ranged and logged in
    ``calls``: dicts of kind, host seconds, shape and whether the profiler
    was on (``profiling``, set by the harness)."""

    def __init__(self, model, engine):
        self._model, self._engine = model, engine
        self.calls: list[dict] = []
        self.profiling = False

    def __getattr__(self, name):
        return getattr(self._model, name)

    def prefill(self, tokens, max_len, **kw):
        with record_function(PREFILL):
            t0 = time.perf_counter()
            out = self._model.prefill(tokens, max_len, **kw)
            dt = time.perf_counter() - t0
        self.calls.append(dict(kind="prefill", host_s=dt,
                               prompt=int(tokens.shape[1]),
                               profiled=self.profiling))
        return out

    def decode_step(self, caches, tokens, index, slots=None, max_len=0):
        lengths = [r.index + 1 for r in self._engine.active.values()]
        with record_function(DECODE):
            t0 = time.perf_counter()
            out = self._model.decode_step(caches, tokens, index, slots,
                                          max_len)
            dt = time.perf_counter() - t0
        self.calls.append(dict(kind="decode", host_s=dt, lengths=lengths,
                               profiled=self.profiling))
        return out


def _device_time(e) -> float:
    if hasattr(e, "device_time_total"):
        return e.device_time_total
    return e.cuda_time_total


def read_profile(prof, window_s: float) -> dict:
    """What a profiled slice of ``window_s`` seconds shows, in seconds:
    ``busy_s`` (the union of device operations), ``ops`` (device time by
    name), ``paged_s`` / ``flash_s`` (each launch of the two kernels),
    ``decode_s`` (device time of each decode call), and ``gaps`` (idle
    seconds by what the host was doing)."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    # the device timeline also carries the benchmark's ranges as
    # annotations: those are no operations
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith("portbench.")]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    ops: dict[str, float] = {}
    for e in dev:
        ops[e.name] = ops.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-6
    ranges = [(e.time_range.start, e.time_range.end, e.name) for e in host
              if e.name in (STEP, CLIENT, PREFILL, DECODE)]
    gaps: dict[str, float] = {}
    busy = merged(spans)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        label = _host_label(ranges, (a + b) / 2)
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    return dict(
        window_s=window_s, busy_s=union_length(spans) * 1e-6, ops=ops,
        paged_s=[e.time_range.elapsed_us() * 1e-6 for e in dev
                 if PAGED_KERNEL in e.name],
        flash_s=[e.time_range.elapsed_us() * 1e-6 for e in dev
                 if FLASH_KERNEL in e.name],
        decode_s=[_device_time(e) * 1e-6 for e in host if e.name == DECODE],
        gaps=gaps)


def _host_label(ranges, t: float) -> str:
    """What the host was doing at ``t``: the innermost benchmark range."""
    inside = {name for a, b, name in ranges if a <= t <= b}
    if DECODE in inside:
        return "host in Model.decode_step"
    if PREFILL in inside:
        return "host in Model.prefill"
    if STEP in inside:
        return "host in ServingEngine.step outside the model"
    if CLIENT in inside:
        return "host in the clients"
    return "host in the harness"


def breakdown(profile: dict) -> dict:
    """The ledger's ``breakdown``: the 10 device operations that took most
    time and the 10 largest idle totals by host activity, in seconds."""
    top = sorted(profile["ops"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(profile["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}
