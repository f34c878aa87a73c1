"""Perfetto / chrome://tracing export — *see* the serialized bridge.

The paper's timelines (serialized channels, revoked asynchrony) are the
fastest way to understand a CC tape, and Perfetto already renders the
Chrome trace-event JSON format.  ``tape_to_trace_events`` converts any
readable BridgeTape (v1-v3) into that format:

  * one track (tid) per secure channel, plus the engine-serial path
    (channel -1) where compute records and blocking crossings live,
  * every record as a complete slice ("ph": "X") named by op class, with
    bytes/staging/tags/charged/sources in args,
  * stall attribution (stalls.py) as its own track, each gap slice named by
    cause, flow-linked ("s"/"f") to the uncharged record that covered it —
    so clicking a restore_barrier stall leads to the restore traffic the
    engine was draining,
  * optional request spans (spans.py) as instant events on a requests
    track (enqueue/admit/first-token/finish).

Timestamps are virtual-clock seconds scaled to microseconds — the trace
viewer does not care that the clock never ticked on a wall.

Open an export at https://ui.perfetto.dev ("Open trace file") or in
chrome://tracing; both accept the JSON object written by
``export_timeline``.
"""

from __future__ import annotations

import json
from typing import List, Optional

from repro_torch.trace.tape import BridgeTape

from .stalls import StallReport, attribute_stalls

#: virtual seconds -> trace microseconds
_US = 1e6

#: track (tid) layout: engine-serial path, then channels, then annotations
TID_ENGINE = 1
TID_CHANNEL_BASE = 10          # secure channel c -> tid 10 + c
TID_REQUESTS = 900
TID_STALLS = 999

_PID = 1


def _tid_for_channel(channel: int) -> int:
    return TID_ENGINE if channel < 0 else TID_CHANNEL_BASE + channel


def _thread_meta(tid: int, name: str, sort_index: int) -> List[dict]:
    return [
        {"ph": "M", "pid": _PID, "tid": tid, "name": "thread_name",
         "args": {"name": name}},
        {"ph": "M", "pid": _PID, "tid": tid, "name": "thread_sort_index",
         "args": {"sort_index": sort_index}},
    ]


def tape_to_trace_events(tape: BridgeTape, *,
                         stalls: Optional[StallReport] = None,
                         spans=None) -> List[dict]:
    """BridgeTape -> Chrome trace-event list (the ``traceEvents`` array)."""
    if stalls is None:
        stalls = attribute_stalls(tape)

    events: List[dict] = [
        {"ph": "M", "pid": _PID, "tid": 0, "name": "process_name",
         "args": {"name": (tape.meta.label or "bridge tape")
                  + f" [{tape.meta.profile}, cc_{'on' if tape.meta.cc_on else 'off'}]"}},
    ]
    events += _thread_meta(TID_ENGINE, "engine (serial path)", 0)
    for channel in sorted({r.channel for r in tape.records if r.channel >= 0}):
        events += _thread_meta(_tid_for_channel(channel),
                               f"secure channel {channel}", 1 + channel)
    events += _thread_meta(TID_STALLS, "stalls (attributed gap)", 800)

    # -- record slices ------------------------------------------------------------------
    for i, r in enumerate(tape.records):
        args = {"record": i, "nbytes": r.nbytes, "charged": r.charged,
                "kind": r.kind}
        if r.staging:
            args["staging"] = r.staging
        if r.direction:
            args["direction"] = r.direction
        if r.tags:
            args["tags"] = list(r.tags)
        sources = getattr(r, "sources", ())
        if sources:
            args["sources"] = [list(s) for s in sources]
        cat = "compute" if r.is_compute else (
            "crossing" if r.charged else "crossing_uncharged")
        events.append({"ph": "X", "pid": _PID,
                       "tid": _tid_for_channel(r.channel),
                       "ts": r.t_start * _US,
                       "dur": max(0.0, r.duration_s) * _US,
                       "name": r.op_class, "cat": cat, "args": args})

    # -- stall track + flows to the covering records ------------------------------------
    flow_id = 0
    for s in stalls.intervals:
        # idle-gap slices (note "idle"/"wait") and fresh-toll excess get a
        # stall slice; charged-crossing remainders would just duplicate the
        # channel tracks one row down, so they stay off this track
        is_gap = s.note in ("idle", "wait")
        if not is_gap and s.cause != "fresh_staging_toll":
            continue
        events.append({"ph": "X", "pid": _PID, "tid": TID_STALLS,
                       "ts": s.t_start * _US,
                       "dur": max(0.0, s.duration_s) * _US,
                       "name": s.cause, "cat": "stall",
                       "args": {"cause": s.cause, "note": s.note,
                                "record": s.record_index}})
        if s.record_index >= 0:
            r = tape.records[s.record_index]
            flow_id += 1
            events.append({"ph": "s", "pid": _PID,
                           "tid": _tid_for_channel(r.channel),
                           "ts": max(r.t_start, s.t_start) * _US,
                           "id": flow_id, "name": s.cause, "cat": "stall"})
            events.append({"ph": "f", "pid": _PID, "tid": TID_STALLS,
                           "ts": s.t_start * _US, "bp": "e",
                           "id": flow_id, "name": s.cause, "cat": "stall"})

    # -- request lifecycle instants -----------------------------------------------------
    if spans is not None:
        events += _thread_meta(TID_REQUESTS, "requests", 700)
        span_list = (spans.spans.values() if hasattr(spans, "spans")
                     else spans)
        for sp in span_list:
            for label, t in (("enqueue", sp.enqueue_t), ("admit", sp.admit_t),
                             ("first_token", sp.first_token_t),
                             ("finish", sp.finish_t)):
                if t is None:
                    continue
                events.append({"ph": "i", "pid": _PID, "tid": TID_REQUESTS,
                               "ts": t * _US, "s": "t",
                               "name": f"{sp.req_id}:{label}",
                               "cat": "request",
                               "args": {"req_id": sp.req_id,
                                        "request_class": sp.request_class}})
    return events


def export_timeline(tape: BridgeTape, path: Optional[str] = None, *,
                    stalls: Optional[StallReport] = None,
                    spans=None) -> dict:
    """Full chrome://tracing JSON object; writes it to ``path`` if given."""
    if stalls is None:
        stalls = attribute_stalls(tape)
    trace = {
        "traceEvents": tape_to_trace_events(tape, stalls=stalls, spans=spans),
        "displayTimeUnit": "ms",
        "otherData": {
            "format": tape.format,
            "label": tape.meta.label,
            "profile": tape.meta.profile,
            "cc_on": tape.meta.cc_on,
            "policy": tape.meta.policy,
            "gap_s": stalls.gap_s,
            "closure": stalls.closure,
        },
    }
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f, indent=1)
            f.write("\n")
    return trace
