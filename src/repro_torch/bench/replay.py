"""Bridge-tape replay benchmark: record one engine run, re-price N
counterfactuals (§5.2 method as a benchmark).

One real ASYNC_OVERLAP engine run on the TPU-v5e CC-on profile produces a
tape; every other number comes from repricing that same crossing stream —
CC off, other platforms, other scheduling disciplines, wider channel pools —
without touching the engine again.  The speedup row quantifies why this is
the substrate for policy regression: repricing is orders of magnitude
faster than re-running.

The port's counterpart of ``benchmarks/bench_replay.py``: the same rows.
The tape is the golden harness's (``trace.harness.record_golden_tape``),
served by the port's engine on ``device`` (the card unless the caller asks
for the CPU).  Its profile is the virtual clock's ``tpu-v5e`` bridge
profile, as the reference's golden harness records: every ``*_s`` row is
modelled seconds of that profile, never a time measured on a TPU or on the
card.  Only ``replay/counterfactuals_per_engine_run`` and its ``record=``
text are host wall time.

    PYTHONPATH=src python -m repro_torch.bench.replay [--device cpu]
"""

from __future__ import annotations

import time

from repro_torch.bench import bench_main
from repro_torch.core.policy import SchedulingPolicy as SP
from repro_torch.trace import ReplaySpec, TraceReplayer, check_tape
from repro_torch.trace import opclasses as oc
from repro_torch.trace.harness import record_golden_tape


def run(device=None) -> list[str]:
    t0 = time.perf_counter()
    tape = record_golden_tape(SP.ASYNC_OVERLAP, device=device)
    record_s = time.perf_counter() - t0
    lines = [
        f"replay/recorded_crossings,{tape.n_crossings():.4f},"
        f"one async cc-on engine run on {tape.meta.profile}",
        f"replay/recorded_total_s,{tape.total_recorded_s():.6f},"
        f"serialized bridge time of the recorded stream",
    ]

    replayer = TraceReplayer(tape)
    specs = [
        ("ccoff", ReplaySpec(cc_on=False)),
        ("b300_ccon", ReplaySpec(profile="b300-hgx")),
        ("h200_ccon", ReplaySpec(profile="h200")),
        ("sync_rewrite", ReplaySpec(policy=SP.SYNC_DRAIN)),
        ("worker_rewrite", ReplaySpec(policy=SP.WORKER_DRAIN)),
        ("pool8", ReplaySpec(pool_workers=8)),
        ("no_aesni", ReplaySpec(aesni=False)),
    ]
    t1 = time.perf_counter()
    results = {name: replayer.reprice(spec) for name, spec in specs}
    replay_s = time.perf_counter() - t1

    for name, res in results.items():
        lines.append(f"replay/{name}_total_s,{res.total_replayed_s:.6f},"
                     f"wall={res.wall_s:.6f}s profile={res.profile} "
                     f"cc_on={res.cc_on} policy={res.policy or 'as-recorded'}")

    # the paper's dense-decode attribution, from the tape alone: small
    # fresh-staging crossings dominate the CC-on vs CC-off gap
    ccoff = results["ccoff"]
    dom = ccoff.dominant()
    lines.append(f"replay/ccoff_gap_s,{ccoff.gap_s:.6f},"
                 f"CC tax of the recorded stream (recorded - native repricing)")
    lines.append(f"replay/ccoff_dominant_slowdown_x,{dom.per_call_slowdown:.4f},"
                 f"dominant={dom.op_class} (paper: alloc class, 44x on B300)")
    lines.append(f"replay/ccoff_dominant_is_fresh_alloc,"
                 f"{float(dom.op_class == oc.ALLOC_H2D):.4f},"
                 f"paper SS5.2: aten::_to_copy class closes the gap")
    # on the B300 profile the same stream reproduces the 44x class exactly
    b300_dom = TraceReplayer(tape).reprice(
        ReplaySpec(profile="b300-hgx", cc_on=False)).dominant()
    lines.append(f"replay/b300_dominant_slowdown_x,"
                 f"{b300_dom.per_call_slowdown:.4f},paper=44x ({b300_dom.op_class})")

    # the recovery ladder on the critical path: worker <= sync <= as-recorded
    lines.append(f"replay/sync_recovery_fraction,"
                 f"{(tape.total_recorded_s() - results['sync_rewrite'].wall_s) / max(tape.total_recorded_s() - ccoff.total_replayed_s, 1e-12):.4f},"
                 f"fraction of the CC tax the sync rewrite recovers")

    conf = check_tape(tape)
    lines.append(f"replay/conformance_pass,{float(conf.ok):.4f},"
                 f"L1-L4 over the recorded tape "
                 f"({sum(conf.checks.values())} checks, "
                 f"{len(conf.violations)} violations)")
    lines.append(f"replay/counterfactuals_per_engine_run,"
                 f"{len(specs) * record_s / max(replay_s, 1e-9):.1f},"
                 f"record={record_s:.2f}s, {len(specs)} repricings in "
                 f"{replay_s * 1e3:.1f}ms: repricing >> re-running")
    return lines


def main(argv=None) -> None:
    bench_main(argv, doc=__doc__, run=run)


if __name__ == "__main__":
    main()
