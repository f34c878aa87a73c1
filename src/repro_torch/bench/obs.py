"""The observatory on the port: offered-load percentile curves, held against
``BENCH_obs.json``, and what watching costs.

    PYTHONPATH=src python -m repro_torch.bench.obs --check [PATH] [--device cpu]

The port's counterpart of ``benchmarks/bench_obs.py``.  A closed-loop run
of the smoke model (``trace.harness.smoke_model``) calibrates the
workload's capacity (requests/s at full batch on the virtual clock); open-
loop runs then offer 0.5x, 1x and 2x that rate with deterministic arrivals
and read p50/p99 TTFT and TPOT out of the observatory's request spans.
Those are virtual-clock quantities: the drift payload.  Without ``--check``
the rows are printed with the obs-on / obs-off host wall-time ratio of the
2x run (interleaved min-of-3, beside the reference's 1.10 bound), which is
host wall time and no part of the drift file.
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.bench import close, diff_rows, drift_main, load
from repro_torch.core.bridge import B300, BridgeModel
from repro_torch.core.policy import cc_aware_defaults

#: the fixed curve workload
N_REQUESTS = 12
MAX_NEW_TOKENS = 8
MAX_BATCH = 4
PROMPT = (1, 2, 3)

#: offered load as multiples of the calibrated closed-loop capacity:
#: under (queueing negligible), at, and over (queue growth dominates TTFT)
LOAD_MULTIPLES = (0.5, 1.0, 2.0)

#: the reference's bound on the obs-on / obs-off wall-time ratio
OVERHEAD_LIMIT = 1.10


def _make_engine(model, *, observability: bool):
    from repro_torch.serving.engine import ServingEngine
    defaults = dataclasses.replace(
        cc_aware_defaults(True, concurrency=MAX_BATCH),
        observability=observability)
    engine = ServingEngine(
        model, max_batch=MAX_BATCH, max_len=64, policy=defaults.scheduling,
        bridge=BridgeModel(B300, cc_on=True), defaults=defaults, seed=0,
        device=model.device)
    engine.gateway.pool.prewarm()
    return engine


def _request(i: int):
    from repro_torch.serving.engine import Request
    from repro_torch.serving.sampler import SamplingParams
    return Request(f"r{i}", prompt=list(PROMPT),
                   sampling=SamplingParams(max_new_tokens=MAX_NEW_TOKENS))


def calibrate_capacity_rps(model) -> float:
    """Closed-loop service rate: every request queued up front, drained at
    full batch; requests/s on the virtual clock."""
    engine = _make_engine(model, observability=True)
    try:
        for i in range(N_REQUESTS):
            engine.submit(_request(i))
        engine.run()
        makespan = engine.clock.now
    finally:
        engine.close()
    return N_REQUESTS / max(makespan, 1e-12)


def run_open_loop(model, rate_rps: float, *, observability: bool) -> dict:
    """Deterministic arrivals at ``rate_rps``: the engine steps while it has
    work and the virtual clock jumps to the next arrival when idle.  Span
    enqueue times are re-stamped to the arrival, so TTFT includes the
    open-loop queueing delay."""
    engine = _make_engine(model, observability=observability)
    try:
        arrivals = [i / rate_rps for i in range(N_REQUESTS)]
        next_i = 0
        while next_i < len(arrivals) or engine.queue or engine.active:
            while (next_i < len(arrivals)
                   and engine.clock.now >= arrivals[next_i] - 1e-12):
                req = _request(next_i)
                engine.submit(req)
                req.enqueue_t = arrivals[next_i]
                if engine.obs is not None:
                    engine.obs.spans.on_enqueue(req.request_id,
                                                arrivals[next_i])
                next_i += 1
            if not engine.queue and not engine.active:
                engine.clock.advance_to(arrivals[next_i])
                continue
            engine.step()
        out = {"finished": len(engine.finished),
               "makespan_s": engine.clock.now}
        if engine.obs is not None:
            reg = engine.obs.registry
            for fam, key in (("req/ttft_s", "ttft"), ("req/tpot_s", "tpot")):
                for p in (50.0, 99.0):
                    out[f"{key}_p{int(p)}_s"] = reg.family_percentile(
                        fam, p, default=0.0)
            out["queue_wait_p99_s"] = reg.family_percentile(
                "req/queue_wait_s", 99.0, default=0.0)
        return out
    finally:
        engine.close()


def offered_load_curves(model) -> dict:
    """The drift payload: capacity and one curve point per load multiple."""
    capacity = calibrate_capacity_rps(model)
    curves = []
    for mult in LOAD_MULTIPLES:
        rate = mult * capacity
        point = run_open_loop(model, rate, observability=True)
        curves.append({"multiple": mult, "offered_rps": rate,
                       **{k: point[k] for k in (
                           "finished", "makespan_s", "ttft_p50_s",
                           "ttft_p99_s", "tpot_p50_s", "tpot_p99_s",
                           "queue_wait_p99_s")}})
    return {"capacity_rps": capacity, "curves": curves}


def measure_overhead_ratio(model, rate_rps: float, *,
                           rounds: int = 3) -> float:
    """Host wall time of the same open-loop run, obs-on over obs-off,
    interleaved min-of-``rounds`` after one warm-up of each."""
    def wall(observability: bool) -> float:
        t0 = time.perf_counter()
        run_open_loop(model, rate_rps, observability=observability)
        return time.perf_counter() - t0

    wall(False), wall(True)
    ons, offs = [], []
    for _ in range(rounds):
        offs.append(wall(False))
        ons.append(wall(True))
    return min(ons) / max(min(offs), 1e-9)


def _smoke(device):
    from repro_torch.trace.harness import smoke_model
    return smoke_model(device=device)


def check_drift(path: str, device) -> list[str]:
    """Recompute the curves on ``device`` and list what differs from
    ``path``."""
    golden, fresh = load(path), offered_load_curves(_smoke(device))
    problems = []
    if not close(fresh["capacity_rps"], golden.get("capacity_rps", -1.0)):
        problems.append(f"capacity_rps {golden.get('capacity_rps')!r} -> "
                        f"{fresh['capacity_rps']!r}")
    diff_rows("load", golden.get("curves", []), fresh["curves"],
              ("multiple",), problems)
    return problems


def rows(device) -> list[str]:
    model = _smoke(device)
    payload = offered_load_curves(model)
    lines = [f"obs/capacity_rps,{payload['capacity_rps']:.6f},closed-loop "
             f"service rate (virtual clock), {N_REQUESTS} reqs x "
             f"{MAX_NEW_TOKENS} tokens at batch {MAX_BATCH}"]
    for c in payload["curves"]:
        tag = f"load{c['multiple']:g}x"
        lines += [
            f"obs/{tag}_ttft_p50_s,{c['ttft_p50_s']:.6f},offered "
            f"{c['offered_rps']:.3f} req/s (p99={c['ttft_p99_s']:.6f}s)",
            f"obs/{tag}_ttft_p99_s,{c['ttft_p99_s']:.6f},"
            f"queue_wait_p99={c['queue_wait_p99_s']:.6f}s",
            f"obs/{tag}_tpot_p50_s,{c['tpot_p50_s']:.6f},"
            f"p99={c['tpot_p99_s']:.6f}s"]
    ratio = measure_overhead_ratio(
        model, payload["capacity_rps"] * LOAD_MULTIPLES[-1])
    lines.append(f"obs/overhead_ratio,{ratio:.4f},obs-on / obs-off host wall "
                 f"time on {device}, interleaved min-of-3 (reference bound "
                 f"{OVERHEAD_LIMIT}x; wall-clock, not in the drift file)")
    return lines


def main(argv=None) -> None:
    drift_main(argv, filename="BENCH_obs.json", doc=__doc__,
               check_drift=check_drift, rows=rows)


if __name__ == "__main__":
    main()
