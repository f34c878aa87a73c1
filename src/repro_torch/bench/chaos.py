"""Chaos on the port: goodput / TTFT p99 / MTTR against the fault rate, and
the degradation ladder's ablation, held against ``BENCH_chaos.json``.

    PYTHONPATH=src python -m repro_torch.bench.chaos --check [PATH] [--device cpu]

The port's counterpart of ``benchmarks/bench_chaos.py``, on the same
workload: a two-replica cluster (``repro_torch.cluster``) serving a
shared-prefix workload in waves, so the later waves restore the prefix warm
over the faulted channel.  Two payloads:

1. **Fault-rate sweep.**  ``FaultPlan.transient(rate)`` at each swept rate:
   goodput (tokens per virtual second of makespan), TTFT p99 and MTTR (mean
   recovery seconds per injected fault event).  The chaos invariant is
   asserted at every point: token streams identical to the fault-free
   run's, zero requests lost.
2. **Ladder ablation.**  At the highest swept rate, with MAC rejects and
   restore corruption only, the degradation ladder on against off; the
   two arms must give identical tokens.

The smoke olmo-1b (weights from seed 0) runs for real on ``--device``; the
rows are virtual-clock quantities, so they do not depend on the device.
"""

from __future__ import annotations

import numpy as np

from repro_torch.bench import diff_rows, drift_main, load

#: swept per-crossing transient fault rates (0 = the identity baseline)
RATES = (0.0, 0.05, 0.15, 0.3)
SEED = 11
N_REPLICAS = 2
WAVES = 3
WAVE_SIZE = 6
MAX_NEW_TOKENS = 6
#: shared prefix: 4 full blocks at block_tokens=8, the warm-restore unit
PREFIX = list(range(1, 33))


def _cfg():
    from repro_torch.cluster import ReplicaConfig
    # coalescing on, so the fused-ciphertext fault semantics (and the
    # bypass rung) are live; uniform output lengths keep the dense-step
    # rung shape-neutral
    return ReplicaConfig(max_batch=2, max_len=64,
                         coalesce_small_crossings=True)


def run_cluster(model, plan, *, ladder_enabled: bool = True) -> dict:
    """One cluster run of the wave workload; returns tokens + metrics."""
    from repro_torch.cluster import build_cluster
    from repro_torch.resilience import DegradationLadder
    from repro_torch.serving.engine import Request
    from repro_torch.serving.sampler import SamplingParams
    cluster = build_cluster(model, n_replicas=N_REPLICAS, fault_plan=plan,
                            replica_cfg=_cfg(), seed=0)
    try:
        if not ladder_enabled:
            for r in cluster.replicas:
                if r.faults is not None:
                    r.faults.ladder = DegradationLadder(enabled=False)
        submitted = 0
        for wave in range(WAVES):
            for i in range(WAVE_SIZE):
                rid = f"w{wave}r{i}"
                ok = cluster.submit(Request(
                    rid, prompt=PREFIX + [100 + wave * WAVE_SIZE + i] * 8,
                    sampling=SamplingParams(max_new_tokens=MAX_NEW_TOKENS)))
                if ok is None:
                    raise AssertionError(f"cluster shed {rid}")
                submitted += 1
            # drain the wave: finished requests evict through the offload
            # path, so the next wave's shared prefix restores warm
            cluster.run()
        return summarize(cluster, submitted)
    finally:
        cluster.close()


def summarize(cluster, submitted: int) -> dict:
    """The chaos metrics of a drained cluster (tokens by request id under
    ``tokens``)."""
    stats = cluster.stats()
    ttfts = [t["ttft_s"] for t in cluster.ttfts()]
    faults = [r["faults"] for r in stats["replicas"]
              if r["faults"] is not None]
    injected = sum(f["injected_events"] for f in faults)
    recovery = sum(f["recovery_s"] for f in faults)
    ladders = [r.faults.ladder for r in cluster.replicas
               if r.faults is not None]
    return {
        "submitted": submitted,
        "finished": stats["finished"],
        "lost": submitted - stats["finished"],
        "total_tokens": stats["total_tokens"],
        "makespan_s": stats["makespan_s"],
        "goodput_tok_s": (stats["total_tokens"] / stats["makespan_s"]
                          if stats["makespan_s"] > 0 else 0.0),
        "ttft_p99_ms": float(np.percentile(ttfts, 99)) * 1e3,
        "injected_events": injected,
        "mttr_ms": (recovery / injected * 1e3) if injected else 0.0,
        "warm_blocks_restored": stats["warm_blocks_restored"],
        "escalations": sum(l.escalations_requested for l in ladders),
        "max_rung": max((max((t.level for t in l.transitions), default=0)
                         for l in ladders), default=0),
        "tokens": {e["request"].request_id: tuple(e["request"].output_tokens)
                   for e in cluster.request_log},
    }


def fault_rate_sweep(model) -> list[dict]:
    """The swept rates' rows, with the chaos invariant (identical tokens,
    zero lost) asserted at each."""
    from repro_torch.resilience import FaultPlan
    rows, baseline = [], None
    for rate in RATES:
        plan = FaultPlan.transient(seed=SEED, rate=rate) if rate else None
        r = run_cluster(model, plan)
        if r["lost"]:
            raise AssertionError(
                f"{r['lost']} requests lost at fault rate {rate}")
        if baseline is None:
            baseline = r["tokens"]
        elif r["tokens"] != baseline:
            raise AssertionError(
                f"token streams diverged from the fault-free run at rate "
                f"{rate}: faults moved data, not just the clock")
        row = {k: v for k, v in r.items() if k != "tokens"}
        row["rate"] = rate
        rows.append(row)
    return rows


def ladder_ablation(model) -> dict:
    """Ladder on against off at the highest swept rate (MAC rejects and
    restore corruption; teardown is rung-independent)."""
    from repro_torch.resilience import FaultPlan
    rate = RATES[-1]
    plan = FaultPlan(seed=SEED, crossing_failure_p=rate,
                     restore_corruption_p=rate)
    on = run_cluster(model, plan, ladder_enabled=True)
    off = run_cluster(model, plan, ladder_enabled=False)
    if on["tokens"] != off["tokens"]:
        raise AssertionError("the ladder changed token streams; it may only "
                             "change execution shape, never data")
    if on["lost"] or off["lost"]:
        raise AssertionError("requests lost in the ablation arms")
    return {
        "rate": rate,
        "ladder_on_goodput_tok_s": on["goodput_tok_s"],
        "ladder_off_goodput_tok_s": off["goodput_tok_s"],
        "goodput_ratio": on["goodput_tok_s"] / off["goodput_tok_s"],
        "ladder_on_makespan_s": on["makespan_s"],
        "ladder_off_makespan_s": off["makespan_s"],
        "ladder_on_mttr_ms": on["mttr_ms"],
        "ladder_off_mttr_ms": off["mttr_ms"],
        "escalations_on": on["escalations"],
        "escalations_requested_off": off["escalations"],
        "max_rung_on": on["max_rung"],
    }


def smoke_model(device):
    """The smoke olmo-1b the payload serves, weights from seed 0."""
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.models.model import Model
    return Model(smoke_config(get_config("olmo-1b")), seed=0, device=device)


def payload(device) -> dict:
    model = smoke_model(device)
    return {"sweep": fault_rate_sweep(model),
            "ablation": ladder_ablation(model)}


def check_drift(path: str, device) -> list[str]:
    """Recompute the payload on ``device`` and list what differs from
    ``path``."""
    golden, fresh = load(path), payload(device)
    problems: list[str] = []
    diff_rows("sweep", golden.get("sweep", []), fresh["sweep"], ("rate",),
              problems)
    diff_rows("ablation", [golden.get("ablation", {})], [fresh["ablation"]],
              ("rate",), problems)
    return problems


def rows(device) -> list[str]:
    """The payload as CSV rows; raises where the ladder did not pay for
    itself or a faulted rate was not slower than the fault-free one."""
    data = payload(device)
    lines = []
    for r in data["sweep"]:
        lines.append(
            f"chaos/goodput_rate{r['rate']:g},{r['goodput_tok_s']:.2f},"
            f"tok/s at transient fault rate {r['rate']:g} "
            f"({r['injected_events']} injected events, 0 lost, tokens "
            f"identical to fault-free; on {device})")
        lines.append(
            f"chaos/ttft_p99_rate{r['rate']:g},{r['ttft_p99_ms']:.3f},"
            f"TTFT p99 (ms) at rate {r['rate']:g}")
        lines.append(
            f"chaos/mttr_rate{r['rate']:g},{r['mttr_ms']:.4f},"
            f"mean recovery ms per injected fault at rate {r['rate']:g}")
    ab = data["ablation"]
    lines.append(
        f"chaos/ladder_goodput_ratio,{ab['goodput_ratio']:.6f},"
        f"ladder-on/off goodput at rate {ab['rate']:g} "
        f"(on {ab['ladder_on_goodput_tok_s']:.2f} vs off "
        f"{ab['ladder_off_goodput_tok_s']:.2f} tok/s, "
        f"max rung {ab['max_rung_on']})")
    if ab["goodput_ratio"] <= 1.0:
        raise AssertionError(
            f"the degradation ladder did not pay for itself at rate "
            f"{ab['rate']}: on/off goodput ratio {ab['goodput_ratio']:.6f}")
    base = data["sweep"][0]["goodput_tok_s"]
    degraded = all(r["goodput_tok_s"] < base for r in data["sweep"][1:])
    lines.append(
        f"chaos/faults_cost_goodput,{float(degraded):.1f},"
        f"every faulted rate's goodput < fault-free baseline {base:.2f}")
    return lines


def main(argv=None) -> None:
    drift_main(argv, filename="BENCH_chaos.json", doc=__doc__,
               check_drift=check_drift, rows=rows)


if __name__ == "__main__":
    main()
