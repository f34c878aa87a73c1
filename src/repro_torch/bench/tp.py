"""The tensor-parallel ladder on the port, held against ``BENCH_tp.json``.

    PYTHONPATH=src python -m repro_torch.bench.tp --check [PATH] [--device cpu]

The port's counterpart of ``benchmarks/bench_tp.py``.  Three payloads:

1. **The TP ladder, modeled.**  nemotron-4-340b on CC-on B300, TP degree
   1/2/4/8: the per-device decode step off the roofline (FLOPs and HBM
   divide by the degree) plus the ring allreduce over the tenant fabric.
   Virtual clock only.
2. **The engine guardrail.**  A one-replica cluster (``partition_size``
   8) of the smoke olmo-1b serves the same 6 requests at TP 1/2/4/8.  TP
   is pricing, not execution: one device runs the whole model at every
   degree, so the token streams must be identical, the bridge bytes equal
   (only CVM ingress pays the toll), P2P traffic absent at TP=1 and
   present above it, every tape lawful and stall closure >= 0.99.
3. **Fallback repricing.**  The TP=4 tape replayed with the fabric forced
   down: the same P2P records reprice at the TCP fallback rate, and the
   penalty is exactly those bytes at the two rates.

``payload`` asserts those claims (and the ladder's TP=4 >= TP=1 tok/s)
inline, as the reference's ``run`` does; ``--check`` then compares every
section with the file.  The smoke model runs for real on ``--device``; the
rows are virtual-clock quantities, so they do not depend on the device.
"""

from __future__ import annotations

from repro_torch.bench import close, diff_rows, drift_main, load
from repro_torch.core.bridge import B300, TPU_V5E, BridgeModel
from repro_torch.core.compute import ComputeModel
from repro_torch.trace import opclasses as oc

#: the TP ladder (one tenant partition shape per degree)
TP_DEGREES = (1, 2, 4, 8)

#: modeled ladder operating point (nemotron-4-340b decode, CC-on B300)
LADDER_CONFIG = "nemotron-4-340b"
LADDER_BATCH = 8
LADDER_KV_LEN = 2048.0

GB = 1e9


def ladder_table() -> list[dict]:
    """Per-TP-degree step economics for the 340B config on CC-on B300."""
    from repro_torch.configs.base import get_config
    cfg = get_config(LADDER_CONFIG)
    bridge = BridgeModel(B300, cc_on=True)
    rows = []
    for tp in TP_DEGREES:
        cm = ComputeModel(cfg, bridge, tp_degree=tp)
        charge = cm.decode_charge(LADDER_BATCH, kv_len=LADDER_KV_LEN)
        ar_bytes = cm.allreduce_bytes(LADDER_BATCH)
        ar_s = cm.allreduce_seconds(LADDER_BATCH, B300.fabric_p2p_bw)
        step_s = charge.seconds + ar_s
        rows.append({
            "tp": tp,
            "compute_ms": charge.seconds * 1e3,
            "allreduce_ms": ar_s * 1e3,
            "allreduce_mb": ar_bytes / 1e6,
            "step_ms": step_s * 1e3,
            "tok_s": LADDER_BATCH / step_s,
            "weights_per_device_gb":
                cm.active_params * cm.bytes_per_param / tp / GB,
            "bound": charge.bound,
        })
    return rows


def tp_run(model, tp: int) -> dict:
    """One single-replica cluster run at TP degree ``tp``: the sorted token
    streams, the tape's bridge / P2P attribution and the tape itself
    (``_tape``, for the fallback repricing)."""
    from repro_torch.cluster import (ReplicaConfig, RoutingPolicy,
                                     build_cluster)
    from repro_torch.obs import attribute_stalls
    from repro_torch.serving.engine import Request
    from repro_torch.serving.sampler import SamplingParams
    from repro_torch.trace import check_tape
    cluster = build_cluster(
        model, cc_on=True, n_replicas=1, partition_size=8,
        replica_cfg=ReplicaConfig(tp_degree=tp),
        routing=RoutingPolicy.LEAST_LOADED, seed=0)
    try:
        for i in range(6):
            cluster.submit(Request(
                f"r{i}", prompt=list(range(1, 17)) + [40 + i] * 4,
                sampling=SamplingParams(max_new_tokens=3 + i % 4)))
        cluster.run()
        replica = cluster.replicas[0]
        tape = replica.tape()
        return {
            "tp": tp,
            "finished": len(replica.engine.finished),
            "tokens": tuple(sorted(
                (r.request_id, tuple(int(t) for t in r.output_tokens))
                for r in replica.engine.finished)),
            "virtual_time_s": replica.clock.now,
            "bridge_bytes": tape.bridge_bytes(),
            "p2p_bytes": tape.p2p_bytes(),
            "p2p_seconds": tape.p2p_seconds(),
            "p2p_allreduce_records":
                tape.op_class_mix().get(oc.P2P_ALLREDUCE, 0),
            "p2p_fallbacks": replica.gateway.stats.p2p_fallback_crossings,
            "conformant": check_tape(tape).ok,
            "closure": attribute_stalls(tape).closure,
            "_tape": tape,
        }
    finally:
        cluster.close()


def engine_guardrail(model) -> tuple[list[dict], dict]:
    """The TP ladder on the real engine: (rows, the TP=4 run with its
    tape)."""
    runs = [tp_run(model, tp) for tp in TP_DEGREES]
    base = runs[0]
    rows = [{k: v for k, v in r.items() if k not in ("tokens", "_tape")}
            | {"tokens_identical": r["tokens"] == base["tokens"]}
            for r in runs]
    return rows, next(r for r in runs if r["tp"] == 4)


def fallback_table(tp4_run: dict) -> dict:
    """Reprice the TP=4 tape's P2P records with the fabric forced down."""
    from repro_torch.trace.replay import ReplaySpec, TraceReplayer
    tape = tp4_run["_tape"]
    replayer = TraceReplayer(tape)
    up = replayer.reprice(ReplaySpec(fabric_up=True))
    down = replayer.reprice(ReplaySpec(fabric_up=False))
    p2p_bytes = tape.p2p_bytes()
    return {
        "p2p_bytes": p2p_bytes,
        "fabric_up_s": up.total_replayed_s,
        "fabric_down_s": down.total_replayed_s,
        "p2p_penalty_s": down.total_replayed_s - up.total_replayed_s,
        "expected_penalty_s":
            p2p_bytes / TPU_V5E.fabric_fallback_bw
            - p2p_bytes / TPU_V5E.fabric_p2p_bw,
    }


def assert_claims(data: dict) -> None:
    """The reference's inline assertions over a payload."""
    by_tp = {r["tp"]: r for r in data["ladder"]}
    if by_tp[4]["tok_s"] < by_tp[1]["tok_s"]:
        raise AssertionError(
            f"TP=4 modeled tok/s ({by_tp[4]['tok_s']:.1f}) fell below TP=1 "
            f"({by_tp[1]['tok_s']:.1f}) on {LADDER_CONFIG}")
    base_bridge = data["engine"][0]["bridge_bytes"]
    for e in data["engine"]:
        tp = e["tp"]
        if not e["tokens_identical"]:
            raise AssertionError(f"TP={tp} token stream diverged from TP=1")
        if not e["conformant"]:
            raise AssertionError(f"TP={tp} tape failed conformance")
        if e["bridge_bytes"] != base_bridge:
            raise AssertionError(
                f"TP={tp} moved {e['bridge_bytes']} bridge bytes vs "
                f"{base_bridge} at TP=1: only CVM ingress may pay the toll")
        if e["closure"] < 0.99:
            raise AssertionError(
                f"TP={tp} stall-attribution closure {e['closure']:.4f} < 0.99")
        if tp == 1 and e["p2p_bytes"] != 0:
            raise AssertionError("TP=1 emitted P2P traffic")
        if tp > 1 and e["p2p_bytes"] == 0:
            raise AssertionError(f"TP={tp} emitted no P2P traffic")
        if e["p2p_fallbacks"] != 0:
            raise AssertionError(
                f"healthy attested run took {e['p2p_fallbacks']} fallbacks")
    fb = data["fallback"]
    if not close(fb["p2p_penalty_s"], fb["expected_penalty_s"]):
        raise AssertionError(
            f"fallback repricing moved more than the P2P records: penalty "
            f"{fb['p2p_penalty_s']} != expected {fb['expected_penalty_s']}")


def payload(device) -> dict:
    """All three sections, the smoke model served on ``device``; raises
    where a claim of the reference's fails."""
    from repro_torch.trace.harness import smoke_model
    engine_rows, tp4 = engine_guardrail(smoke_model(device=device))
    data = {"ladder": ladder_table(), "engine": engine_rows,
            "fallback": fallback_table(tp4)}
    assert_claims(data)
    return data


def check_drift(path: str, device) -> list[str]:
    """Recompute the payload on ``device`` and list what differs from
    ``path``."""
    golden, fresh = load(path), payload(device)
    problems: list[str] = []
    diff_rows("ladder", golden.get("ladder", []), fresh["ladder"], ("tp",),
              problems)
    diff_rows("engine", golden.get("engine", []), fresh["engine"], ("tp",),
              problems)
    diff_rows("fallback", [golden.get("fallback", {})], [fresh["fallback"]],
              (), problems)
    return problems


def rows(device) -> list[str]:
    """The payload as CSV rows."""
    data = payload(device)
    lines = []
    for r in data["ladder"]:
        lines.append(
            f"tp/ladder_{LADDER_CONFIG}_tp{r['tp']},{r['tok_s']:.1f},"
            f"tok/s at batch={LADDER_BATCH} kv={LADDER_KV_LEN:g} "
            f"({r['weights_per_device_gb']:.0f} GB weights/device, "
            f"allreduce {r['allreduce_ms']:.3f} ms of "
            f"{r['step_ms']:.3f} ms step)")
    for e in data["engine"]:
        lines.append(
            f"tp/engine_tp{e['tp']}_bytes,{e['p2p_bytes']},"
            f"P2P bytes vs {e['bridge_bytes']} bridge bytes "
            f"({e['p2p_allreduce_records']} allreduce records, "
            f"closure {e['closure']:.4f}; on {device})")
    fb = data["fallback"]
    lines.append(
        f"tp/fallback_penalty_s,{fb['p2p_penalty_s']:.6f},"
        f"repricing {fb['p2p_bytes']} P2P bytes at the TCP fallback "
        f"(fabric {fb['fabric_up_s']:.6f} s -> down "
        f"{fb['fabric_down_s']:.6f} s)")
    lines.append("tp/tokens_identical,1.0,token streams identical across "
                 "TP 1/2/4/8 (greedy)")
    return lines


def main(argv=None) -> None:
    drift_main(argv, filename="BENCH_tp.json", doc=__doc__,
               check_drift=check_drift, rows=rows)


if __name__ == "__main__":
    main()
