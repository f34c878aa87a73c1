"""Quantized bridge crossings on the port, held against ``BENCH_quant.json``.

    PYTHONPATH=src python -m repro_torch.bench.quant --check [PATH] [--device cpu]

The port's counterpart of ``benchmarks/bench_quant.py``, all four sections:

1. **restore**: restore-under-decode, four slots decoding while one
   slot's pipelined KV restore drains through the same bridge, full width
   (bf16) and with ``kv_quant="fp8"``; fp8 must move <= 0.55x the bridge
   bytes and finish strictly more virtual tok/s.
2. **tokens_identical**: the codec changes wire width and timing, never
   sampling.
3. **replay**: a bulk (pool=1) fp8 offload tape repriced with
   ``ReplaySpec(quantize="")`` lands within 2% of the recorded full-width
   run of the same workload.
4. **loader**: ``PooledLoader`` over a real sharded f32 checkpoint (8
   tensors of 1024x1024 over 4 shards, PREWARMED), full width against
   ``weight_quant="int8"``; the int8 load must be modelled faster.

``payload`` asserts those claims and that every tape is lawful, as the
reference's ``run`` does.  The smoke olmo-1b and the loader's uploads run
for real on ``--device``; the rows are virtual-clock quantities, so they
do not depend on the device.
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile

import numpy as np

from repro_torch.bench import diff_tree, drift_main, load
from repro_torch.core.bridge import B300, BridgeModel
from repro_torch.core.compute import ComputeModel
from repro_torch.core.policy import (OffloadPolicy, SchedulingPolicy as SP,
                                     cc_aware_defaults)
from repro_torch.trace import opclasses as oc

#: the paper's serving config prices decode compute and dequant widening
PAPER_MODEL = "qwen3p6-27b"

#: restore-under-decode workload (the bench_bridge_opt sweep shape); the
#: restore pipeline outlasts the decode phase, so the wire width is on the
#: critical path
PROMPT = (1, 2, 3)
SHORT_TOKENS = 4
LONG_TOKENS = 16
RESTORE_BLOCKS = 96
BLOCK_BYTES = 1 << 20
CHUNK_BYTES = 64 << 10

#: bulk replay-gate workload: pool=1 + bulk restore, so recorded bridge
#: durations equal replay pricing and the 2% gate measures the lever alone
BULK_BLOCKS = 24
BULK_BLOCK_BYTES = 96 << 10

#: loader ladder checkpoint: 8 f32 tensors over 4 shards, PREWARMED pool
LOADER_TENSORS = 8
LOADER_SHAPE = (1024, 1024)
LOADER_SHARDS = 4

#: the reference's gates
FP8_BYTE_RATIO_MAX = 0.55
REPLAY_REL_ERR_MAX = 0.02

RESTORE_CLASSES = frozenset({oc.KV_RESTORE_H2D, oc.KV_RESTORE_PIPELINED,
                             oc.KV_RESTORE_Q})


def _compute(bridge):
    from repro_torch.configs.base import get_config
    return ComputeModel(get_config(PAPER_MODEL), bridge)


def run_restore(model, kv_quant: str) -> dict:
    """``bench_quant.run_restore`` through the port, step for step, on the
    model's device."""
    from repro_torch.quant import wire_bytes
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.offload import HostBlock, OffloadManager
    from repro_torch.serving.sampler import SamplingParams
    from repro_torch.trace import TraceRecorder, check_tape
    bridge = BridgeModel(B300, cc_on=True)
    defaults = dataclasses.replace(
        cc_aware_defaults(True), scheduling=SP.SYNC_DRAIN,
        loader_pool_workers=8, pipelined_restore=True,
        slot_masked_decode=True, kv_quant=kv_quant)
    compute = _compute(bridge)
    engine = ServingEngine(model, max_batch=4, max_len=64,
                           policy=SP.SYNC_DRAIN, bridge=bridge,
                           defaults=defaults, compute_model=compute, seed=0,
                           device=model.device)
    gw = engine.gateway
    gw.pool.prewarm()
    engine.submit(Request("r0", prompt=list(PROMPT), sampling=SamplingParams(
        max_new_tokens=LONG_TOKENS)))
    for i in range(1, 4):
        engine.submit(Request(f"r{i}", prompt=list(PROMPT),
                              sampling=SamplingParams(
                                  max_new_tokens=SHORT_TOKENS)))
    engine.step()      # all four slots running before the restore lands
    mgr = OffloadManager(gw, OffloadPolicy.REUSE_AWARE,
                         pipelined_restore=True,
                         restore_chunk_bytes=CHUNK_BYTES,
                         kv_quant=kv_quant, compute_model=compute)
    # the host store as a prior spill phase would have left it
    wire = wire_bytes(BLOCK_BYTES, itemsize=2) if kv_quant else 0
    for b in range(RESTORE_BLOCKS):
        mgr.host_store[b] = HostBlock(b, BLOCK_BYTES, 2, None,
                                      wire_bytes=wire, codec=kv_quant)
    mgr.on_restore_done.append(engine.mark_restore)
    recorder = TraceRecorder(gw, policy=SP.SYNC_DRAIN.value,
                             label=f"quant-restore-{kv_quant or 'bf16'}"
                             ).attach()
    try:
        mgr.restore(list(range(RESTORE_BLOCKS)), key="r0")
        stats = engine.run()
        tape = recorder.tape()
    finally:
        recorder.detach()
        engine.close()
    restore = [r for r in tape.records
               if r.kind == "crossing" and r.op_class in RESTORE_CLASSES]
    return {
        "kv_quant": kv_quant or "bf16",
        "tok_s": stats["total_tokens"] / max(stats["virtual_time_s"], 1e-12),
        "virtual_time_s": stats["virtual_time_s"],
        "restore_wire_bytes": sum(r.nbytes for r in restore),
        "restore_raw_bytes": sum(r.raw_bytes or r.nbytes for r in restore),
        "dequant_s": sum(r.t_end - r.t_start for r in tape.records
                         if r.op_class == oc.DEQUANT_COMPUTE),
        "tokens": {r.request_id: list(r.output_tokens)
                   for r in engine.finished},
        "conformance_ok": check_tape(tape).ok,
    }


def run_bulk(kv_quant: str, device):
    """One spill+restore workload through a pool-1 gateway on ``device``:
    (tape, recorded bridge seconds)."""
    from repro_torch.core.gateway import TransferGateway
    from repro_torch.serving.offload import OffloadManager
    from repro_torch.trace import TraceRecorder
    bridge = BridgeModel(B300, cc_on=True)
    gw = TransferGateway(bridge, cc_aware_defaults(True), pool_workers=1,
                         device=device)
    with TraceRecorder(gw, policy="sync_drain",
                       label=f"quant-bulk-{kv_quant or 'bf16'}") as recorder:
        mgr = OffloadManager(gw, OffloadPolicy.SPILL_ALL, kv_quant=kv_quant,
                             compute_model=_compute(bridge))
        for b in range(BULK_BLOCKS):
            mgr.evict(b, payload_bytes=BULK_BLOCK_BYTES)
        mgr.restore(list(range(BULK_BLOCKS)), key="bulk")
    return recorder.tape(), gw.stats.bridge_time_s


def replay_gate(device) -> dict:
    from repro_torch.trace import ReplaySpec, TraceReplayer, check_tape
    full_tape, full_recorded_s = run_bulk("", device)
    fp8_tape, fp8_recorded_s = run_bulk("fp8", device)
    if not (check_tape(full_tape).ok and check_tape(fp8_tape).ok):
        raise AssertionError("bulk replay-gate tape failed conformance")
    full_asrec = TraceReplayer(full_tape).reprice(
        ReplaySpec()).total_replayed_s
    unquant = TraceReplayer(fp8_tape).reprice(
        ReplaySpec(quantize="")).total_replayed_s
    forced = TraceReplayer(full_tape).reprice(
        ReplaySpec(quantize="fp8")).total_replayed_s
    return {
        "full_recorded_s": full_recorded_s,
        "fp8_recorded_s": fp8_recorded_s,
        "full_asrec_replay_s": full_asrec,
        "unquant_replay_s": unquant,
        "forced_fp8_replay_s": forced,
        "unquant_rel_err": abs(unquant - full_asrec) / full_asrec,
        "fp8_byte_ratio": (fp8_tape.bridge_bytes()
                           / fp8_tape.bridge_raw_bytes()),
        "fp8_bridge_bytes": fp8_tape.bridge_bytes(),
        "full_bridge_bytes": full_tape.bridge_bytes(),
    }


def loader_ladder(device) -> dict:
    """Full width against int8 weight-only loads of one checkpoint, written
    to a temporary directory that is removed afterwards; the loaded
    tensors must equal the checkpoint's."""
    import torch
    from repro_torch.loader import (LoaderVariant, PooledLoader,
                                    ShardedCheckpoint, save_sharded)
    rng = np.random.default_rng(0)
    tensors = {f"w{i}": rng.standard_normal(LOADER_SHAPE).astype(np.float32)
               for i in range(LOADER_TENSORS)}
    tmp = tempfile.mkdtemp(prefix="bench_quant_ckpt_")
    try:
        save_sharded(tmp, tensors, n_shards=LOADER_SHARDS)
        ckpt = ShardedCheckpoint(tmp)
        bridge = BridgeModel(B300, cc_on=True)
        full = PooledLoader(bridge, n_workers=8)
        loaded, full_bd = full.load(ckpt, LoaderVariant.PREWARMED,
                                    device=device)
        quant = PooledLoader(bridge, n_workers=8, weight_quant="int8")
        qloaded, quant_bd = quant.load(ckpt, LoaderVariant.PREWARMED,
                                       device=device)
        for name, arr in tensors.items():
            want = torch.from_numpy(arr).to(device)
            if not (torch.equal(loaded[name], want)
                    and torch.equal(qloaded[name], want)):
                raise AssertionError(f"loaded {name} differs from the "
                                     f"checkpoint's")
        wire = sum(quant.shard_wire_bytes(ckpt, s)
                   for s in range(ckpt.n_shards))
        return {
            "total_bytes": ckpt.total_bytes(),
            "wire_bytes": wire,
            "full_s": full_bd["total"],
            "int8_s": quant_bd["total"],
            "dequant_s": quant_bd["dequant"],
            "speedup": full_bd["total"] / quant_bd["total"],
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def assert_claims(data: dict) -> None:
    """The reference's inline assertions over a payload."""
    bf16, fp8 = data["restore"]
    rep, ld = data["replay"], data["loader"]
    byte_ratio = fp8["restore_wire_bytes"] / bf16["restore_wire_bytes"]
    if not data["tokens_identical"]:
        raise AssertionError("fp8 KV restore changed the token stream")
    if byte_ratio > FP8_BYTE_RATIO_MAX:
        raise AssertionError(
            f"fp8 restore moved {byte_ratio:.4f}x the bf16 bridge bytes "
            f"(gate: <= {FP8_BYTE_RATIO_MAX})")
    if not fp8["tok_s"] > bf16["tok_s"]:
        raise AssertionError(
            f"quantized restore-under-decode must win strictly: fp8 "
            f"{fp8['tok_s']:.1f} vs bf16 {bf16['tok_s']:.1f} tok/s")
    if rep["unquant_rel_err"] > REPLAY_REL_ERR_MAX:
        raise AssertionError(
            f"un-quantize replay off by {rep['unquant_rel_err']:.4f} from "
            f"the recorded full-width run (gate: <= {REPLAY_REL_ERR_MAX})")
    if not ld["speedup"] > 1.0:
        raise AssertionError(f"weight-only int8 load must beat full width: "
                             f"{ld['speedup']:.3f}x")
    if not (bf16["conformance_ok"] and fp8["conformance_ok"]):
        raise AssertionError("restore sweep tape failed conformance")


def payload(device) -> dict:
    """All four sections, on ``device``; raises where a claim of the
    reference's fails."""
    from repro_torch.trace.harness import smoke_model
    model = smoke_model(device=device)
    restore = [run_restore(model, ""), run_restore(model, "fp8")]
    tokens = [r.pop("tokens") for r in restore]
    data = {"restore": restore, "tokens_identical": tokens[0] == tokens[1],
            "replay": replay_gate(device), "loader": loader_ladder(device)}
    assert_claims(data)
    return data


def check_drift(path: str, device) -> list[str]:
    """Recompute the payload on ``device`` and list what differs from
    ``path``."""
    problems: list[str] = []
    diff_tree("quant", load(path), payload(device), problems)
    return problems


def rows(device) -> list[str]:
    """The payload as CSV rows."""
    data = payload(device)
    bf16, fp8 = data["restore"]
    rep, ld = data["replay"], data["loader"]
    ratio = fp8["restore_wire_bytes"] / bf16["restore_wire_bytes"]
    return [
        f"quant/restore_tok_s_bf16,{bf16['tok_s']:.4f},full-width "
        f"restore-under-decode ({bf16['restore_wire_bytes']} bridge bytes; "
        f"on {device})",
        f"quant/restore_tok_s_fp8,{fp8['tok_s']:.4f},fp8 restore-under-"
        f"decode ({fp8['restore_wire_bytes']} bridge bytes + "
        f"{fp8['dequant_s'] * 1e3:.3f} ms dequant compute)",
        f"quant/restore_byte_ratio,{ratio:.6f},fp8 wire / bf16 wire "
        f"(gate: <= {FP8_BYTE_RATIO_MAX})",
        f"quant/tokens_identical,{float(data['tokens_identical']):.1f},the "
        f"codec changes wire width and timing, never sampling",
        f"quant/replay_unquant_rel_err,{rep['unquant_rel_err']:.9f},"
        f"un-quantize replay {rep['unquant_replay_s'] * 1e3:.4f} ms vs "
        f"recorded full-width {rep['full_asrec_replay_s'] * 1e3:.4f} ms "
        f"(gate: <= {REPLAY_REL_ERR_MAX})",
        f"quant/loader_int8_speedup,{ld['speedup']:.4f},weight-only int8 "
        f"shard loads: {ld['wire_bytes']} wire vs {ld['total_bytes']} raw "
        f"bytes, dequant {ld['dequant_s'] * 1e6:.2f} us",
    ]


def main(argv=None) -> None:
    drift_main(argv, filename="BENCH_quant.json", doc=__doc__,
               check_drift=check_drift, rows=rows)


if __name__ == "__main__":
    main()
