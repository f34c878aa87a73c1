"""The port's bridge_opt, offload and quantized restore against the reference.

Each call sequence runs through ``repro`` and ``repro_torch`` on the CPU;
tapes, stats and greedy tokens must be equal:

  * the staging arena, the crossing coalescer and ``pipelined_h2d`` (the
    cases of ``tests/test_bridge_opt.py``), tapes JSON-equal;
  * ``OffloadManager`` spill/restore of metadata-only, f32 and bf16
    payloads under codecs ""/int8/fp8, bulk and pipelined, pool 1 and 4 —
    and what the port's restore hands back: the spilled tensor bit for bit
    unquantized, the codec's decode of the spilled codes quantized;
  * the smoke-width engine with ``cc_aware_defaults(True, bridge_opt=True)``
    under sync/async/worker, weights carried across by ``convert.py``;
  * ``benchmarks/bench_quant.py``'s restore and bulk-replay shapes, run by
    the port's benchmark module ``repro_torch.bench.quant``, which must
    reproduce ``BENCH_quant.json``'s ``restore`` and ``replay`` sections
    to its ``REL_TOL``;
  * a real-payload round trip of the smoke engine's own KV rows.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import ml_dtypes

from benchmarks import bench_quant
from repro.bridge_opt import (CrossingCoalescer as JCoalescer,
                              StagingArena as JArena,
                              pipelined_h2d as j_pipelined_h2d)
from repro.configs.base import all_configs, smoke_config
from repro.core.bridge import (B300 as J_B300, TPU_V5E as J_TPU_V5E,
                               BridgeModel as JBridge, Direction as JDirection)
from repro.core.compute import ComputeModel as JCompute
from repro.core.gateway import TransferGateway as JGateway
from repro.core.policy import OffloadPolicy as JOffloadPolicy
from repro.core.policy import SchedulingPolicy as JPolicy
from repro.core.policy import cc_aware_defaults as j_defaults
from repro.models.model import Model as JModel
from repro.quant import get_codec as j_codec
from repro.serving.engine import Request as JRequest, ServingEngine as JEngine
from repro.serving.offload import OffloadManager as JOffload
from repro.serving.sampler import SamplingParams as JSampling
from repro.trace import TraceRecorder as JRecorder
from repro.trace import ReplaySpec as JSpec, TraceReplayer as JReplayer
from repro_torch.bench import quant as port_quant
from repro_torch.bridge_opt import (CrossingCoalescer, StagingArena,
                                    pipelined_h2d)
from repro_torch.configs.base import get_config, smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.bridge import B300, TPU_V5E, BridgeModel, Direction
from repro_torch.core.compute import ComputeModel
from repro_torch.core.gateway import TransferGateway
from repro_torch.core.policy import (OffloadPolicy, SchedulingPolicy,
                                     cc_aware_defaults)
from repro_torch.kernels.dequant import ops as dq_ops
from repro_torch.models.model import Model
from repro_torch.quant import get_codec, split_wire
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.offload import OffloadManager
from repro_torch.serving.sampler import SamplingParams
from repro_torch.trace import (ReplaySpec, TraceRecorder, TraceReplayer,
                               check_tape)
from repro_torch.trace import opclasses as oc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(recorder) -> list:
    return [r.to_dict() for r in recorder.tape().records]


def _gateways(*, workers=1, arena_bytes=0, profile="v5e"):
    jp, tp = (J_TPU_V5E, TPU_V5E) if profile == "v5e" else (J_B300, B300)
    jg = JGateway(JBridge(jp, cc_on=True), j_defaults(True),
                  pool_workers=workers,
                  arena=JArena(arena_bytes) if arena_bytes else None)
    tg = TransferGateway(BridgeModel(tp, cc_on=True), cc_aware_defaults(True),
                         pool_workers=workers, device="cpu",
                         arena=StagingArena(arena_bytes) if arena_bytes
                         else None)
    return jg, tg


# ---------------------------------------------------------------------------------
# the staging arena
# ---------------------------------------------------------------------------------

ARENA_CASES = {
    "first-touch-then-hits": (1 << 20, 64, [], [100, 100, 100, 100, 120]),
    "lru-eviction": (256, 64, [], [64, 128, 60, 256]),
    "oversize": (1024, 64, [], [4096, 4096, 4096]),
    "prewarm": (1 << 20, 64, [100, 5000], [100, 5000, 9000]),
    "high-water": (256, 64, [], [64, 128, 256, 64]),
}


@pytest.mark.parametrize("case", sorted(ARENA_CASES))
def test_arena_matches_reference(case):
    cap, min_class, prewarm, sizes = ARENA_CASES[case]
    ja = JArena(cap, min_class_bytes=min_class)
    ta = StagingArena(cap, min_class_bytes=min_class)
    assert ta.prewarm(prewarm) == ja.prewarm(prewarm)
    for n in sizes:
        jk, jtag = ja.acquire(n)
        tk, ttag = ta.acquire(n)
        assert (tk.value, ttag) == (jk.value, jtag)
    assert ta.registered_classes() == ja.registered_classes()
    assert ta.stats_dict() == ja.stats_dict()


# ---------------------------------------------------------------------------------
# the crossing coalescer
# ---------------------------------------------------------------------------------

def _coalesce_watermark(co, gw, dev):
    for _ in range(4):
        co.h2d(np.zeros(128, np.int32), op_class="prep")


def _coalesce_deadline(co, gw, dev):
    co.h2d(np.zeros(4, np.int32), op_class="prep")
    gw.charge_crossing(1 << 20, gw_direction(gw).H2D, op_class="big")
    co.h2d(np.zeros(4, np.int32), op_class="prep")


def _coalesce_queue_cap(co, gw, dev):
    for _ in range(20):
        co.d2h(dev(np.zeros(1, np.int32)), op_class="drain")


def _coalesce_barrier(co, gw, dev):
    co.h2d(np.zeros(3, np.int8), op_class="a")
    co.d2h(dev(np.zeros(5, np.int8)), op_class="b")
    co.charge(7, gw_direction(gw).D2H, op_class="c")
    co.barrier()
    co.barrier()


def _coalesce_passthrough(co, gw, dev):
    co.h2d(np.zeros(1024, np.float32), op_class=oc.PROMPT_H2D)
    co.d2h(dev(np.zeros(2048, np.float32)), op_class="drain")


def _coalesce_flush_staging(co, gw, dev):
    for _ in range(2):
        co.h2d(np.zeros(2, np.int8), op_class="p")
        co.barrier()


def _coalesce_mixed(co, gw, dev):
    for i in range(40):
        co.h2d(np.zeros(8, np.int32), op_class="p")
        co.d2h(dev(np.zeros(4, np.int32)), op_class="d")
        gw.charge_compute(2e-5, op_class="decode_packed")
        co.poll()
    co.poll(source="deferral")
    co.barrier()


def gw_direction(gw):
    return Direction if isinstance(gw, TransferGateway) else JDirection


COALESCER_CASES = {
    "watermark": (_coalesce_watermark, dict(threshold_bytes=4096,
                                            watermark_bytes=2048), 0, False),
    "deadline": (_coalesce_deadline, dict(deadline_s=1e-4), 0, False),
    "queue-cap": (_coalesce_queue_cap, dict(max_queued=8, deadline_s=1e9,
                                            watermark_bytes=1 << 30), 0, False),
    "barrier": (_coalesce_barrier, {}, 0, False),
    "passthrough": (_coalesce_passthrough, dict(threshold_bytes=256), 0, False),
    "flush-staging": (_coalesce_flush_staging, {}, 0, False),
    "arena": (_coalesce_mixed, {}, 1 << 20, False),
    "worker-flush": (_coalesce_mixed, dict(worker_flush=True), 1 << 20, True),
}


@pytest.mark.parametrize("case", sorted(COALESCER_CASES))
def test_coalescer_matches_reference(case):
    drive, kw, arena_bytes, prewarm = COALESCER_CASES[case]
    jg, tg = _gateways(workers=2, arena_bytes=arena_bytes)
    if prewarm:
        jg.pool.prewarm()
        tg.pool.prewarm()
    jco, tco = JCoalescer(jg, **kw), CrossingCoalescer(tg, **kw)
    with JRecorder(jg, label=case) as jrec:
        drive(jco, jg, lambda a: a)
    with TraceRecorder(tg, label=case) as trec:
        drive(tco, tg, torch.from_numpy)
    assert _records(trec) == _records(jrec)
    assert dataclasses.asdict(tco.stats) == dataclasses.asdict(jco.stats)
    assert dataclasses.asdict(tg.stats) == dataclasses.asdict(jg.stats)
    assert check_tape(trec.tape()).ok


def test_coalescer_moves_real_values():
    _, tg = _gateways()
    co = CrossingCoalescer(tg)
    x = np.arange(6, dtype=np.int32)
    dev = co.h2d(x, op_class="up")
    assert isinstance(dev, torch.Tensor) and dev.device == tg.device
    np.testing.assert_array_equal(dev.numpy(), x)
    back = co.d2h(dev + 1, op_class="down")
    np.testing.assert_array_equal(back, x + 1)
    co.barrier()
    assert co.pending() == 0


# ---------------------------------------------------------------------------------
# pipelined restore
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("raw_total,codec", [(0, ""), (600_000, "fp8")])
def test_pipelined_h2d_matches_reference(raw_total, codec):
    jg, tg = _gateways(workers=2)
    jg.pool.prewarm()
    tg.pool.prewarm()
    rng = np.random.default_rng(0)
    payloads = [rng.integers(0, 256, n).astype(np.uint8)
                for n in (100_000, 100_000, 100_003)]
    kw = dict(chunk_bytes=64 << 10, raw_total=raw_total, codec=codec,
              tags=(oc.QUANTIZED,) if codec else ())
    with JRecorder(jg, label="pipe") as jrec:
        _, jres = j_pipelined_h2d(jg, payloads, **kw)
    with TraceRecorder(tg, label="pipe") as trec:
        arrays, tres = pipelined_h2d(tg, payloads, **kw)
    assert dataclasses.asdict(tres) == dataclasses.asdict(jres)
    assert _records(trec) == _records(jrec)
    assert tg.clock.now == jg.clock.now
    for got, want in zip(arrays, payloads):
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------------
# the offload manager
# ---------------------------------------------------------------------------------

#: (hash, observations, shape): hashes 0-3 clear REUSE_AWARE's threshold,
#: 4 does not; 5 is ragged (its last quant block is padded)
OFFLOAD_BLOCKS = [(0, 2, (2, 4, 16, 8)), (1, 2, (2, 4, 16, 8)),
                  (2, 3, (2, 4, 16, 8)), (3, 2, (300,)), (4, 1, (2, 4, 16, 8))]


def _payload(h: int, shape: tuple, kind: str):
    """The block's tensor for the port and its array for the reference."""
    x = (np.random.default_rng(h).standard_normal(shape) * (h + 1)).astype(
        np.float32)
    if kind == "f32":
        return torch.from_numpy(x), x
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, t.float().numpy().astype(ml_dtypes.bfloat16)


def _offload_pair(codec, pipelined, workers):
    jg, tg = _gateways(workers=workers)
    jg.pool.prewarm()
    tg.pool.prewarm()
    kw = dict(store_threshold=2, block_bytes=4096,
              pipelined_restore=pipelined, restore_chunk_bytes=3000,
              kv_quant=codec)
    jm = JOffload(jg, JOffloadPolicy.REUSE_AWARE, **kw,
                  compute_model=JCompute(all_configs()["qwen3p6-27b"],
                                         jg.bridge))
    tm = OffloadManager(tg, OffloadPolicy.REUSE_AWARE, **kw,
                        compute_model=ComputeModel(get_config("qwen3p6-27b"),
                                                   tg.bridge))
    return (jg, jm), (tg, tm)


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("pipelined", [False, True], ids=["bulk", "pipelined"])
@pytest.mark.parametrize("codec", ["", "int8", "fp8"])
@pytest.mark.parametrize("kind", ["meta", "f32", "bf16"])
def test_offload_matches_reference(kind, codec, pipelined, workers):
    (jg, jm), (tg, tm) = _offload_pair(codec, pipelined, workers)
    spilled = {}
    with JRecorder(jg, label="offload") as jrec, \
            TraceRecorder(tg, label="offload") as trec:
        for mgr in (jm, tm):
            for h, seen, _ in OFFLOAD_BLOCKS:
                for _ in range(seen):
                    mgr.observe(h)
        for h, _, shape in OFFLOAD_BLOCKS + [OFFLOAD_BLOCKS[0]]:
            if kind == "meta":
                assert jm.evict(h) == tm.evict(h)
                continue
            t, a = _payload(h, shape, kind)
            spilled[h] = (t, a)
            assert jm.evict(h, payload=a) == tm.evict(h, payload=t)
        keys = [3, 0, 1, 2, 4, 99]
        assert tm.restore(keys, key="k") == jm.restore(keys, key="k")
    assert _records(trec) == _records(jrec)
    assert dataclasses.asdict(tm.stats) == dataclasses.asdict(jm.stats)
    assert dataclasses.asdict(tg.stats) == dataclasses.asdict(jg.stats)
    assert tm.restore_done_t == jm.restore_done_t
    assert tm.last_restore_done_t == jm.last_restore_done_t
    assert check_tape(trec.tape()).ok
    assert dq_ops.dequant.launches == 0             # the CPU: plain version
    if kind == "meta":
        assert tm.restored == {}
        return
    assert sorted(tm.restored) == [0, 1, 2, 3]
    for h in tm.restored:
        t, _ = spilled[h]
        got = tm.restored[h]
        if not codec:
            assert got.dtype == t.dtype and torch.equal(got, t)
            continue
        ref = j_codec(codec)
        want = ref.decode(ref.encode(t.float().numpy()))
        assert got.dtype == torch.float32 and got.shape == t.shape
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))


def test_offload_coalesced_metadata_spills_match_reference():
    from repro.obs import Observatory as JObservatory
    from repro_torch.obs import Observatory
    for codec in ("", "fp8"):
        (jg, jm), (tg, tm) = _offload_pair(codec, True, 4)
        jm.coalescer, tm.coalescer = JCoalescer(jg), CrossingCoalescer(tg)
        jm.obs, tm.obs = JObservatory(), Observatory()
        with JRecorder(jg, label="co") as jrec, \
                TraceRecorder(tg, label="co") as trec:
            for mgr in (jm, tm):
                for h in range(6):
                    mgr.observe(h)
                    mgr.observe(h)
                    mgr.evict(h, payload_bytes=1000 * (h + 1))
                mgr.coalescer.barrier()
                mgr.restore(list(range(6)), key="r")
                mgr.migrate([0, 1, 7])
        assert _records(trec) == _records(jrec)
        assert dataclasses.asdict(tm.stats) == dataclasses.asdict(jm.stats)
        assert dataclasses.asdict(tm.coalescer.stats) == \
            dataclasses.asdict(jm.coalescer.stats)
        assert tm.obs.registry.snapshot() == jm.obs.registry.snapshot()


@pytest.mark.parametrize("policy", ["spill_all", "reuse_aware"])
def test_churn_workload_matches_reference(policy):
    from repro.serving.offload import churn_workload as j_churn
    from repro_torch.serving.offload import churn_workload
    (jg, jm), (tg, tm) = _offload_pair("int8", True, 4)
    jm.policy, tm.policy = JOffloadPolicy(policy), OffloadPolicy(policy)
    kw = dict(n_requests=4, prefix_blocks=3, unique_blocks=2,
              block_bytes=5000)
    with JRecorder(jg, label="churn") as jrec, \
            TraceRecorder(tg, label="churn") as trec:
        jstats = j_churn(jm, **kw)
        tstats = churn_workload(tm, **kw)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert _records(trec) == _records(jrec)


def test_offload_refuses_a_payload_that_is_not_a_tensor():
    _, (_, tm) = _offload_pair("fp8", False, 1)
    with pytest.raises(TypeError, match="tensor"):
        tm.evict(0, payload=np.zeros(8, np.float32))


# ---------------------------------------------------------------------------------
# the engine with bridge_opt on
# ---------------------------------------------------------------------------------

WORKLOAD = [((i * 37) % 500 + 1, 3 + 2 * (i % 2), 4 + i) for i in range(6)]


@pytest.fixture(scope="module")
def shared():
    jcfg = smoke_config(all_configs()["olmo-1b"])
    tcfg = t_smoke(get_config("olmo-1b"))
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jmodel, Model(tcfg, params=tparams, device="cpu")


def _serve(engine, request_cls, sampling_cls, prompts):
    rec_cls = TraceRecorder if isinstance(engine, ServingEngine) \
        else JRecorder
    recorder = rec_cls(engine.gateway, policy=engine.policy.value,
                       label="bridge-opt")
    try:
        with recorder:
            for i, prompt in enumerate(prompts):
                engine.submit(request_cls(
                    f"r{i}", prompt=list(prompt),
                    sampling=sampling_cls(max_new_tokens=WORKLOAD[i][2])))
            stats = engine.run()
    finally:
        engine.close()
    tokens = {r.request_id: list(r.output_tokens) for r in engine.finished}
    return tokens, stats, _records(recorder)


@pytest.mark.parametrize("policy", ["sync", "async", "worker"])
def test_bridge_opt_engine_matches_reference(shared, policy):
    jcfg, jmodel, model = shared
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, jcfg.vocab_size, n).tolist()
               for _, n, _ in WORKLOAD]
    kw = dict(max_batch=4, max_len=48, cc_on=True, seed=0)
    jengine = JEngine(jmodel, policy=JPolicy(policy),
                      bridge=JBridge(J_B300, cc_on=True),
                      defaults=j_defaults(True, bridge_opt=True), **kw)
    tengine = ServingEngine(model, policy=SchedulingPolicy(policy),
                            bridge=BridgeModel(B300, cc_on=True),
                            defaults=cc_aware_defaults(True, bridge_opt=True),
                            device="cpu", **kw)
    jtokens, jstats, jtape = _serve(jengine, JRequest, JSampling, prompts)
    ttokens, tstats, ttape = _serve(tengine, Request, SamplingParams, prompts)
    assert len(ttokens) == len(WORKLOAD) and ttokens == jtokens
    assert tstats == jstats
    assert [dataclasses.asdict(t) for t in tengine.trace] == \
        [dataclasses.asdict(t) for t in jengine.trace]
    assert ttape == jtape
    assert dataclasses.asdict(tengine.coalescer.stats) == \
        dataclasses.asdict(jengine.coalescer.stats)
    assert tengine.gateway.arena.stats_dict() == \
        jengine.gateway.arena.stats_dict()
    assert tengine.coalescer.pending() == 0
    assert tengine._worker is None      # worker x coalescer: no thread


# ---------------------------------------------------------------------------------
# benchmarks/bench_quant.py's shapes on the port
# ---------------------------------------------------------------------------------

def test_port_bench_runs_the_references_shapes():
    """``repro_torch.bench.quant`` (which the tests below drive) runs
    ``bench_quant``'s workloads: every shape constant is the reference's."""
    for name in ("PAPER_MODEL", "PROMPT", "SHORT_TOKENS", "LONG_TOKENS",
                 "RESTORE_BLOCKS", "BLOCK_BYTES", "CHUNK_BYTES",
                 "BULK_BLOCKS", "BULK_BLOCK_BYTES", "LOADER_TENSORS",
                 "LOADER_SHAPE", "LOADER_SHARDS", "FP8_BYTE_RATIO_MAX",
                 "REPLAY_REL_ERR_MAX"):
        assert getattr(port_quant, name) == getattr(bench_quant, name), name
    assert port_quant.RESTORE_CLASSES == bench_quant._RESTORE_CLASSES


def _drift(gold, fresh) -> list:
    problems: list = []
    bench_quant._diff("quant", gold, fresh, problems)
    return problems


def _golden() -> dict:
    with open(os.path.join(ROOT, "BENCH_quant.json")) as f:
        return json.load(f)


def test_port_reproduces_bench_quant_restore():
    from repro_torch.trace.harness import smoke_model
    model = smoke_model(device="cpu")
    restore = [port_quant.run_restore(model, ""),
               port_quant.run_restore(model, "fp8")]
    tokens = [r.pop("tokens") for r in restore]
    assert tokens[0] == tokens[1] and len(tokens[0]) == 4
    golden = _golden()
    assert _drift(golden["restore"], restore) == []
    assert golden["tokens_identical"] is True


def test_port_reproduces_bench_quant_replay_gate():
    assert _drift(_golden()["replay"], port_quant.replay_gate("cpu")) == []


@pytest.mark.parametrize("lever", ["", "int8", "fp8"])
def test_quantize_lever_reprices_as_the_reference(lever):
    for kv_quant in ("", "int8"):
        tape, _ = port_quant.run_bulk(kv_quant, "cpu")
        jtape = bench_quant.run_bulk(kv_quant)[0]
        assert [r.to_dict() for r in tape.records] == \
            [r.to_dict() for r in jtape.records]
        ours = TraceReplayer(tape).reprice(ReplaySpec(quantize=lever))
        ref = JReplayer(jtape).reprice(JSpec(quantize=lever))
        assert ours.total_replayed_s == ref.total_replayed_s
        assert ours.wall_s == ref.wall_s
    with pytest.raises(ValueError, match="unknown codec"):
        TraceReplayer(tape).reprice(ReplaySpec(quantize="int4"))


# ---------------------------------------------------------------------------------
# a real-payload round trip of the engine's own KV rows
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["", "int8", "fp8"])
def test_engine_kv_rows_round_trip(shared, codec):
    _, _, model = shared
    engine = ServingEngine(model, max_batch=2, max_len=48,
                           policy=SchedulingPolicy.SYNC_DRAIN, cc_on=True,
                           bridge=BridgeModel(B300, cc_on=True),
                           defaults=cc_aware_defaults(True, bridge_opt=True),
                           device="cpu")
    try:
        engine.submit(Request("r0", prompt=list(range(1, 33)),
                              sampling=SamplingParams(max_new_tokens=8)))
        engine.step()
        slot = next(iter(engine.active))
        kv = engine.caches["blocks"]["kv"]
        mgr = OffloadManager(engine.gateway, OffloadPolicy.REUSE_AWARE,
                             pipelined_restore=True,
                             restore_chunk_bytes=4096, kv_quant=codec,
                             compute_model=engine.compute)
        blocks = {}
        for i in range(2):           # two 16-token blocks of the prompt
            rows = slice(16 * i, 16 * (i + 1))
            blocks[i] = torch.stack([kv["k"][:, slot, rows],
                                     kv["v"][:, slot, rows]]).clone()
            mgr.observe(i)
            mgr.observe(i)
            assert mgr.evict(i, payload=blocks[i])
        with TraceRecorder(engine.gateway, label="rt") as rec:
            assert mgr.restore([0, 1], key="r0") == (
                2, 2 * blocks[0].nbytes)
        assert check_tape(rec.tape()).ok
    finally:
        engine.close()
    for i, block in blocks.items():
        host = mgr.host_store[i]
        got = mgr.restored[i]
        if not codec:
            assert host.payload.nbytes == block.nbytes
            assert got.dtype == torch.bfloat16 and torch.equal(got, block)
            continue
        qb = host.qblock
        assert host.payload.nbytes == host.wire_bytes == qb.wire_bytes
        codes, scales = split_wire(torch.from_numpy(host.payload),
                                   qb.codes.numel())
        fresh = get_codec(codec).encode(block)
        assert torch.equal(codes, fresh.codes)
        assert torch.equal(scales.view(torch.int32),
                           fresh.scales.view(torch.int32))
        # the widened block: the plain decode of the host-store codes, and
        # the reference codec's decode of the same bf16 values
        want = get_codec(codec).decode(qb)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        ref = j_codec(codec)
        jwant = ref.decode(ref.encode(block.float().numpy()))
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      jwant.view(np.uint32))
        amax = block.float().abs().reshape(-1, 128).amax(1)
        err = (got - block.float()).abs().reshape(-1, 128).amax(1)
        # the codec's bound (half a code step at the top of the block), plus
        # the f32 rounding of the scale, the product and the difference: a
        # few units in the last place of the block's amax
        bound = 0.5 / 127 if codec == "int8" else 16 / 448
        assert bool((err <= amax * (bound + 2.0 ** -22)).all())
