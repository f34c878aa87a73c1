"""The port's serving engine, gateway and tapes against the reference.

With shared weights the port's ``ServingEngine`` and the reference's give
identical greedy token streams and identical virtual-clock stats under
every policy, for the packed and the dense step, for the dense olmo-1b
smoke decoder and the xlstm-1.3b smoke stack (with ``slstm_every=2``, so
it has an sLSTM block), and for the packed step of the hymba-1.5b,
deepseek-moe-16b and deepseek-v2-lite-16b smoke models; the port's harness
reproduces the checked-in golden tapes under ``tests/golden/regen.py``'s
comparison; one call sequence through both gateways gives equal tapes.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs.base import all_configs, smoke_config
from repro.core.bridge import B300 as J_B300, BridgeModel as JBridge
from repro.core.bridge import Crossing as JCrossing, Direction as JDirection
from repro.core.gateway import TransferGateway as JGateway
from repro.core.policy import SchedulingPolicy as JPolicy
from repro.core.policy import cc_aware_defaults as j_defaults
from repro.models.model import Model as JModel
from repro.serving.engine import Request as JRequest, ServingEngine as JEngine
from repro.serving.sampler import SamplingParams as JSampling
from repro.trace import TraceRecorder as JRecorder
from repro.trace import TraceReplayer as JReplayer, ReplaySpec as JSpec
from repro.trace.tape import BridgeTape as JTape
from repro_torch.configs.base import get_config, smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.bridge import B300, BridgeModel, Crossing, Direction
from repro_torch.core.gateway import TransferGateway
from repro_torch.core.policy import SchedulingPolicy, cc_aware_defaults
from repro_torch.models.model import Model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.sampler import SamplingParams
from repro_torch.trace import (TraceRecorder, TraceReplayer, ReplaySpec,
                               check_tape)
from repro_torch.trace.harness import GOLDEN_TAPE_FILES, record_golden_tape
from repro_torch.trace.tape import BridgeTape

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
POLICIES = ["sync", "async", "worker"]


def _regen():
    """tests/golden/regen.py, loaded as a module for its comparison."""
    spec = importlib.util.spec_from_file_location(
        "golden_regen", os.path.join(GOLDEN_DIR, "regen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------------
# engine parity with shared weights
# ---------------------------------------------------------------------------------

#: ragged workload: 6 requests through 4 slots, so slots free one by one,
#: queued requests admit mid-run and packed widths shrink and regrow
WORKLOAD = [((i * 37) % 500 + 1, 3 + 2 * (i % 2), 4 + i) for i in range(6)]


def _prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(1, vocab, n).tolist() for _, n, _ in WORKLOAD]


@pytest.fixture(scope="module")
def shared():
    jcfg = smoke_config(all_configs()["olmo-1b"])
    tcfg = t_smoke(get_config("olmo-1b"))
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jmodel, Model(tcfg, params=tparams, device="cpu")


def _run(engine, request_cls, sampling_cls, prompts):
    try:
        for i, prompt in enumerate(prompts):
            engine.submit(request_cls(
                f"r{i}", prompt=list(prompt),
                sampling=sampling_cls(max_new_tokens=WORKLOAD[i][2])))
        stats = engine.run()
    finally:
        engine.close()
    tokens = {r.request_id: list(r.output_tokens) for r in engine.finished}
    return tokens, stats


@pytest.fixture(scope="module")
def shared_xlstm():
    jcfg = dataclasses.replace(smoke_config(all_configs()["xlstm-1.3b"]),
                               slstm_every=2)
    tcfg = dataclasses.replace(t_smoke(get_config("xlstm-1.3b")),
                               slstm_every=2)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jmodel, Model(tcfg, params=tparams, device="cpu")


def _engines_agree(shared, policy, packed, max_len=48):
    jcfg, jmodel, model = shared
    prompts = _prompts(jcfg.vocab_size)
    jengine = JEngine(
        jmodel, max_batch=4, max_len=max_len, policy=JPolicy(policy),
        cc_on=True, seed=0, defaults=dataclasses.replace(
            j_defaults(True), packed_decode=packed))
    tengine = ServingEngine(
        model, max_batch=4, max_len=max_len, policy=SchedulingPolicy(policy),
        cc_on=True, seed=0, device="cpu",
        defaults=dataclasses.replace(cc_aware_defaults(True),
                                     packed_decode=packed))
    jtokens, jstats = _run(jengine, JRequest, JSampling, prompts)
    ttokens, tstats = _run(tengine, Request, SamplingParams, prompts)
    assert len(ttokens) == len(WORKLOAD)
    assert ttokens == jtokens
    assert tstats == jstats
    assert [dataclasses.asdict(t) for t in tengine.trace] == \
        [dataclasses.asdict(t) for t in jengine.trace]


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("policy", POLICIES)
def test_engine_matches_reference(shared, policy, packed):
    _engines_agree(shared, policy, packed)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
@pytest.mark.parametrize("policy", POLICIES)
def test_xlstm_engine_matches_reference(shared_xlstm, policy, packed):
    _engines_agree(shared_xlstm, policy, packed)


#: the slice's families and each one's engine length: hymba's at 96, past
#: its smoke window of 64, so its sliding layer decodes through the ring
#: (every resident slot's Mamba-2 state stepped in place) beside a global
#: layer on the paged kernel; MoE after a dense ``block0``; MLA's absorbed
#: decode over the latent cache
FAMILIES = {"hymba-1.5b": 96, "deepseek-moe-16b": 48,
            "deepseek-v2-lite-16b": 48}


@pytest.fixture(scope="module", params=list(FAMILIES))
def shared_family(request):
    jcfg = smoke_config(all_configs()[request.param])
    tcfg = t_smoke(get_config(request.param))
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jmodel, Model(tcfg, params=tparams, device="cpu")


@pytest.mark.parametrize("policy", POLICIES)
def test_family_engine_matches_reference(shared_family, policy):
    """Tokens, step traces and ``stats()`` equal the reference engine's,
    which shares the weights (the packed step; ``block0`` inserted with
    the stacked blocks, hymba's bf16 conv history widened into the
    resident f32 state)."""
    _engines_agree(shared_family, policy, True,
                   max_len=FAMILIES[shared_family[0].name.removesuffix(
                       "-smoke")])


# ---------------------------------------------------------------------------------
# golden tapes
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
def test_port_reproduces_golden_tape(policy):
    pol = SchedulingPolicy(policy)
    tape = record_golden_tape(pol, device="cpu")
    report = check_tape(tape)
    assert report.ok, report.format()
    golden = JTape.load(os.path.join(GOLDEN_DIR, GOLDEN_TAPE_FILES[pol]))
    assert _regen()._compare(tape, golden, GOLDEN_TAPE_FILES[pol]) == []


@pytest.mark.parametrize("policy", POLICIES)
def test_port_reads_and_reprices_golden_tapes(policy):
    path = os.path.join(GOLDEN_DIR, GOLDEN_TAPE_FILES[SchedulingPolicy(policy)])
    tape, jtape = BridgeTape.load(path), JTape.load(path)
    assert check_tape(tape).ok
    for cc_on in (True, False):
        ours = TraceReplayer(tape).reprice(ReplaySpec(cc_on=cc_on))
        ref = JReplayer(jtape).reprice(JSpec(cc_on=cc_on))
        assert ours.total_replayed_s == ref.total_replayed_s


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3p6-27b", "xlstm-1.3b",
                                  "qwen1.5-4b", "qwen3-32b",
                                  "nemotron-4-340b", "deepseek-moe-16b"])
def test_compute_pricing_matches_reference(arch):
    from repro.core.compute import ComputeModel as JCompute
    from repro_torch.core.compute import ComputeModel, _dtype_bytes
    assert _dtype_bytes(torch.bfloat16) == 2
    assert _dtype_bytes(torch.float32) == 4
    ours = ComputeModel(get_config(arch), BridgeModel(B300, cc_on=True))
    ref = JCompute(all_configs()[arch], JBridge(J_B300, cc_on=True))
    for o, r in ((ours.prefill_charge(512), ref.prefill_charge(512)),
                 (ours.decode_charge(8, kv_len=300.0),
                  ref.decode_charge(8, kv_len=300.0)),
                 (ours.decode_charge_packed([16.0, 512.0]),
                  ref.decode_charge_packed([16.0, 512.0]))):
        assert dataclasses.asdict(o) == dataclasses.asdict(r)


def _drive(gateway, crossing_cls, direction_cls):
    """One fixed call sequence touching every gateway entry point."""
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    b = np.ones((5,), np.float32)
    gateway.h2d(a, op_class="prompt_h2d")
    gateway.h2d(a, op_class="prompt_h2d")                 # registered now
    gateway.h2d(b, op_class="alloc_h2d", reuse_staging=False)
    ups = gateway.batch_h2d([a, b, a], op_class="prep_batched_h2d")
    gateway.d2h(ups[0], op_class="drain_d2h")
    gateway.bulk_h2d_pooled([a, b], op_class="kv_restore_h2d")
    gateway.charge_compute(1e-4, op_class="decode_packed", bound="memory",
                           tags=("packed",))
    gateway.charge_crossing(4096, direction_cls.D2H, op_class="kv_spill_d2h")
    gateway.pooled_crossing(crossing_cls(2048, direction_cls.H2D),
                            op_class="kv_restore_pipelined")
    gateway.p2p(1 << 20, op_class="p2p_allreduce")
    return ups


def test_gateways_record_equal_tapes():
    jg = JGateway(JBridge(J_B300, cc_on=True), j_defaults(True),
                  pool_workers=2)
    tg = TransferGateway(BridgeModel(B300, cc_on=True), cc_aware_defaults(True),
                         pool_workers=2, device="cpu")
    with JRecorder(jg, policy="sync", label="seq") as jrec:
        _drive(jg, JCrossing, JDirection)
    with TraceRecorder(tg, policy="sync", label="seq") as trec:
        ups = _drive(tg, Crossing, Direction)
    assert all(isinstance(u, torch.Tensor) for u in ups)
    jt, tt = jrec.tape(), trec.tape()
    assert [r.to_dict() for r in tt.records] == [r.to_dict() for r in jt.records]
    assert tt.meta.to_dict() == jt.meta.to_dict()
    assert dataclasses.asdict(tg.stats) == dataclasses.asdict(jg.stats)


# ---------------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------------

def test_engine_without_device_needs_cuda(shared, monkeypatch):
    _, _, model = shared
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model)


@pytest.mark.parametrize("knob", [{"staging_arena_bytes": 1 << 20},
                                  {"coalesce_small_crossings": True}])
def test_bridge_opt_knobs_raise(shared, knob):
    """The bridge_opt knobs once raised; now each wires its piece in
    (tests/test_torch_bridge_opt.py holds them to the reference)."""
    _, _, model = shared
    defaults = dataclasses.replace(cc_aware_defaults(True), **knob)
    engine = ServingEngine(model, defaults=defaults, device="cpu")
    try:
        arena = engine.gateway.arena
        assert (arena is not None) == ("staging_arena_bytes" in knob)
        if arena is not None:
            assert arena.capacity_bytes == knob["staging_arena_bytes"]
        assert (engine.coalescer is not None) == (
            "coalesce_small_crossings" in knob)
    finally:
        engine.close()


def test_tensor_parallel_pricing_raises(shared):
    """TP pricing is ported: an engine takes a TP=2 compute model and
    charges a fabric allreduce per decode step without changing tokens;
    only a degree below 1 raises."""
    from repro_torch.core.compute import ComputeModel
    _, _, model = shared
    bridge = BridgeModel(B300, cc_on=True)
    with pytest.raises(ValueError, match="tp_degree"):
        ComputeModel(model.cfg, bridge, tp_degree=0)
    out = {}
    for tp in (1, 2):
        engine = ServingEngine(
            model, bridge=bridge, device="cpu",
            compute_model=ComputeModel(model.cfg, bridge, tp_degree=tp))
        engine.submit(Request("r0", prompt=[1, 2, 3],
                              sampling=SamplingParams(max_new_tokens=4)))
        stats = engine.run()
        engine.close()
        out[tp] = (engine.finished[0].output_tokens,
                   engine.gateway.stats.p2p_crossings, stats["steps"])
    assert out[1][0] == out[2][0]
    assert out[1][1] == 0 and out[2][1] == 1 + out[2][2]


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main
    for arch in ("olmo-1b", "xlstm-1.3b", "qwen1.5-4b", "qwen3-32b",
                 "nemotron-4-340b"):
        stats = main(["--arch", arch, "--device", "cpu", "--requests", "3",
                      "--max-new-tokens", "4", "--cc", "--policy", "sync"])
        assert stats["finished"] == 3 and stats["total_tokens"] == 12
        out = capsys.readouterr().out
        assert f"arch={arch}-smoke" in out and "wall tok/s" in out
