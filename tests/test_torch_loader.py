"""The port's loader (``repro_torch.loader``) against the reference's.

The loader cases of ``tests/test_serving.py`` (``TestLoader``),
``tests/test_bridge_opt.py`` (``TestLoaderArenaStaging``),
``tests/test_quant.py`` (``TestQuantizedLoader``) and
``tests/test_tp_fabric.py`` (``TestShardExchangeAndMigration``) run on the
port.  On one checkpoint of f32 and bf16 tensors, for each of the six
variants without a gateway, with one, with a staging arena, with
``weight_quant="int8"`` and at ``tp_degree=4``: the breakdown equals the
reference's key for key (rel 1e-12), the tape record for record, and the
loaded tensors bit for bit.  ``save_sharded`` writes the reference's files
byte for byte, bf16 included (the reference writes ``ml_dtypes`` bf16, the
port ``torch.bfloat16`` or its uint16 bits), and each package reads the
other's checkpoint.
"""

import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import ml_dtypes

from repro.bridge_opt import StagingArena as JArena
from repro.core.bridge import (B300 as J_B300, TPU_V5E as J_TPU_V5E,
                               BridgeModel as JBridge)
from repro.core.gateway import TransferGateway as JGateway
from repro.core.policy import cc_aware_defaults as j_defaults
from repro.loader.pooled_loader import (LoaderVariant as JVariant,
                                        PooledLoader as JLoader)
from repro.loader.sharded_weights import (ShardedCheckpoint as JCheckpoint,
                                          save_sharded as j_save)
from repro.trace import TraceRecorder as JRecorder

from repro_torch.bridge_opt import StagingArena
from repro_torch.core.bridge import B300, RTX_PRO_6000, TPU_V5E, BridgeModel
from repro_torch.core.gateway import TransferGateway
from repro_torch.core.policy import cc_aware_defaults
from repro_torch.loader import (LoaderRates, LoaderVariant, PooledLoader,
                                ShardedCheckpoint, save_sharded)
from repro_torch.quant import AccuracyBudgetError
from repro_torch.trace import TraceRecorder, check_tape
from repro_torch.trace import opclasses as oc

torch.set_num_threads(1)

GIB = 1 << 30


def _gw(*, workers=1, arena=None, profile=TPU_V5E):
    return TransferGateway(BridgeModel(profile, cc_on=True),
                           cc_aware_defaults(True), pool_workers=workers,
                           arena=arena, device="cpu")


def _bits(x) -> bytes:
    """Any array or loaded tensor (torch or jax) as its raw bytes."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def _mixed_tensors() -> dict:
    """f32 and bf16 tensors of several shapes (the reference's bf16 is
    ``ml_dtypes``; the port gets the same bits as ``torch.bfloat16``)."""
    rng = np.random.default_rng(3)
    out = {}
    for i, shape in enumerate([(64, 32), (7,), (3, 5, 16), (128,), (2, 64),
                               (33, 9), ()]):
        a = rng.standard_normal(shape).astype(np.float32)
        out[f"t{i}"] = a.astype(ml_dtypes.bfloat16) if i % 2 else a
    return out


def _as_port(tensors: dict) -> dict:
    return {k: (torch.from_numpy(np.asarray(v).view(np.int16)).view(
        torch.bfloat16) if v.dtype == ml_dtypes.bfloat16 else v)
        for k, v in tensors.items()}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ckpt"))
    j_save(d, _mixed_tensors(), n_shards=3)
    return d


# ---------------------------------------------------------------------------------
# files: byte for byte, and each package reads the other's
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_save_sharded_writes_the_references_files(tmp_path, n_shards):
    tensors = _mixed_tensors()
    j_save(str(tmp_path / "ref"), tensors, n_shards=n_shards)
    save_sharded(str(tmp_path / "port"), _as_port(tensors), n_shards=n_shards)
    # the reference's own arrays (ml_dtypes bf16) give the same files too
    save_sharded(str(tmp_path / "port_np"), tensors, n_shards=n_shards)
    names = ["index.json"] + [f"shard_{s}.bin" for s in range(n_shards)]
    for other in ("port", "port_np"):
        match, mismatch, errors = filecmp.cmpfiles(
            tmp_path / "ref", tmp_path / other, names, shallow=False)
        assert match == names and not mismatch and not errors


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_reads_the_others_checkpoint(tmp_path, writer):
    tensors = _mixed_tensors()
    if writer == "reference":
        j_save(str(tmp_path), tensors, n_shards=2)
    else:
        save_sharded(str(tmp_path), _as_port(tensors), n_shards=2)
    port, ref = ShardedCheckpoint(str(tmp_path)), JCheckpoint(str(tmp_path))
    assert port.index == ref.index
    for name, arr in tensors.items():
        want = np.asarray(arr)
        got = port.read_tensor(name)
        assert got.shape == want.shape and got.flags.writeable
        assert got.dtype == (np.uint16 if want.dtype == ml_dtypes.bfloat16
                             else want.dtype)
        assert _bits(got) == _bits(want)
        assert _bits(ref.read_tensor(name)) == _bits(want)
        t = port.read_torch(name, "cpu")
        assert t.dtype == (torch.bfloat16 if port.is_bf16(name)
                           else torch.float32)
        assert _bits(t) == _bits(want)
    for s in range(2):
        assert port.shard_bytes(s) == ref.shard_bytes(s)
        assert [n for n, _ in port.iter_shard(s)] == ref.shard_tensors(s)
    assert port.total_bytes() == ref.total_bytes()


def test_read_tensor_rejects_a_truncated_shard(tmp_path):
    save_sharded(str(tmp_path), {"w": np.ones((4, 4), np.float32)},
                 n_shards=1)
    path = tmp_path / "shard_0.bin"
    path.write_bytes(path.read_bytes()[:40])
    with pytest.raises(ValueError, match="ends after 40 of 64 bytes"):
        ShardedCheckpoint(str(tmp_path)).read_tensor("w")


# ---------------------------------------------------------------------------------
# loads: breakdowns, tapes and tensors against the reference's
# ---------------------------------------------------------------------------------

MODES = ["no_gateway", "gateway", "gateway_arena", "int8", "tp4"]


def _load(pkg, ckpt_path, variant, mode):
    """One load in ``pkg`` ("ref" or "port"): (tensors, breakdown, tape)."""
    ref = pkg == "ref"
    bridge = (JBridge if ref else BridgeModel)(J_B300 if ref else B300,
                                               cc_on=True)
    ckpt = (JCheckpoint if ref else ShardedCheckpoint)(ckpt_path)
    variant = (JVariant if ref else LoaderVariant)(variant)
    kw = {}
    gw = recorder = None
    if mode != "no_gateway":
        arena = None
        if mode == "gateway_arena":
            arena = (JArena if ref else StagingArena)(1 << 24)
        if ref:
            gw = JGateway(bridge, j_defaults(True), pool_workers=8)
        else:
            gw = TransferGateway(bridge, cc_aware_defaults(True),
                                 pool_workers=8, device="cpu")
        kw = dict(gateway=gw, arena=arena,
                  weight_quant="int8" if mode == "int8" else "")
        recorder = (JRecorder if ref else TraceRecorder)(
            gw, label="loader").attach()
    loader = (JLoader if ref else PooledLoader)(bridge, n_workers=8, **kw)
    load_kw = {"tp_degree": 4 if mode == "tp4" else 1}
    if not ref:
        load_kw["device"] = "cpu"
    try:
        tensors, breakdown = loader.load(ckpt, variant, **load_kw)
    finally:
        if recorder is not None:
            recorder.detach()
    tape = recorder.tape() if recorder is not None else None
    return tensors, breakdown, tape, loader.clock.now


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", [v.value for v in LoaderVariant])
def test_load_is_the_references(ckpt_dir, variant, mode):
    jt, jbd, jtape, jnow = _load("ref", ckpt_dir, variant, mode)
    tt, tbd, ttape, tnow = _load("port", ckpt_dir, variant, mode)
    assert list(tbd) == list(jbd)
    for key, want in jbd.items():
        assert tbd[key] == pytest.approx(want, rel=1e-12, abs=0.0), key
    assert tnow == pytest.approx(jnow, rel=1e-12, abs=0.0)
    assert list(tt) == list(jt)
    for name in jt:
        assert tuple(tt[name].shape) == tuple(jt[name].shape)
        assert _bits(tt[name]) == _bits(jt[name]), name
    if jtape is None:
        return
    assert ttape.meta.to_dict() == jtape.meta.to_dict()
    assert [r.to_dict() for r in ttape.records] == \
        [r.to_dict() for r in jtape.records]
    assert check_tape(ttape).ok


# ---------------------------------------------------------------------------------
# tests/test_serving.py::TestLoader
# ---------------------------------------------------------------------------------

class TestLoader:
    def test_real_tensors_load_exactly(self, tmp_path):
        tensors = {f"w{i}": np.random.default_rng(i).standard_normal(
            (32, 16)).astype(np.float32) for i in range(6)}
        save_sharded(str(tmp_path / "ckpt"), tensors, n_shards=3)
        ckpt = ShardedCheckpoint(str(tmp_path / "ckpt"))
        loader = PooledLoader(BridgeModel(B300, cc_on=True), n_workers=8)
        for v in LoaderVariant:
            loaded, _ = loader.load(ckpt, v, device="cpu")
            for name, arr in tensors.items():
                assert loaded[name].device.type == "cpu"
                np.testing.assert_array_equal(loaded[name].numpy(), arr)

    def test_ladder_is_monotone_at_model_scale(self):
        loader = PooledLoader(BridgeModel(B300, cc_on=True), n_workers=8)
        t = {v: loader.modeled_load_time(59 * GIB, 15, v)["total"]
             for v in LoaderVariant}
        assert t[LoaderVariant.PREWARMED] < t[LoaderVariant.POOLED] \
            < t[LoaderVariant.FASTSAFETENSORS] < t[LoaderVariant.THREADS8] \
            < t[LoaderVariant.NAIVE_POOL] < t[LoaderVariant.BASELINE]

    @pytest.mark.parametrize("variant", [
        LoaderVariant.BASELINE, LoaderVariant.FASTSAFETENSORS,
        LoaderVariant.POOLED, LoaderVariant.PREWARMED])
    def test_ladder_transfers_across_platforms_within_5pct(self, variant):
        t = {prof.name: PooledLoader(BridgeModel(prof, cc_on=True),
                                     n_workers=8).modeled_load_time(
                                         59 * GIB, 15, variant)["total"]
             for prof in (B300, RTX_PRO_6000)}
        assert abs(t["b300-hgx"] - t["rtx-pro-6000"]) / t["b300-hgx"] < 0.05

    def test_default_device_is_the_card(self, tmp_path, monkeypatch):
        save_sharded(str(tmp_path), {"w": np.zeros(4, np.float32)})
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        loader = PooledLoader(BridgeModel(B300, cc_on=True))
        with pytest.raises(RuntimeError, match="CUDA"):
            loader.load(ShardedCheckpoint(str(tmp_path)),
                        LoaderVariant.BASELINE)
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedCheckpoint(str(tmp_path)).read_torch("w")

    def test_rates_are_the_references(self):
        from repro.loader.pooled_loader import LoaderRates as JRates
        assert LoaderRates() == LoaderRates(**vars(JRates()))


# ---------------------------------------------------------------------------------
# tests/test_bridge_opt.py::TestLoaderArenaStaging
# ---------------------------------------------------------------------------------

def test_arena_collapses_per_shard_fresh_toll(tmp_path):
    tensors = {f"w{i}": np.random.default_rng(i).standard_normal(
        (32, 8)).astype(np.float32) for i in range(8)}
    save_sharded(str(tmp_path / "ckpt"), tensors, n_shards=4)
    ckpt = ShardedCheckpoint(str(tmp_path / "ckpt"))
    bridge = BridgeModel(TPU_V5E, cc_on=True)

    def load(arena):
        gw = _gw(workers=8)
        loader = PooledLoader(bridge, n_workers=8, gateway=gw, arena=arena)
        with TraceRecorder(gw, label="loader") as rec:
            loaded, breakdown = loader.load(ckpt, LoaderVariant.PREWARMED,
                                            device="cpu")
        return loaded, breakdown, rec.tape()

    plain_loaded, plain, _ = load(None)
    arena_loaded, opt, tape = load(StagingArena(1 << 24))
    p = bridge.profile
    expected = (p.cc_fresh_toll + p.cc_fresh_alloc
                + (ckpt.n_shards - 1) * p.cc_registered_toll)
    assert opt["toll"] == pytest.approx(expected)
    assert opt["toll"] < plain["toll"] / 2
    shard_recs = [r for r in tape.records
                  if r.op_class == oc.LOADER_SHARD_H2D]
    assert [r.staging for r in shard_recs] == (
        ["fresh"] + ["registered"] * (ckpt.n_shards - 1))
    assert sum(r.duration_s for r in shard_recs) == pytest.approx(
        opt["transfer"] + opt["toll"], rel=1e-9)
    assert check_tape(tape).ok
    for name, arr in tensors.items():
        np.testing.assert_array_equal(arena_loaded[name].numpy(), arr)
        np.testing.assert_array_equal(plain_loaded[name].numpy(), arr)


# ---------------------------------------------------------------------------------
# tests/test_quant.py::TestQuantizedLoader
# ---------------------------------------------------------------------------------

class TestQuantizedLoader:
    def _load(self, tmp_path, weight_quant):
        d = str(tmp_path / f"ckpt-{weight_quant or 'raw'}")
        tensors = {f"w{i}": np.random.default_rng(i).standard_normal(
            1024).astype(np.float32).reshape(32, 32) for i in range(4)}
        save_sharded(d, tensors, n_shards=2)
        bridge = BridgeModel(TPU_V5E, cc_on=True)
        gw = TransferGateway(bridge, cc_aware_defaults(True), device="cpu")
        rec = TraceRecorder(gw, policy="sync_drain", label="ld").attach()
        loader = PooledLoader(bridge, gateway=gw, weight_quant=weight_quant)
        loaded, breakdown = loader.load(ShardedCheckpoint(d),
                                        LoaderVariant.POOLED, device="cpu")
        for name, arr in tensors.items():       # full width either way
            np.testing.assert_array_equal(loaded[name].numpy(), arr)
        return rec.tape(), breakdown

    def test_quantized_load_ratio_above_one(self, tmp_path):
        full, _ = self._load(tmp_path, "")
        quant, breakdown = self._load(tmp_path, "int8")
        assert check_tape(full).ok and check_tape(quant).ok
        ratio = full.bridge_bytes() / quant.bridge_bytes()
        assert ratio > 3.0
        assert breakdown["dequant"] > 0
        assert oc.DEQUANT_COMPUTE in quant.op_class_mix()

    def test_shard_records_use_weight_shard_q_class(self, tmp_path):
        quant, _ = self._load(tmp_path, "fp8")
        shards = [r for r in quant.records
                  if r.op_class == oc.WEIGHT_SHARD_Q]
        assert shards
        for r in shards:
            assert oc.QUANTIZED in r.tags
            assert 0 < r.nbytes <= r.raw_bytes
            assert r.codec == "fp8"
        assert oc.LOADER_SHARD_H2D not in quant.op_class_mix()

    def test_loader_rejects_codec_over_budget(self):
        with pytest.raises(AccuracyBudgetError):
            PooledLoader(BridgeModel(TPU_V5E, cc_on=True),
                         weight_quant="fp8", accuracy_budget=0.01)


# ---------------------------------------------------------------------------------
# tests/test_tp_fabric.py::TestShardExchangeAndMigration (the loader cases)
# ---------------------------------------------------------------------------------

class TestShardExchange:
    def test_loader_tp_load_adds_p2p_not_bridge_bytes(self, tmp_path):
        tensors = {f"w{i}": np.zeros((64, 64), np.float32) for i in range(4)}
        save_sharded(str(tmp_path), tensors, n_shards=2)
        ckpt = ShardedCheckpoint(str(tmp_path))

        def load_with(tp):
            gw = _gw(workers=2)
            loader = PooledLoader(gw.bridge, n_workers=2, gateway=gw,
                                  clock=gw.clock)
            with TraceRecorder(gw) as rec:
                loader.load(ckpt, LoaderVariant.PREWARMED, device="cpu",
                            tp_degree=tp)
            return rec.tape(), gw

        tape1, _ = load_with(1)
        tape4, gw4 = load_with(4)
        assert tape4.bridge_bytes() == tape1.bridge_bytes()
        assert tape1.p2p_bytes() == 0
        assert tape4.p2p_bytes() == int(ckpt.total_bytes() * 3 / 4)
        assert gw4.stats.p2p_crossings == 1
        assert tape4.op_class_mix().get(oc.P2P_SHARD_EXCHANGE) == 1
        assert check_tape(tape4).ok

    def test_loader_rejects_nonpositive_tp(self):
        with pytest.raises(ValueError, match="tp_degree"):
            PooledLoader(BridgeModel(TPU_V5E, cc_on=True)).load(
                None, LoaderVariant.BASELINE, tp_degree=0)


# ---------------------------------------------------------------------------------
# the constructor's refusals
# ---------------------------------------------------------------------------------

def test_loader_clock_must_be_the_gateways():
    from repro_torch.core.channels import VirtualClock
    gw = _gw()
    with pytest.raises(ValueError, match="gateway's clock"):
        PooledLoader(gw.bridge, gateway=gw, clock=VirtualClock())


@pytest.mark.parametrize("bridge", [BridgeModel(B300, cc_on=True),
                                    BridgeModel(TPU_V5E, cc_on=False)])
def test_loader_bridge_must_match_the_gateways(bridge):
    with pytest.raises(ValueError, match="must match the gateway's"):
        PooledLoader(bridge, gateway=_gw())
