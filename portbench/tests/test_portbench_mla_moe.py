"""The DeepSeek-V3 cut (family ``mla_moe``): its weight layout against the
port's, its sizes and operation count against a hand count, the port
config check, the absorbed decode's counts, and the readers of its two
metrics on hand-built records."""

import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from portbench import counts, families, serve, spec, weights  # noqa: E402
from portbench.counts import model as model_counts  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
CONFIG = "deepseek-v3-l20-ep32"
CELL = "deepseek-v3-l20-ep32.paper-1k1k-c512"


def _file():
    return spec.config(spec.load_benchmark(), CONFIG)


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v[0] if isinstance(v, tuple) else v.shape)
    return out


def test_weights_are_laid_out_as_the_ports():
    from repro_torch.models.model import abstract_params
    cfg, dm = serve.port_config(_file())
    want, _ = abstract_params(cfg)
    assert _shapes(weights.layout(dm)) == _shapes(want)


def test_the_cut_keeps_every_published_width():
    f = _file()
    assert f["reduced"] == ["num_hidden_layers", "first_k_dense_replace",
                            "n_routed_experts"]
    assert f["published"] == {"num_hidden_layers": 61,
                              "first_k_dense_replace": 3,
                              "n_routed_experts": 256}
    assert (f["num_hidden_layers"], f["first_k_dense_replace"],
            f["n_routed_experts"], f["expert_offset"]) == (20, 1, 8, 0)
    assert f["head_dim"] == f["qk_nope_head_dim"] + f["qk_rope_head_dim"]
    dm = weights.dims(f)
    assert (dm["experts"], dm["held"], dm["top_k"], dm["groups"],
            dm["topk_groups"]) == (256, 8, 8, 8, 4)
    assert dm["vocab"] == 129280 and dm["d_ff"] == 18432


def _by_hand():
    """Parameters of the cut, leaf by leaf from the published widths."""
    d, h, v = 7168, 128, 129280
    mla = (d * 1536 + 1536 + 1536 * h * 192 + d * 576 + 512
           + 512 * h * 128 * 2 + h * 128 * d)
    norms = 2 * d
    dense = 3 * d * 18432
    moe = d * 256 + 256 + 8 * 3 * d * 2048 + 3 * d * 2048
    return 2 * v * d + d + 20 * (mla + norms) + dense + 19 * moe


def test_sizes_against_a_hand_count():
    dm = weights.dims(_file())
    leaves = list(weights._leaves(weights.layout(dm)))
    n = sum(math.prod(shape) for _, (shape, _, _) in leaves)
    assert n == _by_hand() == 13_557_903_104
    nbytes = sum(math.prod(shape) * (4 if kind == "f32" else 2)
                 for _, (shape, _, kind) in leaves)
    assert nbytes == 27_185_546_240
    # the latent cache: 20 layers of (512 + 64) bf16 and an int32 pos
    assert 20 * ((512 + 64) * 2 + 4) == 23_120


def test_operations_a_token_against_a_hand_count():
    """Two operations a parameter a token passes: every MLA projection,
    the dense layer, and in each MoE layer the router, the shared expert
    and the share of its top 8 that falls to the 8 held experts."""
    dm = weights.dims(_file())
    d, h = 7168, 128
    mla = (d * 1536 + 1536 * h * 192 + d * 576 + 512 * h * 128 * 2
           + h * 128 * d)
    expert = 3 * d * 2048
    moe = d * 256 + expert * (1 + 8 * 8 / 256)
    want = 2 * (20 * mla + 3 * d * 18432 + 19 * moe)
    assert model_counts.per_token(dm) == pytest.approx(want, rel=1e-12)
    # attention products at 4 H 192 a key (flash at 192 in a prefill)
    assert model_counts.decode_flops(dm, [10]) == pytest.approx(
        want + 2 * d * 129280 + 20 * 4 * h * 192 * 10, rel=1e-12)


def test_absorbed_decode_counts():
    fam = families.get("mla_moe")
    lengths, h, dc, dr = [3, 1000], 128, 512, 64
    assert fam.absorbed_flops(lengths, h, dc, dr) == sum(
        h * n * (2 * (dc + dr) + 2 * dc) for n in lengths)
    assert fam.absorbed_bytes(lengths, h, dc, dr) == sum(
        2 * (n * (dc + dr) + h * (dc + dr) + h * dc) for n in lengths)
    # a 512-row step of 1536 positions each: bound by its bytes, not
    # its products, at the card's rates
    rows = [1536] * 512
    flops = fam.absorbed_flops(rows, h, dc, dr)
    nbytes = fam.absorbed_bytes(rows, h, dc, dr)
    assert counts.bound_s(flops, nbytes) == pytest.approx(
        nbytes / counts.PEAKS["hbm_bytes_per_s"])
    assert flops / counts.PEAKS["bf16_flops"] < counts.bound_s(flops, nbytes)


def test_port_config_checks_the_registered_arch():
    f = _file()
    cfg, dm = serve.port_config(f)
    assert (cfg.name, cfg.n_layers, cfg.n_routed_experts, cfg.experts_held,
            cfg.head_dim) == ("deepseek-v3", 20, 256, 8, 192)
    wrong = json.loads(json.dumps(f))
    wrong["port"]["overrides"]["experts_held"] = 16
    with pytest.raises(ValueError, match="experts_held"):
        serve.port_config(wrong)
    wrong = json.loads(json.dumps(f))
    wrong["routed_scaling_factor"] = 1.0
    with pytest.raises(ValueError, match="router_scale"):
        serve.port_config(wrong)


def _program(monkeypatch, *, positions=None, calls=None, held=None,
             slots=0):
    layers = types.ModuleType("repro_torch.models.layers")
    if positions is not None:
        layers.mla_decode = types.SimpleNamespace(positions_read=positions)
    tally = None if held is None else types.SimpleNamespace(
        value=lambda: held)
    layers.moe_block = types.SimpleNamespace(
        decode_slots=slots, **({} if tally is None
                               else {"decode_held_assignments": tally}))
    model = types.ModuleType("repro_torch.models.model")
    model.Model = type("Model", (), {} if calls is None
                       else {"decode_calls": calls})
    monkeypatch.setitem(sys.modules, "repro_torch.models.layers", layers)
    monkeypatch.setitem(sys.modules, "repro_torch.models.model", model)


def _decodes(*lengths):
    return [dict(kind="decode", host_s=0.0, lengths=list(n), profiled=False)
            for n in lengths]


def test_the_live_share_reads_attended_over_read(monkeypatch):
    # 2 layers, 4 rows of an 8-position cache a call: 64 positions read a
    # call; the window's two calls attend to 2 * (1+2+3+4) and 2 * 20
    _program(monkeypatch, positions=64 * 10,
             calls={"eager": 1, "captured": 1, "replayed": 8})
    rec = dict(calls=_decodes([1, 2, 3, 4], [5, 5, 5, 5]) + [
        dict(kind="prefill", host_s=0.0, prompt=4, profiled=False)],
        dims=dict(layers=2))
    got = spec.reader("model.mla_live_share")(rec)
    assert got == pytest.approx(100.0 * (2 * 10 + 2 * 20) / 2 / 64)


@pytest.mark.parametrize("positions, calls, window", [
    (None, {"eager": 1, "captured": 0, "replayed": 0}, True),
    (0, {"eager": 1, "captured": 0, "replayed": 0}, True),
    (64, None, True), (64, {"eager": 2}, False)])
def test_the_live_share_reads_nothing_without_its_counts(
        monkeypatch, positions, calls, window):
    _program(monkeypatch, positions=positions, calls=calls)
    rec = dict(calls=_decodes([1, 2]) if window else [], dims=dict(layers=2))
    assert spec.reader("model.mla_live_share")(rec) is None


def test_the_held_slot_use_reads_held_over_slots(monkeypatch):
    # 10 calls of 19 layers at 512 rows: 512 * 8 / 32 = 128 assignments
    # a layer fall to the 8 held experts, which compute 8 * 512 slots
    _program(monkeypatch, held=128 * 19 * 10, slots=8 * 512 * 19 * 10)
    assert spec.reader("model.moe_held_slot_use")({}) == pytest.approx(3.125)


@pytest.mark.parametrize("held, slots", [(None, 100), (0, 100), (5, 0)])
def test_the_held_slot_use_reads_nothing_without_a_share(monkeypatch, held,
                                                         slots):
    _program(monkeypatch, held=held, slots=slots)
    assert spec.reader("model.moe_held_slot_use")({}) is None


def test_the_cell_lists_its_metrics():
    bench = spec.load_benchmark()
    names = {m["name"]: m for m in bench["per_layer"]}
    for name in ("model.mla_live_share", "model.moe_held_slot_use"):
        assert names[name]["workloads"] == [CELL]
        assert names[name]["moves"] == "output_tok_s"
    traced = [m["name"] for m in spec.metrics(bench, CELL, True)]
    assert "model.moe_slot_use" not in traced
    assert "kernel.paged_roofline" not in traced
    assert {"model.mfu", "device.idle_share", "kernel.flash_roofline",
            "model.decode_graph_share"} <= set(traced)


def test_the_reference_loads_nothing_of_the_port():
    code = (f"import json, sys; sys.path[:0] = [{str(ROOT / 'src')!r}, "
            f"{str(ROOT)!r}]; import portbench.check, "
            f"portbench.reference.mla_moe; "
            f"print(json.dumps(sorted(sys.modules)))")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    top = {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}
    assert not top & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
