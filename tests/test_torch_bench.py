"""The port's drift checks against ``BENCH_packed.json``, ``BENCH_obs.json``,
``BENCH_chaos.json``, ``BENCH_tp.json`` and ``BENCH_quant.json``.

On the CPU, ``repro_torch.bench.packed``'s roofline rows and engine rows,
``repro_torch.bench.obs``'s capacity and load curves,
``repro_torch.bench.chaos``'s fault-rate sweep and ladder ablation,
``repro_torch.bench.tp``'s ladder, engine guardrail and fallback repricing
and ``repro_torch.bench.quant``'s four sections equal the files the
reference's benchmarks wrote, within ``REL_TOL`` (1e-9);
``--check`` passes on the files and exits 1 on a perturbed copy; no module
can write a drift file; the default device is the card, with no quiet CPU
run.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.bench import REL_TOL, close, diff_rows, diff_tree
from repro_torch.bench import chaos as bench_chaos
from repro_torch.bench import obs as bench_obs
from repro_torch.bench import packed as bench_packed
from repro_torch.bench import quant as bench_quant
from repro_torch.bench import tp as bench_tp

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["packed", "obs", "chaos", "tp", "quant"]
DRIFT = {name: os.path.join(ROOT, f"BENCH_{name}.json") for name in NAMES}
MODULES = {"packed": bench_packed, "obs": bench_obs, "chaos": bench_chaos,
           "tp": bench_tp, "quant": bench_quant}


def _golden(name):
    with open(DRIFT[name]) as f:
        return json.load(f)


def test_tolerance_is_the_references():
    assert REL_TOL == 1e-9
    assert bench_packed.CONFIGS == ("qwen1p5-4b", "deepseek-moe-16b",
                                    "qwen3p6-27b")
    assert bench_packed.ENGINE_BATCHES == (4, 8, 16)


def test_packed_roofline_rows_match_file():
    rows = bench_packed.roofline_table()
    assert len(rows) == 3 * 4 * 3
    problems = []
    diff_rows("roofline", _golden("packed")["roofline"], rows,
              ("config", "batch", "input_len", "output_len"), problems)
    assert problems == []


def test_packed_engine_rows_match_file():
    rows = bench_packed.engine_sweep("cpu")
    assert all(r["tokens_identical"] and r["ratio"] >= 1.0 for r in rows)
    problems = []
    diff_rows("engine", _golden("packed")["engine"], rows, ("max_batch",),
              problems)
    assert problems == []


def test_obs_curves_match_file():
    from repro_torch.trace.harness import smoke_model
    fresh = bench_obs.offered_load_curves(smoke_model(device="cpu"))
    gold = _golden("obs")
    assert close(fresh["capacity_rps"], gold["capacity_rps"])
    problems = []
    diff_rows("load", gold["curves"], fresh["curves"], ("multiple",),
              problems)
    assert problems == []
    assert [c["multiple"] for c in fresh["curves"]] == [0.5, 1.0, 2.0]


def _perturb(name, tmp_path):
    data = _golden(name)
    if name == "packed":
        data["roofline"][5]["tok_s"] *= 1 + 1e-6
    elif name == "chaos":
        data["sweep"][2]["goodput_tok_s"] *= 1 + 1e-6
    elif name == "tp":
        data["ladder"][2]["tok_s"] *= 1 + 1e-6
    elif name == "quant":
        data["restore"][1]["tok_s"] *= 1 + 1e-6
    else:
        data["curves"][1]["ttft_p99_s"] *= 1 + 1e-6
    path = tmp_path / f"perturbed_{name}.json"
    path.write_text(json.dumps(data))
    return str(path)


@pytest.mark.parametrize("name", NAMES)
def test_check_passes_on_file_and_fails_on_perturbed_copy(name, tmp_path,
                                                          capsys):
    mod = MODULES[name]
    mod.main(["--check", DRIFT[name], "--device", "cpu"])
    assert "OK" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exit_:
        mod.main(["--check", _perturb(name, tmp_path), "--device", "cpu"])
    assert exit_.value.code == 1
    out = capsys.readouterr().out
    assert "differs" in out and ("tok_s" in out or "ttft_p99_s" in out)


@pytest.mark.parametrize("name", NAMES)
def test_no_write_option(name, capsys):
    with pytest.raises(SystemExit) as exit_:
        MODULES[name].main(["--write"])
    assert exit_.value.code == 2
    assert not hasattr(MODULES[name], "write")


@pytest.mark.parametrize("name", NAMES)
def test_default_device_is_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MODULES[name].main(["--check", DRIFT[name]])


def test_chaos_sweep_and_ablation_match_file():
    """The sweep (with the chaos invariant asserted at every rate) and the
    ablation, row by row, and the rows' own claims: every faulted rate
    slower than fault-free, the ladder paying for itself."""
    fresh = bench_chaos.payload("cpu")
    gold = _golden("chaos")
    problems = []
    diff_rows("sweep", gold["sweep"], fresh["sweep"], ("rate",), problems)
    diff_rows("ablation", [gold["ablation"]], [fresh["ablation"]],
              ("rate",), problems)
    assert problems == []
    assert [r["rate"] for r in fresh["sweep"]] == list(bench_chaos.RATES)
    assert all(r["lost"] == 0 for r in fresh["sweep"])
    assert all(r["injected_events"] > 0 for r in fresh["sweep"][1:])
    base = fresh["sweep"][0]["goodput_tok_s"]
    assert all(r["goodput_tok_s"] < base for r in fresh["sweep"][1:])
    assert fresh["ablation"]["goodput_ratio"] > 1.0
    assert fresh["ablation"]["max_rung_on"] >= 1


@pytest.fixture(scope="module")
def tp_payload():
    return bench_tp.payload("cpu")


@pytest.fixture(scope="module")
def quant_payload():
    return bench_quant.payload("cpu")


@pytest.mark.parametrize("section", ["ladder", "engine"])
def test_tp_rows_match_file(tp_payload, section):
    problems = []
    diff_rows(section, _golden("tp")[section], tp_payload[section], ("tp",),
              problems)
    assert problems == []
    assert [r["tp"] for r in tp_payload[section]] == list(
        bench_tp.TP_DEGREES)


def test_tp_fallback_and_claims(tp_payload):
    """The repriced fallback equals the file's, and the guardrail's claims
    hold: tokens and bridge bytes equal at every degree, P2P only above
    TP=1, one allreduce per decode step, no fallbacks, lawful tapes."""
    problems = []
    diff_rows("fallback", [_golden("tp")["fallback"]],
              [tp_payload["fallback"]], (), problems)
    assert problems == []
    engine = tp_payload["engine"]
    assert all(e["tokens_identical"] and e["conformant"]
               and e["p2p_fallbacks"] == 0 and e["closure"] >= 0.99
               for e in engine)
    assert len({e["bridge_bytes"] for e in engine}) == 1
    assert [e["p2p_bytes"] > 0 for e in engine] == [False, True, True, True]
    fb = tp_payload["fallback"]
    assert close(fb["p2p_penalty_s"], fb["expected_penalty_s"])


def test_tp_claims_raise_on_a_broken_payload(tp_payload):
    broken = dict(tp_payload, engine=[dict(e) for e in tp_payload["engine"]])
    broken["engine"][2]["tokens_identical"] = False
    with pytest.raises(AssertionError, match="TP=4 token stream"):
        bench_tp.assert_claims(broken)


@pytest.mark.parametrize("section", ["restore", "tokens_identical", "replay",
                                     "loader"])
def test_quant_sections_match_file(quant_payload, section):
    problems = []
    diff_tree(section, _golden("quant")[section], quant_payload[section],
              problems)
    assert problems == []


def test_quant_claims_raise_on_a_broken_payload(quant_payload):
    broken = dict(quant_payload, loader=dict(quant_payload["loader"],
                                             speedup=0.99))
    with pytest.raises(AssertionError, match="int8 load must beat"):
        bench_quant.assert_claims(broken)
