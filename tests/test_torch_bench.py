"""The port's drift checks against ``BENCH_packed.json``, ``BENCH_obs.json``
and ``BENCH_chaos.json``.

On the CPU, ``repro_torch.bench.packed``'s roofline rows and engine rows,
``repro_torch.bench.obs``'s capacity and load curves and
``repro_torch.bench.chaos``'s fault-rate sweep and ladder ablation equal
the files the reference's benchmarks wrote, within ``REL_TOL`` (1e-9);
``--check`` passes on the files and exits 1 on a perturbed copy; no module
can write a drift file; the default device is the card, with no quiet CPU
run.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.bench import REL_TOL, close, diff_rows
from repro_torch.bench import chaos as bench_chaos
from repro_torch.bench import obs as bench_obs
from repro_torch.bench import packed as bench_packed

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIFT = {"packed": os.path.join(ROOT, "BENCH_packed.json"),
         "obs": os.path.join(ROOT, "BENCH_obs.json"),
         "chaos": os.path.join(ROOT, "BENCH_chaos.json")}
MODULES = {"packed": bench_packed, "obs": bench_obs, "chaos": bench_chaos}


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
    else:
        data["curves"][1]["ttft_p99_s"] *= 1 + 1e-6
    path = tmp_path / f"perturbed_{name}.json"
    path.write_text(json.dumps(data))
    return str(path)


@pytest.mark.parametrize("name", ["packed", "obs", "chaos"])
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


@pytest.mark.parametrize("name", ["packed", "obs", "chaos"])
def test_no_write_option(name, capsys):
    with pytest.raises(SystemExit) as exit_:
        MODULES[name].main(["--write"])
    assert exit_.value.code == 2
    assert not hasattr(MODULES[name], "write")


@pytest.mark.parametrize("name", ["packed", "obs", "chaos"])
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
