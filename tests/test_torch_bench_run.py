"""The port's benchmark runner (``repro_torch.bench.run``) against the
reference's (``benchmarks/run.py``), and ``reference_rows.json``.

The runner prints the reference's CSV under the reference's titles,
writes the same ``--json`` document, exits 1 when a module raises and
resolves ``--device`` to the card.  ``reference_rows.json`` holds the rows
the reference's eight paper benches print on the CPU: this file holds its
layout, its exemptions and the five analytic benches' rows to a fresh run
of the reference; the engine benches' rows are held to theirs in
``test_torch_bench_{replay,cluster,bridge_opt}.py``, which run the
reference anyway.

Regenerate the file (about two minutes on the CPU):

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_bench_run.py
"""

import importlib
import io
import json
import os
import re
import sys
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch import bench as TB  # noqa: E402
from repro_torch.bench import run as TR  # noqa: E402

ANALYTIC = ("bridge", "serving", "loader", "offload", "fabric")


def reference_lines(module: str) -> list[str]:
    """The lines the reference's ``benchmarks/bench_<module>.py`` prints."""
    return importlib.import_module(f"benchmarks.bench_{module}").run()


def reference_document(lines_by_module: dict) -> dict:
    """``reference_rows.json``'s content from the reference's lines."""
    return {
        "about": "rows of the reference's paper benches "
                 "(benchmarks/bench_<module>.py run()) on the CPU; exempt "
                 "fields are host wall time and stored as null",
        "exempt": {k: list(v) for k, v in TB.EXEMPT.items()},
        "rows": {m: [TB.parse_row(line) for line in lines_by_module[m]]
                 for m in TB.PAPER_BENCHES},
    }


def check_reference_section(module: str, lines: list) -> None:
    """``reference_rows.json``'s rows of ``module`` equal a fresh run of the
    reference (``lines``), exempt fields null in the file."""
    stored = TB.load(TB.REFERENCE_ROWS)["rows"][module]
    assert stored == [TB.parse_row(line) for line in lines]


def row_names(module: str) -> list[str]:
    """The row names of ``module`` in ``reference_rows.json`` (the engine
    benches' files parametrize over them)."""
    return [r["name"] for r in TB.load(TB.REFERENCE_ROWS)["rows"][module]]


def check_row(name: str, got_lines: list, want_lines: list) -> None:
    """Row ``name`` of the port's lines equals the reference's: value within
    ``REL_TOL``, derived text equal, exempt fields skipped; the names of
    all rows equal and in order."""
    got = [TB.parse_row(line) for line in got_lines]
    want = [TB.parse_row(line) for line in want_lines]
    assert [r["name"] for r in got] == [r["name"] for r in want]
    g = next(r for r in got if r["name"] == name)
    w = next(r for r in want if r["name"] == name)
    if w["value"] is not None:
        assert TB.close(g["value"], w["value"]), (g, w)
    assert g["derived"] == w["derived"]


@pytest.fixture(scope="module")
def reference_analytic():
    return {m: reference_lines(m) for m in ANALYTIC}


def test_reference_rows_file_layout():
    """The file has the eight paper benches in ``bench.run``'s order and
    names exactly the exempt host-wall items."""
    doc = TB.load(TB.REFERENCE_ROWS)
    assert list(doc["rows"]) == list(TB.PAPER_BENCHES)
    assert doc["exempt"] == {
        "replay/counterfactuals_per_engine_run": ["value", "derived"],
        "meta/*_wall_s": ["value"]}
    assert [n for _, n in TR.MODULES if n in TB.PAPER_BENCHES] == list(
        TB.PAPER_BENCHES)
    nulls = [(m, r["name"], k) for m, rows in doc["rows"].items()
             for r in rows for k in ("value", "derived") if r[k] is None]
    assert nulls == [("replay", "replay/counterfactuals_per_engine_run", k)
                     for k in ("value", "derived")]


@pytest.mark.parametrize("module", ANALYTIC)
def test_reference_rows_equal_fresh_reference(reference_analytic, module):
    check_reference_section(module, reference_analytic[module])


@pytest.mark.parametrize("module", ANALYTIC)
def test_reference_diff_accepts_reference_and_names_differences(
        reference_analytic, module):
    """``reference_diff`` passes the reference's own lines and names a
    changed value, a changed derived string and a missing row."""
    lines = reference_analytic[module]
    assert TB.reference_diff(module, lines) == []
    name, value, derived = lines[0].split(",", 2)
    moved = f"{name},{float(value) * (1 + 1e-6) + 1e-6},{derived}"
    assert any("value" in p for p in
               TB.reference_diff(module, [moved] + lines[1:]))
    assert any("derived" in p for p in TB.reference_diff(
        module, [f"{name},{value},{derived}!"] + lines[1:]))
    assert "row names" in TB.reference_diff(module, lines[1:])[0]


def test_exempt_row_is_not_compared():
    """replay's host-wall row may take any value and text."""
    lines = ["replay/x,1.0,a",
             "replay/counterfactuals_per_engine_run,1.5,record=0.01s, 7 "
             "repricings in 1.0ms: repricing >> re-running"]
    rows = [TB.parse_row(line) for line in lines]
    assert rows[1]["value"] is None and rows[1]["derived"] is None
    assert rows[0] == {"name": "replay/x", "value": 1.0, "derived": "a"}
    assert TB.parse_row("meta/bridge_wall_s,2.5,module wall time (ok)") == {
        "name": "meta/bridge_wall_s", "value": None,
        "derived": "module wall time (ok)"}


def _run(argv) -> tuple[str, int]:
    out = io.StringIO()
    code = 0
    with redirect_stdout(out):
        try:
            TR.main(argv)
        except SystemExit as e:
            code = e.code
    return out.getvalue(), code


def _reference_run(monkeypatch, argv) -> tuple[str, int]:
    from benchmarks import run as JR
    monkeypatch.setattr(sys, "argv", ["run"] + argv)
    out = io.StringIO()
    code = 0
    with redirect_stdout(out):
        try:
            JR.main()
        except SystemExit as e:
            code = e.code
    return out.getvalue(), code


@pytest.mark.parametrize("only", ["SS4.1", "SS5.1", "SS6.1", "SS6.2", "SS7)"])
def test_only_csv_and_json_shaped_as_the_reference(tmp_path, monkeypatch,
                                                    only):
    """``--only`` on an analytic module: the same CSV lines (bar the wall
    time comment) and a ``--json`` document with the reference's keys and
    rows (wall times apart)."""
    got, code = _run(["--only", only, "--json", str(tmp_path / "t.json"),
                      "--device", "cpu"])
    want, jcode = _reference_run(
        monkeypatch, ["--only", only, "--json", str(tmp_path / "j.json")])
    assert code == jcode == 0

    def body(text):
        return [ln for ln in text.splitlines()
                if not re.fullmatch(r"# .*: [0-9.]+s", ln)
                and "wrote" not in ln]
    assert body(got) == body(want)
    t = json.load(open(tmp_path / "t.json"))
    j = json.load(open(tmp_path / "j.json"))
    assert list(t) == list(j) == ["rows", "modules", "module_wall_s",
                                  "failures"]
    assert t["modules"] == j["modules"] and t["failures"] == 0
    assert list(t["module_wall_s"]) == list(j["module_wall_s"])
    strip = [(r["name"], None if r["name"].startswith("meta/") else
              r["value"], r["derived"]) for r in t["rows"]]
    assert strip == [(r["name"], None if r["name"].startswith("meta/") else
                      r["value"], r["derived"]) for r in j["rows"]]


def test_fourteen_titles_in_the_reference_s_order(monkeypatch):
    """With every module's rows stubbed empty, both runners print the same
    fourteen section titles in the same order."""
    for name in ("bridge", "serving", "loader", "offload", "fabric",
                 "roofline", "cluster", "replay", "bridge_opt", "obs",
                 "packed", "chaos", "tp", "quant"):
        ref = importlib.import_module(f"benchmarks.bench_{name}")
        monkeypatch.setattr(ref, "run", lambda: [])
        port = importlib.import_module(f"repro_torch.bench.{name}")
        attr = "rows" if name in TR.DRIFT else "run"
        monkeypatch.setattr(port, attr, lambda *a: [])
    got, code = _run(["--device", "cpu"])
    want, jcode = _reference_run(monkeypatch, [])
    assert code == jcode == 0

    def titles(text):
        return [ln for ln in text.splitlines() if ln.startswith("# --- ")]
    assert len(titles(got)) == 14
    assert titles(got) == titles(want)


def test_exit_1_when_a_module_raises(monkeypatch):
    from repro_torch.bench import fabric

    def boom():
        raise RuntimeError("boom")
    monkeypatch.setattr(fabric, "run", boom)
    out, code = _run(["--only", "fabric", "--device", "cpu"])
    assert code == 1
    assert "# fabric (SS7): " in out


def test_json_records_the_failure(tmp_path, monkeypatch):
    from repro_torch.bench import loader

    def boom():
        raise RuntimeError("boom")
    monkeypatch.setattr(loader, "run", boom)
    _, code = _run(["--only", "SS6", "--json", str(tmp_path / "f.json"),
                    "--device", "cpu"])
    doc = json.load(open(tmp_path / "f.json"))
    assert code == 1 and doc["failures"] == 1
    assert doc["modules"] == {"loader (SS6.1)": "error",
                              "offload (SS6.2)": "ok"}
    assert [r["name"] for r in doc["rows"]][-2:] == [
        "offload/6.2/reuse_aware_ttft_speedup_x", "meta/offload_wall_s"]


def test_device_defaults_to_the_card(monkeypatch):
    """Without ``--device`` the runner asks for the card; with none it
    raises before running anything."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _run(["--only", "bridge"])


@pytest.mark.parametrize("module", ["offload", "replay", "cluster",
                                    "bridge_opt"])
def test_serving_benches_default_to_the_card(monkeypatch, module):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.bench.{module}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.run()


if __name__ == "__main__":
    doc = reference_document({m: reference_lines(m)
                              for m in TB.PAPER_BENCHES})
    with open(TB.REFERENCE_ROWS, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"wrote {sum(len(r) for r in doc['rows'].values())} rows to "
          f"{TB.REFERENCE_ROWS}")
