"""Find what ``BENCHMARK.json`` names: a cell's configuration, mix and
limits, and the readers of the metrics it reports."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(name: str) -> dict:
    return json.loads((HERE / "mixes" / f"{name}.json").read_text())


def limits(cell: str) -> dict:
    """``{number: {"limit": x, "lower": ..., "upper": ..., ...}}`` of the
    cell's correctness check; a number whose limit is null is recorded
    with its readings and not compared."""
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())


def metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones
    (``trace`` False) or the per-layer ones, each kept where its
    ``workloads`` key, if any, lists the cell."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    """``metrics/<name>.py``'s ``read``: run records -> number or None.
    A name with no file of its own is read as the name without its last
    dotted part (``model.mfu.hostpaced`` by ``model.mfu``): one quantity
    split over cells that report different end-to-end metrics."""
    path = HERE / "metrics" / f"{name}.py"
    while not path.exists() and "." in name:
        name = name.rsplit(".", 1)[0]
        path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
