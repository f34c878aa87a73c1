"""What the benchmark's run loads: never JAX or the JAX package, and the
reference nothing of the port either.  Each check runs in a fresh
process, since the test process itself holds whatever other tests
imported."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

RUN = """
import json, sys, time
sys.path[:0] = [{src!r}, {root!r}]
import portbench.run as run
from portbench import spec, serve, calibrate
from portbench.tests import smoke
bench = spec.load_benchmark()
for m in bench["end_to_end"] + bench["per_layer"]:
    spec.reader(m["name"])
for name in ("nemotron-4-340b-l4", "deepseek-moe-16b"):
    serve.run_cell(smoke.config(name), smoke.mix("paper-1k1k-c64"), 3, 0.5,
                   trace=True, device="cpu", t0=time.time(),
                   limits={{"mean_gap": {{"limit": 1.0}}}})
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
import portbench.check, portbench.reference.dense, portbench.reference.moe
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str) -> set:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", code.format(src=str(ROOT / "src"),
                                           root=str(ROOT))],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_a_run_loads_no_jax():
    pytest.importorskip("torch")
    top = _modules(RUN)
    assert "repro_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_port():
    pytest.importorskip("torch")
    top = _modules(REFERENCE)
    assert not top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_the_run_checks_what_is_loaded(monkeypatch):
    from portbench import run
    before = set(run.forbidden_modules())      # what other tests loaded
    monkeypatch.setitem(sys.modules, "jaxlib.portbench_probe", object())
    monkeypatch.setitem(sys.modules, "repro.portbench_probe", object())
    monkeypatch.setitem(sys.modules, "repro_torch_portbench_probe", object())
    assert set(run.forbidden_modules()) - before == {
        "jaxlib.portbench_probe", "repro.portbench_probe"}


def test_a_mix_can_pin_the_run_to_few_cores():
    code = (f"import os, sys; sys.path[:0] = [{str(ROOT)!r}]\n"
            "from portbench.run import pin_cores\n"
            "before = sorted(os.sched_getaffinity(0))\n"
            "pin_cores(None)\n"
            "assert sorted(os.sched_getaffinity(0)) == before\n"
            "pin_cores(1)\n"
            "print(sorted(os.sched_getaffinity(0)) == before[-1:])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "True"
