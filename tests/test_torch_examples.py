"""The port's examples (``repro_torch.examples``) against the reference's
scripts (``examples/*.py``).

Each reference script runs once in a subprocess (``JAX_PLATFORMS=cpu``;
quickstart and loader_and_offload do their work at import); the port's
``main(["--device", "cpu"])`` runs in this process.  Their printed lines
are equal, and so is every number in them.  Importing every module of
``repro_torch.examples`` does no work.  serve_cc_policies and train_lm
have files of their own.
"""

import importlib
import io
import os
import pkgutil
import re
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")

#: (example, its arguments), each run by both packages
CASES = {
    "quickstart": [],
    "serve_cluster": [],
    "serve_cluster --replicas 3 --requests 6 --cc-off":
        ["--replicas", "3", "--requests", "6", "--cc-off"],
    "loader_and_offload": [],
}


def reference_stdout(script: str, args: list) -> str:
    """The reference's ``examples/<script>.py`` output, run on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    done = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", f"{script}.py"),
         *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    return done.stdout


def port_stdout(script: str, args: list) -> str:
    mod = importlib.import_module(f"repro_torch.examples.{script}")
    out = io.StringIO()
    with redirect_stdout(out):
        mod.main(args + ["--device", "cpu"])
    return out.getvalue()


def check_same_output(got: str, want: str) -> None:
    """Equal lines, and every number in them parsed and equal."""
    assert [float(x) for x in NUMBER.findall(got)] == [
        float(x) for x in NUMBER.findall(want)]
    assert got.splitlines() == want.splitlines()


@pytest.fixture(scope="module")
def reference():
    return {case: reference_stdout(case.split()[0], args)
            for case, args in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_output_equals_reference(reference, case):
    got = port_stdout(case.split()[0], CASES[case])
    check_same_output(got, reference[case])


def test_quickstart_engine_lines_name_both_policies(reference):
    lines = [ln for ln in reference["quickstart"].splitlines()
             if ln.strip().startswith("policy=")]
    assert [ln.split()[0] for ln in lines] == ["policy=async", "policy=sync"]


def test_importing_examples_does_no_work(capsys):
    """Every module of the package imports without printing, serving or
    touching a device (the reference's quickstart and loader_and_offload
    do their work at import)."""
    import repro_torch.examples as pkg
    names = [m.name for m in pkgutil.iter_modules(pkg.__path__)]
    assert sorted(names) == ["loader_and_offload", "quickstart",
                             "serve_cc_policies", "serve_cluster", "train_lm"]
    for name in names:
        sys.modules.pop(f"repro_torch.examples.{name}", None)
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        assert callable(mod.main)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("script", ["quickstart", "serve_cluster",
                                    "loader_and_offload", "serve_cc_policies",
                                    "train_lm"])
def test_examples_default_to_the_card(monkeypatch, script, tmp_path):
    """Without ``--device`` each example asks for the card, and raises
    when there is none."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.examples.{script}")
    argv = ["--ckpt-dir", str(tmp_path)] if script == "train_lm" else []
    with pytest.raises(RuntimeError, match="CUDA"), \
            redirect_stdout(io.StringIO()):
        mod.main(argv)
