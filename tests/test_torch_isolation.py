"""The port stands alone: it imports neither JAX nor the reference package.

A subprocess imports every module of ``repro_torch`` and ``chip_smoke``
(whose work runs only under ``__main__``) and then finds no ``jax*`` and no
``repro`` / ``repro.*`` module loaded; a static scan of the sources finds
no such import either.
"""

import json
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_import_everything_loads_no_jax_and_no_reference():
    code = """
import json, pkgutil, sys, importlib
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": mods, "bad": bad}))
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.serving.engine" in result["modules"]
    assert "repro_torch.kernels.paged_attention.ops" in result["modules"]
    assert result["bad"] == []


IMPORT_RE = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)(\.|\s)(?!_torch))",
    re.MULTILINE)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import_in_source(path):
    with open(path) as f:
        text = f.read()
    assert IMPORT_RE.findall(text) == []
