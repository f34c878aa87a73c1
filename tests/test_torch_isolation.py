"""The port stands alone: it imports neither JAX nor the reference package.

A subprocess imports every module of ``repro_torch`` and ``chip_smoke``
(whose work runs only under ``__main__``) and then finds no ``jax*``, no
``ml_dtypes`` and no ``repro`` / ``repro.*`` module loaded; a static scan
of the sources finds no such import either, and none of ``ml_dtypes`` in
the loader, which reads bf16 checkpoints as uint16 bits.
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
             or m == "repro" or m.startswith("repro.")
             or m == "ml_dtypes" or m.startswith("ml_dtypes."))
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
    for name in ("repro_torch.kernels.mlstm_scan.ops",
                 "repro_torch.kernels.mlstm_scan.ref",
                 "repro_torch.models.ssm", "repro_torch.configs.xlstm_1p3b",
                 "repro_torch.quant.codecs",
                 "repro_torch.kernels.dequant.ops",
                 "repro_torch.kernels.dequant.ref",
                 "repro_torch.bridge_opt.arena",
                 "repro_torch.bridge_opt.coalescer",
                 "repro_torch.bridge_opt.restore",
                 "repro_torch.serving.offload",
                 "repro_torch.core.simulator", "repro_torch.bench",
                 "repro_torch.bench.packed", "repro_torch.bench.obs",
                 "repro_torch.configs.qwen1p5_4b",
                 "repro_torch.configs.qwen3_32b",
                 "repro_torch.configs.nemotron_4_340b",
                 "repro_torch.configs.deepseek_moe_16b",
                 "repro_torch.configs.deepseek_v2_lite_16b",
                 "repro_torch.configs.hymba_1p5b",
                 "repro_torch.configs.internvl2_76b",
                 "repro_torch.configs.seamless_m4t_medium",
                 "repro_torch.resilience", "repro_torch.resilience.retry",
                 "repro_torch.resilience.degrade",
                 "repro_torch.resilience.faults",
                 "repro_torch.obs.stalls", "repro_torch.obs.timeline",
                 "repro_torch.cluster", "repro_torch.cluster.budget",
                 "repro_torch.cluster.tenant_manager",
                 "repro_torch.cluster.replica",
                 "repro_torch.cluster.autoscaler",
                 "repro_torch.cluster.router", "repro_torch.bench.chaos",
                 "repro_torch.loader", "repro_torch.loader.sharded_weights",
                 "repro_torch.loader.pooled_loader",
                 "repro_torch.bench.tp", "repro_torch.bench.quant",
                 "repro_torch.models.frontends", "repro_torch.data",
                 "repro_torch.data.pipeline", "repro_torch.training",
                 "repro_torch.training.optimizer",
                 "repro_torch.training.train_loop",
                 "repro_torch.training.checkpoint",
                 "repro_torch.launch.train"):
        assert name in result["modules"]
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


LOADER_IMPORT_RE = re.compile(
    r"^\s*(import|from)\s+(jax|ml_dtypes|repro)(\.(?!_)|\s|$)",
    re.MULTILINE)


@pytest.mark.parametrize("name", ["loader/__init__.py",
                                  "loader/sharded_weights.py",
                                  "loader/pooled_loader.py",
                                  "training/checkpoint.py", "convert.py"],
                         ids=["__init__.py", "sharded_weights.py",
                              "pooled_loader.py", "checkpoint.py",
                              "convert.py"])
def test_loader_reads_bf16_without_ml_dtypes(name):
    """The loader and the training checkpoints name bf16 "bfloat16" as the
    reference does but read and write its bits as uint16, and ``convert``
    moves them as uint16 too: no ``jax``, ``ml_dtypes`` or ``repro.``
    import in these modules."""
    with open(os.path.join(PKG, name)) as f:
        text = f.read()
    assert LOADER_IMPORT_RE.findall(text) == []
