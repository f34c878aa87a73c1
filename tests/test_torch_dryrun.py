"""The port's dry run (``launch/dryrun.py``) against the reference's.

The reference's dry run forces XLA's host device count when it is
imported, so it runs here only in a subprocess (4 forced host devices, a
2x2 mesh with automatic axes), never in this test process.  The port's
runs on a process group of the "fake" backend, opened in each test and
destroyed on its exit.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import (ARCH_IDS, SHAPES, InputShape,  # noqa: E402
                                      get_config, smoke_config)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_production_mesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: one smoke-width cell per family: dense (a train step: autograd and
#: remat), MoE (expert parallel) and an encoder-decoder (cross caches)
SMOKE_CELLS = (("olmo-1b", "train"), ("deepseek-moe-16b", "prefill"),
               ("seamless-m4t-medium", "decode"))
SMOKE_SHAPE = dict(seq_len=64, global_batch=4)
#: flops per device, port against reference: the port counts each aten
#: product its eager ops run, the reference the products of XLA's
#: optimised module, so they differ by a few per cent: olmo-1b's train
#: step counts 6.3% more, mostly the tied embedding's logits products
#: (2.5e7 flops against the module's 1.7e7); seamless's decode 5.7% fewer,
#: all in attention: the port attends context-parallel over its rank's
#: half of the sequence-sharded cache, and the reference's module counts
#: three times the port's attention products a rank (7.4e4 against 2.5e4)
FLOPS_REL = 0.1

_REFERENCE = r"""
import json, os, sys
import repro.launch.dryrun as d
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from jax.sharding import AbstractMesh
from repro.configs.base import ARCH_IDS, SHAPES, InputShape, get_config, smoke_config
from repro.models.layers import set_activation_resolver, set_moe_mesh

class Compiled:
    # the fields analyse() reads, of an empty module: its model counts
    # come from the config alone
    def cost_analysis(self):
        return {}
    def as_text(self):
        return "ENTRY %main.1 () -> f32[] {\n  ROOT %c.1 = f32[] constant(0)\n}\n"
    def memory_analysis(self):
        return None

out = {"model": {}, "smoke": {}}
for multi_pod, shape in ((False, (16, 16)), (True, (2, 16, 16))):
    mesh = AbstractMesh(shape, ("pod", "data", "model")[-len(shape):])
    for arch in ARCH_IDS:
        for name, sh in SHAPES.items():
            rec = d.analyse(Compiled(), None, mesh, get_config(arch), sh)
            out["model"][f"{arch}/{name}/{multi_pod}"] = [
                rec["model_flops_global"], rec["params_total"],
                rec["params_active"], rec["chips"]]
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
for arch, kind in json.loads(sys.argv[1]):
    cfg = smoke_config(get_config(arch))
    shape = InputShape("smoke", SEQ_LEN, GLOBAL_BATCH, kind)
    fn, args = d.build_cell(cfg, shape, mesh)
    try:
        with mesh:
            compiled = jax.jit(fn).lower(*args).compile()
            rec = d.analyse(compiled, None, mesh, cfg, shape)
    finally:
        set_activation_resolver(None)
        set_moe_mesh(None, (), None)
    out["smoke"][f"{arch}/{kind}"] = rec["hlo_flops_per_device"]
print(json.dumps(out))
""".replace("SEQ_LEN", str(SMOKE_SHAPE["seq_len"])).replace(
    "GLOBAL_BATCH", str(SMOKE_SHAPE["global_batch"]))


@pytest.fixture(scope="module")
def reference():
    """The reference's record fields, from a subprocess."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    done = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(SMOKE_CELLS)],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


ZERO = {"flops": 0.0, "bytes_accessed": 0.0, "bytes_accessed_no_copy": 0.0,
        "collectives": {"total_bytes": 0}, "trip_counts": [],
        "marked_bytes": {}, "region_entries": {}}


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod16x16", "pod2x16x16"])
def test_model_counts_match_reference(reference, multi_pod):
    """For every arch x shape: MODEL_FLOPS, the parameter counts and the
    mesh's chips equal the reference's record fields."""
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        for arch in ARCH_IDS:
            for name, sh in SHAPES.items():
                rec = dryrun.analyse(ZERO, mesh, get_config(arch), sh)
                got = [rec["model_flops_global"], rec["params_total"],
                       rec["params_active"], rec["chips"]]
                assert got == reference["model"][
                    f"{arch}/{name}/{multi_pod}"], (arch, name)


@pytest.mark.parametrize("arch,kind", SMOKE_CELLS)
def test_smoke_cell_flops_match_reference(reference, arch, kind):
    """One smoke-width cell per family on a fake 2x2 mesh: it runs, its
    terms are the record's, and its flops per device are within
    ``FLOPS_REL`` of the reference's build_cell + analyse on the same
    cell."""
    from torch.distributed.device_mesh import init_device_mesh
    cfg = smoke_config(get_config(arch))
    shape = InputShape("smoke", SMOKE_SHAPE["seq_len"],
                       SMOKE_SHAPE["global_batch"], kind)
    with fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        rec = dryrun.run_cell_on(mesh, cfg, shape)
    want = reference["smoke"][f"{arch}/{kind}"]
    assert rec["flops_per_device"] == pytest.approx(want, rel=FLOPS_REL)
    assert rec["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert rec["compute_s"] == rec["flops_per_device"] / dryrun.PEAK_FLOPS
    if kind == "train":
        assert rec["trip_counts"] == [cfg.n_layers]
    else:
        assert rec["region_entries"]
    if cfg.n_routed_experts:
        # expert parallel: the experts' combine is an all-reduce
        assert rec["collectives"]["counts"]["all-reduce"] > 0


def test_run_cell_writes_record(tmp_path):
    """``run_cell`` opens and closes its own fake group, writes the record
    under the directory given, and reads it back unless forced; a skip is
    the sub-quadratic one."""
    import torch.distributed as dist
    rec = dryrun.run_cell("olmo-1b", "long_500k", multi_pod=False,
                          out_dir=str(tmp_path))
    assert rec["status"] == "skip" and "sub-quadratic" in rec["skip_reason"]
    assert (tmp_path / "olmo-1b__long_500k__pod16x16.json").exists()
    assert not dist.is_initialized()
    assert dryrun.run_cell("olmo-1b", "long_500k", multi_pod=False,
                           out_dir=str(tmp_path)) == rec


def test_constants_are_the_h100s():
    """The roofline constants are one H100's (SXM, 700 W data sheet)."""
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    assert os.path.normpath(dryrun.OUT_DIR).endswith(
        os.path.join("build", "dryrun"))


def test_roofline_reads_port_records(tmp_path):
    """``bench.roofline`` reads the port's records: rows, summary and the
    multi-pod count."""
    from repro_torch.bench import roofline
    base = {"arch": "olmo-1b", "shape": "train_4k", "status": "ok",
            "dominant": "memory_s", "compute_s": 1.0, "memory_s": 2.0,
            "collective_s": 0.5, "useful_flops_ratio": 0.5,
            "flops_per_device": 1e12,
            "kernel_substitution": {"memory_s": 1.5}}
    for mesh in ("pod16x16", "pod2x16x16"):
        with open(tmp_path / f"olmo-1b__train_4k__{mesh}.json", "w") as f:
            json.dump(dict(base, mesh=mesh), f)
    lines = roofline.run(records=str(tmp_path))
    assert lines[0].startswith("roofline/olmo-1b/train_4k/memory_s,2.0000")
    assert "roofline/summary,1" in lines[1]
    assert lines[2].startswith("roofline/multipod_cells,1")
    checks = roofline.sweep_checks(str(tmp_path))
    assert checks["pod16x16"]["ok"] == 1 and not checks["pod16x16"][
        "bad_useful"]
    assert checks["multi_pod_above_single"] == []
