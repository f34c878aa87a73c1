"""Elastic reshard and expert-parallel MoE on real process groups (gloo,
spawned ranks) against the JAX reference.

- A smoke olmo-1b checkpoint written by the port is resharded onto 2x2
  and 1x4 meshes of 4 ranks: each rank's local shard has the shape of the
  reference's ``NamedSharding(AbstractMesh, spec).shard_shape``, and each
  ``full_tensor()`` is bit-equal to the leaf saved.
- The port's expert-parallel ``moe_block`` on 2 ranks equals the
  reference's on 2 forced host devices (a subprocess), and the port's
  single-device block where no token is dropped.

Every group lives in the spawned ranks and dies with them.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs.base import get_config, smoke_config  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
STEP = 3
#: port EP vs the reference's EP output (both bf16 expert products with
#: f32 sums, the reference's XLA-compiled): largest difference allowed,
#: relative to the output's largest magnitude
EP_REL = 2e-2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _paths(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _paths(v, f"{path}/{i}")]
    return [(path, tree)]


def _reshard_worker(rank, world, port, ckpt_dir, out_dir):
    from repro_torch.launch.elastic import parse_mesh, reshard
    from repro_torch.models.model import abstract_params
    from repro_torch.training import checkpoint as ckpt
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        cfg = smoke_config(get_config("olmo-1b"))
        params, _ = abstract_params(cfg)
        # the saved state, whole, on the CPU (templates of plain tensors)
        cpu = lambda t: torch.empty(t.shape, dtype=t.dtype)  # noqa: E731
        from repro_torch.training.optimizer import tree_map
        templ = tree_map(cpu, params)
        f32 = tree_map(lambda t: torch.empty(t.shape), params)
        saved_p, saved_o, _ = ckpt.restore(
            ckpt_dir, STEP, templ, {"mu": f32, "nu": tree_map(cpu, f32),
                                    "step": torch.empty((), dtype=torch.int32)})
        saved = dict(_paths({"params": saved_p, "mu": saved_o["mu"],
                             "nu": saved_o["nu"]}))
        report = {}
        for name in MESHES:
            mesh = parse_mesh(name)
            out = reshard(ckpt_dir, "olmo-1b", mesh, cfg=cfg)
            got = dict(_paths({"params": out["params"],
                               "mu": out["opt"]["mu"],
                               "nu": out["opt"]["nu"]}))
            assert set(got) == set(saved)
            shapes, equal = {}, {}
            for key, t in got.items():
                shapes[key] = list(t.to_local().shape)
                full = t.full_tensor()
                want = saved[key]
                equal[key] = bool(full.dtype == want.dtype and torch.equal(
                    full.view(torch.int16) if full.dtype == torch.bfloat16
                    else full, want.view(torch.int16)
                    if want.dtype == torch.bfloat16 else want))
            report[name] = {"shapes": shapes, "equal": equal,
                            "step": out["step"],
                            "opt_step": int(out["opt"]["step"].full_tensor())}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def _reference_shard_shapes(cfg_name: str) -> dict:
    """Each leaf's local shard shape on each mesh, by the reference's rules
    (``NamedSharding(AbstractMesh, spec).shard_shape``); mu and nu as their
    parameters."""
    import jax
    from jax.sharding import AbstractMesh, NamedSharding
    from repro.configs.base import get_config as jget, smoke_config as jsmoke
    from repro.models.model import init_params
    from repro.models.shardings import ShardingRules
    cfg = jsmoke(jget(cfg_name))
    abstract = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
    leaves = [(p, leaf) for p, leaf in _paths(abstract)]
    out = {}
    for name, shape in MESHES.items():
        mesh = AbstractMesh(shape, ("data", "model"))
        rules = ShardingRules(cfg, mesh)
        shapes = {}
        for path, leaf in leaves:
            spec = rules.param_spec(leaf.axes, leaf.value.shape)
            local = list(NamedSharding(mesh, spec).shard_shape(
                leaf.value.shape))
            for root in ("params", "mu", "nu"):
                shapes[f"/{root}{path}"] = local
        out[name] = shapes
    return out


@pytest.fixture(scope="module")
def smoke_checkpoint(tmp_path_factory):
    from repro_torch.models.model import init_params
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import init_train_state
    cfg = smoke_config(get_config("olmo-1b"))
    params = init_params(cfg, torch.Generator().manual_seed(0))
    state = init_train_state(params, AdamWConfig())
    gen = torch.Generator().manual_seed(1)
    for t in _paths(state["mu"]) + _paths(state["nu"]):
        t[1].copy_(torch.randn(t[1].shape, generator=gen))
    state["step"] = torch.tensor(STEP, dtype=torch.int32)
    d = tmp_path_factory.mktemp("elastic_ckpt")
    ckpt.save(str(d), params, state, STEP, async_commit=False)
    return str(d)


def test_reshard_matches_reference_layout(smoke_checkpoint, tmp_path):
    """On 4 gloo ranks, onto 2x2 and 1x4: every local shard has the
    reference's shard shape and every full tensor is the saved leaf, bit
    for bit (parameters, mu and nu; the step too)."""
    want = _reference_shard_shapes("olmo-1b")
    port = _free_port()
    mp.start_processes(_reshard_worker, args=(4, port, smoke_checkpoint,
                                              str(tmp_path)),
                       nprocs=4, join=True, start_method="spawn")
    for rank in range(4):
        with open(tmp_path / f"rank{rank}.json") as f:
            report = json.load(f)
        for name in MESHES:
            got = report[name]
            assert got["step"] == STEP and got["opt_step"] == STEP
            assert all(got["equal"].values()), [
                k for k, v in got["equal"].items() if not v]
            assert got["shapes"] == want[name], name


def test_cli_on_one_rank(smoke_checkpoint, monkeypatch, capsys):
    """``python -m repro_torch.launch.elastic --to-mesh 1x1 --device cpu``
    (the smoke config in the registry's place): one gloo rank, opened and
    destroyed by the CLI, the reference's summary line."""
    from repro_torch.launch import elastic
    monkeypatch.setattr(elastic, "get_config",
                        lambda arch: smoke_config(get_config(arch)))
    elastic.main(["--ckpt-dir", smoke_checkpoint, "--arch", "olmo-1b",
                  "--to-mesh", "1x1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith(f"resharded step {STEP} (0.4M params) onto "
                          f"{{'data': 1, 'model': 1}}")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------------
# Expert-parallel MoE
# ---------------------------------------------------------------------------------

def _moe_inputs():
    """Smoke deepseek-moe-16b's MoE block: weights from the port's init
    (seed 0) and x (2, 16, d) from numpy, all as numpy arrays."""
    from repro_torch.models.layers import init_moe
    cfg = smoke_config(get_config("deepseek-moe-16b"))
    with torch.no_grad():
        p = init_moe(torch.Generator().manual_seed(0), cfg)
    arrays = {k: v.float().numpy() for k, v in _paths(p)}
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 16, cfg.d_model)) * 0.5).astype(np.float32)
    return cfg, p, arrays, x


def _ep_worker(rank, world, port, out_dir, no_drop):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import layers
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        cfg, p, _, x = _moe_inputs()
        mesh = init_device_mesh("cpu", (1, world),
                                mesh_dim_names=("data", "model"))
        rep = [Replicate(), Replicate()]

        def place(t, experts):
            if not experts:
                return DTensor.from_local(t, mesh, rep, run_check=False)
            n = t.shape[0] // world
            return DTensor.from_local(t[rank * n:(rank + 1) * n].contiguous(),
                                      mesh, [Replicate(), Shard(0)],
                                      run_check=False)
        dp = {k: place(v, k in ("wi", "wg", "wo")) for k, v in p.items()
              if k != "shared"}
        if "shared" in p:
            dp["shared"] = {k: place(v, False) for k, v in p["shared"].items()}
        xt = DTensor.from_local(torch.from_numpy(x).to(cfg.dtype), mesh, rep,
                                run_check=False)
        layers.set_moe_mesh(mesh, ("data",), "model")
        try:
            with torch.no_grad(), implicit_replication():
                y, _ = layers.moe_block(dp, xt, cfg, no_drop=no_drop)
        finally:
            layers.set_moe_mesh(None, (), None)
        np.save(os.path.join(out_dir, f"ep{rank}.npy"),
                y.full_tensor().float().numpy())
    finally:
        dist.destroy_process_group()


_REFERENCE_EP = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_config, smoke_config
from repro.models import layers
from repro.models.layers import Param
d = np.load(sys.argv[1])
cfg = smoke_config(get_config("deepseek-moe-16b"))
bf = lambda k, axes: Param(jnp.asarray(d[k]).astype(
    jnp.float32 if k == "/router" else cfg.dtype), axes)
p = {"router": bf("/router", ("embed", "expert")),
     "wi": bf("/wi", ("expert", "embed", "mlp")),
     "wg": bf("/wg", ("expert", "embed", "mlp")),
     "wo": bf("/wo", ("expert", "mlp", "embed"))}
if "/shared/wi" in d:
    p["shared"] = {k: bf(f"/shared/{k}", ("embed", "mlp") if k != "wo"
                         else ("mlp", "embed")) for k in ("wi", "wg", "wo")}
x = jnp.asarray(d["x"]).astype(cfg.dtype)
mesh = jax.make_mesh((1, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
layers.set_moe_mesh(mesh, ("data",), "model")
with mesh:
    y, _ = jax.jit(lambda p, x: layers.moe_block(p, x, cfg))(p, x)
np.save(sys.argv[2], np.asarray(y.astype(jnp.float32)))
"""


def test_expert_parallel_moe(tmp_path):
    """The port's EP ``moe_block`` on 2 gloo ranks (experts ``Shard(0)``
    on "model", an all-reduce combining them) against the reference's EP
    block on 2 forced host devices (within ``EP_REL`` of the output's
    scale), and, with ``no_drop`` (no token dropped), bit-equal to the
    port's single-device block: with top-2 routing over two ranks each
    output sums the same two f32 products in the same order."""
    from repro_torch.models import layers
    cfg, p, arrays, x = _moe_inputs()
    np.savez(tmp_path / "moe.npz", x=x, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    done = subprocess.run(
        [sys.executable, "-c", _REFERENCE_EP, str(tmp_path / "moe.npz"),
         str(tmp_path / "ref.npy")], env=env, capture_output=True,
        text=True, timeout=300, cwd=ROOT)
    assert done.returncode == 0, done.stderr[-3000:]
    ref = np.load(tmp_path / "ref.npy")

    for no_drop in (False, True):
        out = tmp_path / f"nodrop{int(no_drop)}"
        out.mkdir()
        mp.start_processes(_ep_worker, args=(2, _free_port(), str(out),
                                             no_drop),
                           nprocs=2, join=True, start_method="spawn")
        ranks = [np.load(out / f"ep{r}.npy") for r in range(2)]
        assert np.array_equal(ranks[0], ranks[1])
        if not no_drop:
            scale = np.abs(ref).max()
            assert np.abs(ranks[0] - ref).max() <= EP_REL * scale
        else:
            with torch.no_grad():
                single, _ = layers.moe_block(
                    p, torch.from_numpy(x).to(cfg.dtype), cfg, no_drop=True)
            assert np.array_equal(ranks[0], single.float().numpy())
