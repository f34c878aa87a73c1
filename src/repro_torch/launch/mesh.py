"""Production mesh construction + the fabric partition vocabulary.

PyTorch counterpart of ``repro.launch.mesh``: the meshes are
``torch.distributed.device_mesh.DeviceMesh`` objects over the ranks of the
default process group.  Every function here is called, never run at
import, so importing this module opens no process group.

Mesh axes:
  single-pod: (16, 16)        ("data", "model")   — 256 ranks
  multi-pod : (2, 16, 16)     ("pod", "data", "model") — 512 ranks, DP across pods

The reference gets its 512 placeholder devices by forcing XLA's host
platform device count before JAX starts.  The port's counterpart is a
process group of PyTorch's ``"fake"`` backend (``fake_world``): one
process stands for every rank, collectives return at once, and DTensors
over meta tensors carry shapes and placements only (the dry run).

The fabric partition vocabulary (§7 analogue) exposes mesh sub-blocks as
the confidential tenant shapes a scheduler may allocate (``core/fabric.py``
enforces the vocabulary; here shapes map onto the mesh grid).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.fabric import PARTITION_VOCABULARY

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of the ``"fake"`` backend with
    ``world_size`` ranks, this process rank 0, destroyed on exit.  An open
    default group of that size is used as it is and left open."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is open; the fake world needs "
                               f"{world_size}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    """The (16, 16) or (2, 16, 16) mesh over the default group's ranks
    (open one with ``fake_world(256 | 512)`` for the dry run)."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def flat_data_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """``mesh`` with its data axes ("pod", "data") flattened into one
    "data" dim over the same ranks in the same order: (2, 16, 16) ->
    (32, 16).  DTensor keeps a dim sharded by two mesh axes only through
    views that split it (``_StridedShard``), which newer torch plans with
    an exponential search and older torch places inconsistently; one
    flattened axis shards the batch the same 32 ways."""
    names = mesh.mesh_dim_names
    if names[:-1] == ("data",) or len(names) < 3:
        return mesh
    shape = dict(zip(names, mesh.shape))
    data = math.prod(shape[a] for a in data_axis_names(mesh))
    return DeviceMesh(mesh.device_type,
                      mesh.mesh.reshape(data, shape["model"]),
                      mesh_dim_names=("data", "model"))


def make_host_mesh(device_type: str = None) -> DeviceMesh:
    """Degenerate (1, n) mesh over the ranks that exist (n = the default
    group's world size; one rank without a group is opened by the caller).
    ``device_type`` defaults to "cuda" under an NCCL group, else "cpu"."""
    n = dist.get_world_size()
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (1, n),
                            mesh_dim_names=("data", "model"))


def mesh_shape(mesh: DeviceMesh) -> dict:
    """{axis name: size}, in mesh-dim order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axis_names(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def mesh_chip_count(mesh: DeviceMesh) -> int:
    return int(math.prod(mesh.shape))


def tenant_submesh(mesh: DeviceMesh, size: int) -> DeviceMesh:
    """Carve a fabric-valid tenant partition (1/2/4/8 ranks) from the mesh
    grid — the §7 scheduling object on the fabric: the first ``size``
    ranks of the flattened grid as a (1, size) ("data", "model") mesh."""
    if size not in PARTITION_VOCABULARY:
        raise ValueError(f"tenant shape {size} not in {PARTITION_VOCABULARY}")
    flat = mesh.mesh.reshape(-1)[:size]
    return DeviceMesh(mesh.device_type, flat.reshape(1, size).to(torch.int),
                      mesh_dim_names=("data", "model"))
