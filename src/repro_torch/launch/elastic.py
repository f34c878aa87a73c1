"""Elastic rescale: remap a checkpoint trained on one mesh onto another.

    PYTHONPATH=src python -m repro_torch.launch.elastic --ckpt-dir /tmp/ck \
        --arch olmo-1b --to-mesh 1x1 [--device cpu]

PyTorch counterpart of ``repro.launch.elastic``.  Leaves are stored
unsharded (``training/checkpoint.py``), so resharding is placement:
rebuild the target ``ShardingRules`` for the new mesh, and restore each
leaf into a DTensor of its placements there, every rank reading the whole
leaf and keeping its shard (``checkpoint.restore`` against a template of
meta DTensors).  This is the scheduler-facing piece of fault tolerance: a
512-rank job resumes on 256 ranks (or a debug host) with no format
conversion.

The CLI opens a one-rank process group for a 1x1 mesh (NCCL on the card,
gloo with ``--device cpu``); a larger mesh in one process gets the fake
backend's ranks (``mesh.fake_world``), which places the shards this
process would hold as rank 0.
"""

from __future__ import annotations

import argparse
import math
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import fake_world, mesh_shape
from repro_torch.models.model import abstract_params
from repro_torch.models.shardings import ShardingRules
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import leaves, tree_map


def parse_mesh(spec: str, device_type: str = "cpu"):
    """"16x16" -> a (16, 16) ("data", "model") mesh; "2x16x16" adds
    "pod" in front; "1x1" is one rank.  Over the default group's ranks."""
    dims = tuple(int(x) for x in spec.split("x"))
    axes = ("pod", "data", "model")[-len(dims):]
    return init_device_mesh(device_type, dims, mesh_dim_names=axes)


def reshard(ckpt_dir: str, arch: str, to_mesh, cfg=None) -> dict:
    """Restore the newest committed step of ``ckpt_dir`` and re-place it
    for ``to_mesh``: parameters by ``ShardingRules``, the optimizer's
    moments as their parameters, its step replicated.  ``cfg`` overrides
    ``get_config(arch)`` (a smoke config)."""
    cfg = cfg or get_config(arch)
    params, axes = abstract_params(cfg)
    specs = ShardingRules(cfg, to_mesh).params_specs(params, axes)

    def place(t, spec, dtype=None):
        return specs_lib.abstract(tuple(t.shape), dtype or t.dtype, to_mesh,
                                  spec)
    template = tree_map(place, params, specs)
    moments = tree_map(lambda t, s: place(t, s, torch.float32), params, specs)
    opt_template = {"mu": moments, "nu": tree_map(lambda t: t, moments),
                    "step": specs_lib.abstract((), torch.int32, to_mesh, ())}
    steps = ckpt.committed_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    params, opt, step = ckpt.restore(ckpt_dir, steps[-1], template,
                                     opt_template)
    return {"params": params, "opt": opt, "step": step,
            "mesh": mesh_shape(to_mesh)}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--to-mesh", default="1x1",
                    help="e.g. 1x1, 16x16 or 2x16x16 (above one rank the "
                         "fake backend's ranks)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = math.prod(int(x) for x in args.to_mesh.split("x"))
    if n == 1:
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{free_port()}", rank=0,
            world_size=1)
        world = None
    else:
        world = fake_world(n)
        world.__enter__()
    try:
        mesh = parse_mesh(args.to_mesh, device.type)
        out = reshard(args.ckpt_dir, args.arch, mesh)
        count = sum(t.numel() for t in leaves(out["params"]))
        print(f"resharded step {out['step']} ({count / 1e6:.1f}M params) "
              f"onto {out['mesh']}")
    finally:
        if world is None:
            dist.destroy_process_group()
        else:
            world.__exit__(None, None, None)


if __name__ == "__main__":
    main()
