"""input_specs(): abstract stand-ins for every model input, with zero
device allocation.  The dry run drives train / prefill / decode steps on
these.

PyTorch counterpart of ``repro.launch.specs``: where the reference builds
``jax.ShapeDtypeStruct``s with ``NamedSharding``s, the port builds meta
DTensors whose placements are those shardings' (``spec_placements``): the
global shape and dtype of the reference's struct, each rank's local shard
on ``device="meta"``.

Cache specs come from the port's ``model.init_cache`` on meta, annotated
leaf by leaf by path (batch -> data axes, cache seq -> model axis:
context-parallel KV for the decode shapes).
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.mesh import data_axis_names, mesh_shape
from repro_torch.models import model as model_lib
from repro_torch.models.shardings import placements as spec_placements


def local_shape(shape: tuple, placements: tuple, mesh) -> tuple:
    """Each rank's shard shape of ``shape`` under ``placements`` (the
    sharded dims divide: the rules below shard only such dims)."""
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def abstract(shape: tuple, dtype, mesh, spec: tuple) -> DTensor:
    """A meta DTensor of global ``shape`` placed by ``spec`` (one entry
    per dim: a mesh-axis name, a tuple of names, or None)."""
    pl = spec_placements(spec, mesh)
    local = torch.empty(local_shape(tuple(shape), pl, mesh), dtype=dtype,
                        device="meta")
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def spec_of(t: DTensor) -> tuple:
    """The reference-style spec of a DTensor's placements: per tensor dim
    None, a mesh-axis name, or a tuple of names in mesh-dim order."""
    names = t.device_mesh.mesh_dim_names
    out = []
    for d in range(t.dim()):
        axes = tuple(n for n, p in zip(names, t.placements)
                     if p.is_shard() and p.dim == d)
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return tuple(out)


def _batch_spec(mesh, batch: int) -> tuple:
    axes = data_axis_names(mesh)
    shape = mesh_shape(mesh)
    size = math.prod(shape[a] for a in axes)
    if batch % size == 0:
        return axes
    if "data" in axes and batch % shape["data"] == 0:
        return ("data",)
    return ()


def batch_sharding(mesh, batch: int, extra_dims: int) -> tuple:
    """The spec of a batch-major input: batch over the data axes that
    divide it, the other dims unsharded."""
    b_axes = _batch_spec(mesh, batch)
    return (b_axes if b_axes else None,) + (None,) * extra_dims


def _frontend_specs(cfg: ModelConfig, B: int, mesh) -> dict:
    specs = {}
    shape = (B, cfg.frontend_tokens, cfg.d_model)
    if cfg.family == "vlm":
        specs["patch_embeds"] = abstract(shape, cfg.dtype, mesh,
                                         batch_sharding(mesh, B, 2))
    if cfg.encoder_layers:
        specs["frames"] = abstract(shape, cfg.dtype, mesh,
                                   batch_sharding(mesh, B, 2))
    return specs


def train_input_specs(cfg: ModelConfig, shape: InputShape, mesh) -> dict:
    B, S = shape.global_batch, shape.seq_len
    tok = batch_sharding(mesh, B, 1)
    specs = {
        "tokens": abstract((B, S), torch.int32, mesh, tok),
        "targets": abstract((B, S), torch.int32, mesh, tok),
        "loss_mask": abstract((B, S), torch.float32, mesh, tok),
    }
    specs.update(_frontend_specs(cfg, B, mesh))
    return specs


def prefill_input_specs(cfg: ModelConfig, shape: InputShape, mesh) -> dict:
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": abstract((B, S), torch.int32, mesh,
                                batch_sharding(mesh, B, 1))}
    specs.update(_frontend_specs(cfg, B, mesh))
    return specs


# ---------------------------------------------------------------------------------
# Cache specs (decode shapes)
# ---------------------------------------------------------------------------------

def _cache_leaf_sharding(mesh, path: str, shape: tuple, batch: int,
                         stacked: bool) -> tuple:
    """Spec of one cache leaf, by name + rank.

    Layout: [layers?], batch -> data axes, cache-seq -> model (context
    parallel), trailing dims unsharded.  Dims that don't divide degrade to
    replicated.
    """
    axes: list = []
    dims = list(shape)
    i = 0
    if stacked:
        axes.append(None)
        i = 1
    b_axes = _batch_spec(mesh, batch)
    if i < len(dims) and dims[i] == batch and b_axes:
        axes.append(b_axes)
    elif i < len(dims):
        axes.append(None)
    i += 1
    # seq dim for kv caches: k/v/pos/c/k_pe and cross_k/v
    leaf = path.split("/")[-1]
    if leaf in ("k", "v", "pos", "c", "k_pe", "cross_k", "cross_v") \
            and i < len(dims):
        if dims[i] % mesh_shape(mesh)["model"] == 0 and dims[i] > 1:
            axes.append("model")
        else:
            axes.append(None)
        i += 1
    while i < len(dims):
        axes.append(None)
        i += 1
    return tuple(axes)


def _with_paths(tree, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _with_paths(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_paths(v, fn, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, mesh) -> Any:
    enc_len = cfg.frontend_tokens if cfg.encoder_layers else 0
    meta = model_lib.init_cache(cfg, batch, max_len, dtype=cfg.dtype,
                                device="meta", enc_len=enc_len)

    def leaf(key: str, t: torch.Tensor):
        stacked = cfg.scan_layers and key.startswith("blocks")
        spec = _cache_leaf_sharding(mesh, key, tuple(t.shape), batch, stacked)
        return abstract(tuple(t.shape), t.dtype, mesh, spec)
    return _with_paths(meta, leaf)


def decode_input_specs(cfg: ModelConfig, shape: InputShape, mesh) -> dict:
    """decode_* / long_* drive serve_step: one new token against a KV
    cache of seq_len."""
    B, S = shape.global_batch, shape.seq_len
    tok = batch_sharding(mesh, B, 1)
    return {
        "caches": cache_specs(cfg, B, S, mesh),
        "tokens": abstract((B, 1), torch.int32, mesh, tok),
        "index": abstract((B,), torch.int32, mesh,
                          (_batch_spec(mesh, B) or None,)),
    }


def input_specs(cfg: ModelConfig, shape: InputShape, mesh) -> dict:
    if shape.kind == "train":
        return train_input_specs(cfg, shape, mesh)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape, mesh)
    return decode_input_specs(cfg, shape, mesh)
