"""Logical-axis -> mesh-axis sharding rules (MaxText-style).

PyTorch counterpart of ``repro.models.shardings``.  Every parameter
carries logical axis names (``layers.make_param``'s ``axes``, collected
into a tree by ``model.param_axes``); this module resolves them for a
``DeviceMesh``, with per-arch fallbacks when a dimension does not divide
the mesh axis (e.g. qwen1.5's 20 heads or hymba's 32001 vocab on a 16-way
model axis -> row-parallel weights / embed-sharded embeddings instead).

A spec is the reference's ``PartitionSpec`` as a plain tuple: per tensor
dimension a mesh-axis name, a tuple of names, or None.  ``placements``
turns it into DTensor placements in mesh-dim order.

Baseline layout:
  params:      heads/mlp/vocab/expert -> "model" (TP/EP);
               embed -> "data" when cfg.fsdp (ZeRO-3 gather-on-use)
  activations: batch -> ("pod","data"); seq -> "model" when
               cfg.seq_shard_activations (Megatron-style SP); embed unsharded
  KV cache:    batch -> "data", seq -> "model" (decode shapes)
"""

from __future__ import annotations

import math
from typing import Optional

from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import mesh_shape
from repro_torch.training.optimizer import tree_map


def _axis_size(shape: dict, name: str) -> int:
    return shape.get(name, 1)


def _divides(dim: int, shape: dict, axis) -> bool:
    if axis is None:
        return True
    names = axis if isinstance(axis, tuple) else (axis,)
    return dim % math.prod(_axis_size(shape, n) for n in names) == 0


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim: Shard
    of the tensor dim that names the mesh axis, else Replicate.  A tensor
    dim named by several axes (("pod", "data")) is sharded by each, the
    major axis first, as JAX lays it out."""
    out = []
    for axis in mesh.mesh_dim_names:
        dim = next((d for d, ax in enumerate(spec)
                    if ax == axis or (isinstance(ax, tuple) and axis in ax)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


class ShardingRules:
    """Resolves logical axes to mesh axes for one (cfg, mesh) pair."""

    def __init__(self, cfg, mesh):
        self.cfg = cfg
        self.mesh = mesh
        shape = self.shape = mesh_shape(mesh)
        model_ok = lambda dim: dim % _axis_size(shape, "model") == 0
        data_axes = ("pod", "data") if "pod" in shape else ("data",)

        heads_shardable = model_ok(cfg.n_heads)
        kv_shardable = model_ok(cfg.n_kv_heads) and not cfg.use_mla
        vocab_shardable = model_ok(cfg.vocab_size)
        mlp_dim = cfg.d_ff if cfg.d_ff else cfg.ssm_expand * cfg.d_model
        mlp_shardable = model_ok(mlp_dim)
        expert_shardable = (cfg.n_routed_experts == 0
                            or model_ok(cfg.n_routed_experts))
        embed_fsdp = cfg.fsdp and cfg.d_model % math.prod(
            _axis_size(shape, a) for a in data_axes if a == "data") == 0

        self.param_rules = {
            "embed": "data" if embed_fsdp else None,
            "heads": "model" if heads_shardable else None,
            "kv_heads": "model" if kv_shardable else None,
            "head_dim": None,
            "mlp": "model" if mlp_shardable else None,
            "vocab": "model" if vocab_shardable else None,
            "expert": "model" if expert_shardable else None,
            "kv_lora": None,
            "layers": None,
            None: None,
        }
        # row-parallel fallback: if neither heads nor mlp shard, push the
        # model axis onto the contracting embed dim of weight matrices
        self.attn_row_parallel = not heads_shardable and not cfg.use_mla

        self.act_rules = {
            "batch": data_axes if len(data_axes) > 1 else data_axes[0],
            "seq": "model" if cfg.seq_shard_activations else None,
            "embed": None,
            "heads": self.param_rules["heads"],
            "kv_heads": self.param_rules["kv_heads"],
            "mlp": self.param_rules["mlp"],
            "expert": self.param_rules["expert"],
            "vocab": self.param_rules["vocab"],
            "kv_seq": "model",      # decode-shape KV cache: context parallel
            "head_dim": None,
            "frames": None,
            None: None,
        }

    # -- params ------------------------------------------------------------------------

    def param_spec(self, logical: tuple, shape: tuple) -> tuple:
        axes = []
        used = set()
        for name, dim in zip(logical, shape):
            ax = self.param_rules.get(name, None)
            if ax is not None and (ax in used
                                   or not _divides(dim, self.shape, ax)):
                ax = None
            if ax is not None:
                used.add(ax)
            axes.append(ax)
        return tuple(axes)

    def param_placements(self, logical: tuple, shape: tuple) -> tuple:
        return placements(self.param_spec(logical, shape), self.mesh)

    def params_specs(self, params, axes):
        """A tree shaped like ``params`` of each leaf's spec (``axes``:
        ``model.param_axes``'s tree)."""
        return tree_map(lambda t, a: self.param_spec(a, tuple(t.shape)),
                        params, axes)

    def params_shardings(self, params, axes):
        """A tree shaped like ``params`` of each leaf's DTensor
        placements on this mesh."""
        return tree_map(lambda t, a: self.param_placements(a, tuple(t.shape)),
                        params, axes)

    # -- activations -------------------------------------------------------------------

    def act_spec(self, logical: tuple, shape: Optional[tuple] = None) -> tuple:
        axes = []
        used = set()
        for i, name in enumerate(logical):
            ax = self.act_rules.get(name, None)
            if ax is not None:
                flat = ax if isinstance(ax, tuple) else (ax,)
                if any(a in used for a in flat):
                    ax = None
                elif shape is not None and not _divides(shape[i], self.shape,
                                                        ax):
                    ax = None
                else:
                    used.update(flat)
            axes.append(ax)
        return tuple(axes)

    def act_placements(self, logical: tuple,
                       shape: Optional[tuple] = None) -> tuple:
        return placements(self.act_spec(logical, shape), self.mesh)

    def resolver(self):
        """Activation resolver for ``layers.shard_hint``: size-checked, so
        hints on non-dividing dims degrade to replicated instead of
        erroring.  Returns (mesh, placements) or None."""
        def fn(logical: tuple, shape: Optional[tuple] = None):
            try:
                return self.mesh, self.act_placements(logical, shape)
            except Exception:
                return None
        return fn
