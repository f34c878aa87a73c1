"""The weights of a run, made on the device from the seed.

The tree is laid out as ``repro_torch``'s parameters are (its documented
format: ``embed`` (V, d), ``unembed`` (d, V), per-layer leaves stacked on a
leading layers axis under ``blocks``, a MoE model's dense layer 0 apart as
``block0``), so the same tensors go to ``Model(cfg, params=...)`` and to
the reference.  Every bf16 leaf is a view of one flat buffer drawn
N(0, 1) by a ``torch.Generator`` on the device in a few large calls, then
scaled by 1 / sqrt(fan_in); norms' scales are 1 and biases 0; a MoE
router is float32, drawn the same way.
"""

from __future__ import annotations

import math

import torch

#: elements per draw (the flat buffer is drawn in chunks of this size)
CHUNK = 1 << 30
#: each leaf starts on a multiple of this many elements (256 bytes)
ALIGN = 128


def dims(spec: dict) -> dict:
    """The sizes the weights and the counts need, from a configuration
    file's published keys and its ``runs_as``; a family's own sizes come
    from ``families/<family>.py``."""
    from portbench import families
    d = spec["hidden_size"]
    h = spec["num_attention_heads"]
    out = dict(family=spec["family"], layers=spec["num_hidden_layers"],
               d=d, heads=h, kv=spec["num_key_value_heads"],
               head_dim=spec.get("head_dim", d // h),
               d_ff=spec["intermediate_size"], vocab=spec["vocab_size"],
               tied=spec["tie_word_embeddings"], mlp=spec["runs_as"]["mlp"],
               norm=spec["runs_as"]["norm"])
    out.update(families.get(spec["family"]).dims(spec))
    return out


def norm_leaves(d: int, kind: str, lead: tuple) -> dict:
    leaves = {"scale": (lead + (d,), None, "ones")}
    if kind == "layernorm":
        leaves["bias"] = (lead + (d,), None, "zeros")
    return leaves


def mlp_leaves(d: int, f: int, kind: str, lead: tuple) -> dict:
    leaves = {"wi": (lead + (d, f), d, "bf16"),
              "wo": (lead + (f, d), f, "bf16")}
    if kind == "swiglu":
        leaves["wg"] = (lead + (d, f), d, "bf16")
    return leaves


def dense_block(dm: dict, lead: tuple) -> dict:
    """A layer of attention and one MLP of width ``d_ff``, its leaves
    stacked on ``lead``."""
    d, h, kv, hd = dm["d"], dm["heads"], dm["kv"], dm["head_dim"]
    return {
        "attn_norm": norm_leaves(d, dm["norm"], lead),
        "attn": {"wq": (lead + (d, h, hd), d, "bf16"),
                 "wk": (lead + (d, kv, hd), d, "bf16"),
                 "wv": (lead + (d, kv, hd), d, "bf16"),
                 "wo": (lead + (h, hd, d), h * hd, "bf16")},
        "mlp_norm": norm_leaves(d, dm["norm"], lead),
        "mlp": mlp_leaves(d, dm["d_ff"], dm["mlp"], lead),
    }


def layout(dm: dict) -> dict:
    """The tree of (shape, fan_in, kind) leaves; kind "bf16", "f32",
    "ones" or "zeros"."""
    from portbench import families
    d, v = dm["d"], dm["vocab"]
    tree = {"embed": ((v, d), d, "bf16"),
            "final_norm": norm_leaves(d, dm["norm"], ())}
    if not dm["tied"]:
        tree["unembed"] = ((d, v), d, "bf16")
    tree.update(families.get(dm["family"]).blocks(dm))
    return tree


def _leaves(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def _place(tree: dict, name: str, tensor) -> None:
    *path, last = name.split(".")
    for key in path:
        tree = tree.setdefault(key, {})
    tree[last] = tensor


def make(dm: dict, seed: int, device) -> dict:
    """The weights of ``dm`` drawn from ``seed`` on ``device``."""
    leaves = list(_leaves(layout(dm)))
    offsets, total = {}, 0
    for name, (shape, _, kind) in leaves:
        if kind != "f32":
            offsets[name] = total
            total += -(-math.prod(shape) // ALIGN) * ALIGN
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, dtype=torch.bfloat16, device=device)
    for chunk in flat.split(CHUNK):
        chunk.normal_(generator=gen)
    tree: dict = {}
    for name, (shape, fan_in, kind) in leaves:
        n = math.prod(shape)
        if kind == "f32":
            t = torch.empty(shape, dtype=torch.float32, device=device)
            t.normal_(generator=gen)
        else:
            t = flat[offsets[name]:offsets[name] + n].view(shape)
        if kind == "ones":
            t.fill_(1)
        elif kind == "zeros":
            t.zero_()
        else:
            t.mul_(1.0 / math.sqrt(fan_in))
        _place(tree, name, t)
    return tree
