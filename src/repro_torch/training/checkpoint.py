"""Checkpoints with atomic manifests and async commit, in the reference's
file layout, so a checkpoint written by either package restores in the
other.

PyTorch counterpart of ``repro.training.checkpoint``.  Layout:
  <dir>/step_<N>/
      manifest.json        # leaf keys, shapes, dtypes, step, wall time
      <leaf-key>.bin       # raw little-endian bytes per leaf
      COMMITTED            # written last: a step without it is incomplete

Leaf keys are the reference's: ``tree_flatten_with_path`` over
``{"params": params, "opt": opt_state}`` joined by "/", where every
parameter is a ``Param`` node whose one child adds "/0" (so
``params/blocks/attn/wq/0``, but ``opt/mu/blocks/attn/wq`` and
``opt/step``); list entries are their indices.  Files are named by the key
with "/" as "__".  Dtype names are numpy's, bf16 is "bfloat16", written as
its uint16 bits and read back the same way (no ``ml_dtypes``); a 0-d leaf
keeps shape ``[]``.

Fault tolerance: ``restore_latest`` finds the newest committed step, so a
crash mid-save is never resumed from.  ``save(async_commit=True)`` copies
every tensor to host memory before it returns, then writes on a worker
thread: the training step updates its tensors in place, so a writer
reading device memory later would race the next step.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

_PENDING: list[threading.Thread] = []
_ERRORS: list[BaseException] = []

#: the dtypes a leaf may have: numpy's name for each (bf16 as the
#: reference names it, its bits stored as uint16)
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int32: "int32", torch.int64: "int64", torch.int8: "int8",
          torch.uint8: "uint8", torch.bool: "bool"}
_DTYPES = {name: dtype for dtype, name in _NAMES.items()}


def _leaf_paths(tree, prefix: str, param: bool) -> list[tuple[str, Any]]:
    """(key, leaf) pairs in the reference's key format and order (dict
    keys sorted, as JAX flattens them).  ``param``: leaves are parameters,
    which the reference wraps in a ``Param`` node (one child, "0")."""
    if isinstance(tree, dict):
        return [kl for k in sorted(tree)
                for kl in _leaf_paths(tree[k], f"{prefix}/{k}", param)]
    if isinstance(tree, list):
        return [kl for i, v in enumerate(tree)
                for kl in _leaf_paths(v, f"{prefix}/{i}", param)]
    return [(f"{prefix}/0" if param else prefix, tree)]


def _state_paths(params, opt_state) -> list[tuple[str, Any]]:
    return (_leaf_paths(params, "params", True)
            + _leaf_paths(opt_state, "opt", False))


def _to_host(t: torch.Tensor) -> np.ndarray:
    """An owned host copy of ``t`` as numpy (bf16 as its uint16 bits)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(
            np.uint16)
    return t.to("cpu", copy=True).numpy()


def save(ckpt_dir: str, params, opt_state, step: int, *,
         async_commit: bool = False) -> str:
    """Write a checkpoint; returns the step directory path.  Every tensor
    is copied to host memory before this returns, also with
    ``async_commit`` (which writes on a worker thread: ``wait_for_pending``
    joins it)."""
    host = [(key, _NAMES[t.dtype], _to_host(t))
            for key, t in _state_paths(params, opt_state)]

    def _write():
        d = os.path.join(ckpt_dir, f"step_{step}")
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "time": time.time(), "leaves": {}}
        for key, name, arr in host:
            fname = key.replace("/", "__") + ".bin"
            with open(os.path.join(tmp, fname), "wb") as f:
                # the array's own buffer: no copy, and the write releases
                # the interpreter lock, so a training step runs beside it
                f.write(arr.data)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": name}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)
        with open(os.path.join(d, "COMMITTED"), "w") as f:
            f.write(str(step))
        return d

    if async_commit:
        def _run():
            try:
                _write()
            except BaseException as e:       # re-raised by wait_for_pending
                _ERRORS.append(e)
        t = threading.Thread(target=_run, daemon=True)
        t.start()
        _PENDING.append(t)
        return os.path.join(ckpt_dir, f"step_{step}")
    return _write()


def wait_for_pending() -> None:
    """Join every async save; raise the first one's error, if any."""
    for t in _PENDING:
        t.join()
    _PENDING.clear()
    if _ERRORS:
        err = _ERRORS[0]
        _ERRORS.clear()
        raise RuntimeError("an async checkpoint save failed") from err


def committed_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "COMMITTED")):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


def _read(d: str, meta: dict) -> torch.Tensor:
    """One stored leaf as a CPU tensor, bit for bit."""
    dtype = _DTYPES[meta["dtype"]]
    np_dtype = np.int16 if dtype == torch.bfloat16 else meta["dtype"]
    arr = np.fromfile(os.path.join(d, meta["file"]), dtype=np_dtype)
    t = torch.from_numpy(arr.reshape(meta["shape"]))
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def _load_tree(d: str, template, manifest: dict, prefix: str, param: bool):
    """A tree of the template's structure from the stored leaves, each on
    its template leaf's device, with its ``requires_grad``."""
    meta = manifest["leaves"]
    loaded = {}
    for key, leaf in _leaf_paths(template, prefix, param):
        t = _read(d, meta[key])
        if tuple(t.shape) != tuple(leaf.shape) or t.dtype != leaf.dtype:
            raise ValueError(f"checkpoint leaf {key}: {t.dtype} "
                             f"{tuple(t.shape)}, the template's "
                             f"{leaf.dtype} {tuple(leaf.shape)}")
        t = _place(t, leaf)
        loaded[key] = t.requires_grad_(leaf.requires_grad)

    def rebuild(tree, path):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{path}/{k}") for k, v in tree.items()}
        if isinstance(tree, list):
            return [rebuild(v, f"{path}/{i}") for i, v in enumerate(tree)]
        return loaded[f"{path}/0" if param else path]

    return rebuild(template, prefix)


def _place(full: torch.Tensor, leaf) -> torch.Tensor:
    """The whole stored leaf on the template leaf's device; for a DTensor
    template, this rank's shard of it under the template's placements
    (sharded dims split in mesh-dim order, the major axis first), wrapped
    with ``DTensor.from_local``: every rank reads the whole leaf from its
    file and keeps its own shard, so a restore needs no collective.  A
    meta template places on its mesh's device."""
    from torch.distributed.tensor import DTensor
    if not isinstance(leaf, DTensor):
        return full.to(leaf.device)
    mesh = leaf.device_mesh
    local = full
    for i, p in enumerate(leaf.placements):
        if p.is_shard():
            local = local.tensor_split(mesh.size(i), dim=p.dim)[
                mesh.get_local_rank(i)]
    device = leaf.to_local().device
    if device.type == "meta":
        device = torch.device(mesh.device_type, torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    return DTensor.from_local(local.contiguous().to(device), mesh,
                              leaf.placements, run_check=False,
                              shape=full.shape, stride=full.stride())


def _manifest_subtree(d: str, manifest: dict, prefix: str):
    """A nested dict of every leaf under ``prefix`` (CPU tensors)."""
    root: dict = {}
    for key, meta in manifest["leaves"].items():
        if not key.startswith(prefix + "/") and key != prefix:
            continue
        t = _read(d, meta)
        parts = key[len(prefix) + 1:].split("/") if key != prefix else []
        if not parts:
            return t
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return root


def restore(ckpt_dir: str, step: int, params_template,
            opt_template: Optional[Any] = None):
    """(params, opt_state, step) of a committed step: new tensors in the
    templates' structure, devices and ``requires_grad``; a DTensor template
    leaf gets a DTensor of its placements, each rank holding its shard
    (``_place``).  Without an optimizer template its tree comes from the
    manifest (nested dicts of CPU tensors)."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    params = _load_tree(d, params_template, manifest, "params", True)
    if opt_template is not None:
        opt = _load_tree(d, opt_template, manifest, "opt", False)
    else:
        opt = _manifest_subtree(d, manifest, "opt")
    return params, opt, manifest["step"]


def restore_latest(ckpt_dir: str, params_template,
                   opt_template: Optional[Any] = None):
    """``restore`` of the newest committed step, or None."""
    steps = committed_steps(ckpt_dir)
    if not steps:
        return None
    return restore(ckpt_dir, steps[-1], params_template, opt_template)
