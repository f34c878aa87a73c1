"""Sharded weight files: a minimal safetensors-like container.

PyTorch counterpart of ``repro.loader.sharded_weights``; the files are byte
for byte the reference's, so either package reads the other's checkpoint.

Layout: <dir>/shard_<i>.bin + index.json mapping tensor name -> (shard,
offset, shape, dtype).  Tensor ``i`` (in the caller's order) goes to shard
``i % n_shards``.  ``dtype`` is numpy's name for the element type; bf16 is
written as ``"bfloat16"``, as the reference writes it through
``ml_dtypes``.  Numpy has no bf16 of its own, so here its bits cross as
``np.uint16``: ``read_tensor`` returns a uint16 array for a bf16 tensor and
``read_torch`` gives the ``torch.bfloat16`` tensor.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.gateway import _to_device
from repro_torch.device import DeviceLike, resolve_device

BF16 = "bfloat16"


def host_array(x) -> tuple[np.ndarray, str]:
    """``x`` (a tensor or anything ``np.asarray`` takes) as a C-ordered
    host array and the dtype name the index records: bf16 as its uint16
    bits, named ``"bfloat16"``."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        bf16 = t.dtype == torch.bfloat16
        arr = t.view(torch.int16).numpy() if bf16 else t.numpy()
    else:
        arr = np.asarray(x)
        bf16 = arr.dtype.name == BF16   # an ml_dtypes array from the caller
    arr = np.asarray(arr, order="C")
    if bf16:
        return arr.view(np.uint16), BF16
    return arr, str(arr.dtype)


def _np_dtype(name: str) -> np.dtype:
    """The numpy type that holds a recorded dtype's bytes."""
    return np.dtype(np.uint16) if name == BF16 else np.dtype(name)


def save_sharded(out_dir: str, tensors: dict, *, n_shards: int = 4) -> None:
    os.makedirs(out_dir, exist_ok=True)
    index = {"shards": n_shards, "tensors": {}}
    files = [open(os.path.join(out_dir, f"shard_{s}.bin"), "wb")
             for s in range(n_shards)]
    try:
        for i, name in enumerate(tensors):
            arr, dtype = host_array(tensors[name])
            shard = i % n_shards
            index["tensors"][name] = {
                "shard": shard, "offset": files[shard].tell(),
                "shape": list(arr.shape), "dtype": dtype,
            }
            files[shard].write(memoryview(arr.reshape(-1)).cast("B"))
    finally:
        for f in files:
            f.close()
    with open(os.path.join(out_dir, "index.json"), "w") as f:
        json.dump(index, f)


@dataclass
class ShardedCheckpoint:
    path: str

    def __post_init__(self):
        with open(os.path.join(self.path, "index.json")) as f:
            self.index = json.load(f)

    @property
    def n_shards(self) -> int:
        return self.index["shards"]

    def shard_tensors(self, shard: int) -> list[str]:
        return [n for n, m in self.index["tensors"].items() if m["shard"] == shard]

    def shard_bytes(self, shard: int) -> int:
        return os.path.getsize(os.path.join(self.path, f"shard_{shard}.bin"))

    def total_bytes(self) -> int:
        return sum(self.shard_bytes(s) for s in range(self.n_shards))

    def read_tensor(self, name: str) -> np.ndarray:
        """The tensor's values as a writable host array (bf16 as uint16),
        read straight into it: one host copy."""
        meta = self.index["tensors"][name]
        arr = np.empty(meta["shape"], _np_dtype(meta["dtype"]))
        with open(os.path.join(self.path, f"shard_{meta['shard']}.bin"),
                  "rb") as f:
            f.seek(meta["offset"])
            got = f.readinto(memoryview(arr.reshape(-1)).cast("B"))
        if got != arr.nbytes:
            raise ValueError(f"{name}: shard {meta['shard']} ends after "
                             f"{got} of {arr.nbytes} bytes")
        return arr

    def is_bf16(self, name: str) -> bool:
        return self.index["tensors"][name]["dtype"] == BF16

    def read_torch(self, name: str, device: DeviceLike = None) -> torch.Tensor:
        """The tensor on ``device`` (the card unless the caller asks for
        the CPU), bf16 as ``torch.bfloat16``."""
        return as_torch(self.read_tensor(name), self.is_bf16(name),
                        resolve_device(device))

    def iter_shard(self, shard: int) -> Iterator[tuple[str, np.ndarray]]:
        for name in self.shard_tensors(shard):
            yield name, self.read_tensor(name)


def as_torch(arr: np.ndarray, bf16: bool, device: torch.device) -> torch.Tensor:
    """A host array from ``read_tensor`` as a tensor on ``device``: the
    gateway's real upload (``core.gateway._to_device``), with bf16 bits
    crossing as int16 and viewed as ``torch.bfloat16``."""
    if bf16:
        return _to_device(arr.view(np.int16), device).view(torch.bfloat16)
    return _to_device(arr, device)
