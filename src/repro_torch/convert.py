"""Move weights and state from the reference package into the port.

The reference's parameter and cache trees, exported to numpy (nested dicts
and lists whose leaves are arrays or objects holding one in ``.value``),
become the port's trees of tensors on ``device`` with the same structure
and layouts: scan-stacked ``blocks`` keep their leading layers axis, and a
tied embedding stays one ``embed`` leaf.  bf16 converts exactly:
``torch.from_numpy`` does not take numpy's bfloat16 extension type, so the
bits cross as uint16 and are viewed as ``torch.bfloat16``.  Nothing here
imports JAX; the export to numpy is the caller's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def tensor_from_numpy(arr, device: DeviceLike = None) -> torch.Tensor:
    """One array (numpy, or anything ``np.asarray`` takes) as a tensor,
    bit for bit."""
    a = np.array(getattr(arr, "value", arr))  # an owned, writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    return tensor_from_numpy(tree, device)


def params_from_numpy(tree, cfg, device: DeviceLike = None) -> dict:
    """The reference's parameter tree as the port's (``Model(params=...)``)."""
    device = resolve_device(device)
    params = _convert(tree, device)
    if cfg.tie_embeddings and "unembed" in params:
        raise ValueError(f"{cfg.name} ties its embeddings but the tree "
                         f"carries an 'unembed' leaf")
    lead = params["blocks"]["attn"]["wq"].shape[0]
    if lead != cfg.n_layers:
        raise ValueError(f"blocks carry {lead} stacked layers, {cfg.name} "
                         f"has {cfg.n_layers}")
    return params


def cache_from_numpy(tree, device: DeviceLike = None) -> dict:
    """The reference's KV cache tree (``{"blocks": {"kv": {"k", "v",
    "pos"}}}``, stacked over layers) as the port's."""
    return _convert(tree, resolve_device(device))
