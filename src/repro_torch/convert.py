"""Move weights and state from the reference package into the port.

The reference's parameter and cache trees, exported to numpy (nested dicts
and lists whose leaves are arrays or objects holding one in ``.value``),
become the port's trees of tensors on ``device`` with the same structure
and layouts: scan-stacked ``blocks`` keep their leading layers axis,
unrolled (hymba, xLSTM) ``blocks`` and cache trees stay per-layer lists,
MoE's dense layer 0 stays ``block0``, an encoder-decoder's encoder stays
``encoder`` (its own ``blocks`` and ``final_norm``) beside decoder blocks
holding ``cross_norm`` and ``cross``, and a tied embedding stays one
``embed`` leaf.  ``numpy_from_params`` goes the other way, so trained port
weights compare with the reference's.  bf16 converts exactly:
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


def numpy_from_tensor(t: torch.Tensor, bf16=None) -> np.ndarray:
    """One tensor as a numpy array, bit for bit: a bf16 tensor's uint16
    bits viewed as ``bf16`` (a numpy dtype for bfloat16, such as the one
    JAX registers; numpy has none of its own) or, without one, widened to
    f32, which is exact."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        if bf16 is None:
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(np.uint16).view(bf16)
    return t.numpy().copy()


def numpy_from_params(tree, bf16=None):
    """The port's parameter (or optimizer state) tree as nested dicts and
    lists of numpy arrays (``numpy_from_tensor`` per leaf): the inverse of
    ``params_from_numpy`` when ``bf16`` is given."""
    if isinstance(tree, dict):
        return {k: numpy_from_params(v, bf16) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_from_params(v, bf16) for v in tree]
    return numpy_from_tensor(tree, bf16)


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
    blocks = params["blocks"]
    lead = (len(blocks) if isinstance(blocks, list)
            else blocks["attn"]["wq"].shape[0])
    lead += "block0" in params
    if lead != cfg.n_layers:
        raise ValueError(f"blocks carry {lead} layers, {cfg.name} has "
                         f"{cfg.n_layers}")
    if bool(cfg.encoder_layers) != ("encoder" in params):
        raise ValueError(f"{cfg.name} has {cfg.encoder_layers} encoder "
                         f"layers; the tree's keys are {sorted(params)}")
    return params


def cache_from_numpy(tree, device: DeviceLike = None) -> dict:
    """The reference's decode cache tree as the port's: the attention
    caches (``{"blocks": ..., ["block0": ...]}``, ``blocks`` stacked over
    layers or a per-layer list; each layer ``{"kv": {"k", "v", "pos"}}``,
    MLA's ``{"kv": {"c", "k_pe", "pos"}}``, hymba's with ``"ssm"`` beside
    ``"kv"``) or xLSTM's per-layer state list (``{"blocks": [{"ssm":
    {...}}, ...]}``)."""
    return _convert(tree, resolve_device(device))
