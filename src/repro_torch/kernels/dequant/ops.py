"""Wrapper of the block-scale dequant kernel.

``dequant`` launches ``csrc/dequant.cu`` for tensors on the card and runs
the plain version (``ref.dequant_ref``) for tensors on the CPU.  There is no
fallback: a CUDA tensor the kernel does not take raises.  The kernel takes
any number of blocks (no padding to a row tile, unlike the TPU kernel's
wrapper).  ``dequant.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .ref import CODE_DTYPES, dequant_ref

#: values per quant block: one f32 scale each
BLOCK = 128
#: the C interface's codec ids
_CODEC_IDS = {"int8": 0, "fp8": 1}


def dequant(codes: torch.Tensor, scales: torch.Tensor, *,
            codec: str) -> torch.Tensor:
    """codes: (nblocks, 128) uint8; scales: (nblocks,) or (nblocks, 1) f32.
    Returns (nblocks, 128) f32: decoded values times their block's scale."""
    if codec not in CODE_DTYPES:
        raise ValueError(f"unknown codec {codec!r}")
    if codes.dim() != 2 or codes.shape[1] != BLOCK or codes.shape[0] < 1:
        raise ValueError(f"dequant: codes must be (nblocks >= 1, {BLOCK}), "
                         f"got {tuple(codes.shape)}")
    nblocks = codes.shape[0]
    if scales.numel() != nblocks:
        raise ValueError(f"dequant: {scales.numel()} scales for {nblocks} "
                         f"blocks")
    if codes.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise ValueError(f"dequant: codes uint8 and scales float32, got "
                         f"{codes.dtype} and {scales.dtype}")
    scales = scales.reshape(nblocks, 1)
    if codes.device.type == "cpu" and scales.device.type == "cpu":
        return dequant_ref(codes, scales, codec=codec)
    if codes.device.type != "cuda" or scales.device != codes.device:
        raise ValueError(f"dequant: no kernel for codes on {codes.device} "
                         f"and scales on {scales.device}")
    for name, t, align in (("codes", codes, 16), ("scales", scales, 4)):
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"dequant: {name} must be contiguous and "
                             f"{align}-byte aligned")
    out = torch.empty((nblocks, BLOCK), dtype=torch.float32,
                      device=codes.device)
    rc = _lib().dequant_fwd(
        codes.data_ptr(), scales.data_ptr(), out.data_ptr(), nblocks,
        _CODEC_IDS[codec], torch.cuda.current_stream(codes.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dequant kernel launch failed: CUDA error {rc}")
    dequant.launches += 1
    return out


dequant.launches = 0


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load("dequant")
    fn = lib.dequant_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
