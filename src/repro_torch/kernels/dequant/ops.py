"""Wrapper of the block-scale dequant kernel.

``dequant_many`` widens a list of segments (one payload's codes and
scales each) with ``csrc/dequant.cu`` for tensors on the card, one launch
per ``MAX_SEGMENTS`` segments into one output buffer, and runs the plain
version (``ref.dequant_many_ref``) for tensors on the CPU.  ``dequant`` is
its one-segment case for (nblocks, 128) codes.  There is no fallback: a
CUDA tensor the kernel does not take raises, and so does an input that
requires grad under grad mode (the kernel has no backward).
``dequant.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import refuse_autograd

from .ref import BLOCK, CODE_DTYPES, dequant_many_ref

#: segments per launch: the kernel's segment table travels as a kernel
#: parameter (``MAX_SEGMENTS`` in ``csrc/dequant.cu``)
MAX_SEGMENTS = 64
#: the C interface's codec ids
_CODEC_IDS = {"int8": 0, "fp8": 1}


def block_offsets(values: Sequence[int]) -> list[int]:
    """Quant blocks before each segment, and all of them last (n + 1
    entries): segment i's values start at float ``BLOCK * offsets[i]`` of
    the list's output buffer."""
    offsets = [0]
    for v in values:
        offsets.append(offsets[-1] + -(-v // BLOCK))
    return offsets


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
    # off the CPU a strided tensor is refused, not copied
    for name, t in (("codes", codes), ("scales", scales)):
        if t.device.type != "cpu" and not t.is_contiguous():
            raise ValueError(f"dequant: {name} must be contiguous on "
                             f"{t.device}")
    out, = dequant_many([codes.contiguous().view(-1)],
                        [scales.contiguous().view(-1)], codec=codec)
    return out.reshape(nblocks, BLOCK)


dequant.launches = 0


def dequant_many(codes: Sequence[torch.Tensor],
                 scales: Sequence[torch.Tensor], *,
                 codec: str) -> list[torch.Tensor]:
    """Segment i: ``codes[i]`` 1-D uint8 (any count n_i >= 1, contiguous,
    16-byte aligned) and ``scales[i]`` its ceil(n_i / 128) f32 scales
    (contiguous, 4-byte aligned), all on one device.  Returns each
    segment's n_i f32 values.  On the card they are views of one buffer,
    which lives until the last of them is dropped."""
    if codec not in CODE_DTYPES:
        raise ValueError(f"unknown codec {codec!r}")
    codes, scales = list(codes), list(scales)
    if not codes or len(codes) != len(scales):
        raise ValueError(f"dequant_many: a non-empty list of segments, "
                         f"got {len(codes)} codes and {len(scales)} scales")
    refuse_autograd("dequant", *codes, *scales)
    device = codes[0].device
    for i, (c, s) in enumerate(zip(codes, scales)):
        if c.device != device or s.device != device:
            raise ValueError(f"dequant_many: mixed devices (segment {i}: "
                             f"codes on {c.device}, scales on {s.device}; "
                             f"segment 0's codes on {device})")
        if c.dtype != torch.uint8 or s.dtype != torch.float32:
            raise ValueError(f"dequant_many: codes uint8 and scales float32, "
                             f"got {c.dtype} and {s.dtype} (segment {i})")
        if c.dim() != 1 or c.numel() < 1:
            raise ValueError(f"dequant_many: codes must be 1-D with at least "
                             f"one value, got {tuple(c.shape)} (segment {i})")
        if s.dim() != 1 or s.numel() != -(-c.numel() // BLOCK):
            raise ValueError(f"dequant_many: {s.numel()} scales for "
                             f"{c.numel()} values (segment {i})")
        for name, t, align in (("codes", c, 16), ("scales", s, 4)):
            if not t.is_contiguous() or t.data_ptr() % align:
                raise ValueError(f"dequant_many: {name} must be contiguous "
                                 f"and {align}-byte aligned (segment {i})")
    if device.type == "cpu":
        return dequant_many_ref(codes, scales, codec=codec)
    if device.type != "cuda":
        raise ValueError(f"dequant_many: no kernel for tensors on {device}")
    lib = _lib()
    values = [c.numel() for c in codes]
    offsets = block_offsets(values)
    out = torch.empty(offsets[-1] * BLOCK, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    for lo in range(0, len(codes), MAX_SEGMENTS):
        hi = min(len(codes), lo + MAX_SEGMENTS)
        k = hi - lo
        rc = lib.dequant_segments_fwd(
            (ctypes.c_void_p * k)(*(c.data_ptr() for c in codes[lo:hi])),
            (ctypes.c_void_p * k)(*(s.data_ptr() for s in scales[lo:hi])),
            (ctypes.c_longlong * k)(*values[lo:hi]), k,
            out.data_ptr() + 4 * BLOCK * offsets[lo], _CODEC_IDS[codec],
            stream)
        if rc != 0:
            raise RuntimeError(f"dequant kernel launch failed: CUDA error "
                               f"{rc}")
        dequant.launches += 1
    return [out[BLOCK * o:BLOCK * o + n] for o, n in zip(offsets, values)]


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load("dequant")
    fn = lib.dequant_segments_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
