"""Plain PyTorch version of the block-scale dequant kernel.

``out = decode(codes) * scale`` per 128-value block: the codes are viewed as
int8 or as float8_e4m3fn, widened to f32 (exact for every code) and
multiplied by their block's f32 scale (one rounding, as the reference's
LUT decode).  Used for CPU tensors, by the tests, and by ``chip_smoke.py``
to hold the kernel to it on the card.
"""

from __future__ import annotations

import torch

#: the value type each codec's codes are a bitcast of
CODE_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def dequant_ref(codes: torch.Tensor, scales: torch.Tensor, *,
                codec: str) -> torch.Tensor:
    """codes: (nblocks, BLOCK) uint8; scales: (nblocks, 1) f32
    -> (nblocks, BLOCK) f32."""
    if codec not in CODE_DTYPES:
        raise ValueError(f"unknown codec {codec!r}")
    return codes.view(CODE_DTYPES[codec]).float() * scales
