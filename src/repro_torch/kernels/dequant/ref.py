"""Plain PyTorch version of the block-scale dequant kernel.

``out = decode(codes) * scale`` per 128-value block: the codes are viewed as
int8 or as float8_e4m3fn, widened to f32 (exact for every code) and
multiplied by their block's f32 scale (one rounding, as the reference's
LUT decode).  ``dequant_many_ref`` is the list call's: one ``dequant_ref``
per segment, a ragged last block zero-padded and then cut.  Used for CPU
tensors, by the tests, and by ``chip_smoke.py`` to hold the kernel to it on
the card.
"""

from __future__ import annotations

from typing import Sequence

import torch

#: values per quant block: one f32 scale each
BLOCK = 128
#: the value type each codec's codes are a bitcast of
CODE_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def dequant_ref(codes: torch.Tensor, scales: torch.Tensor, *,
                codec: str) -> torch.Tensor:
    """codes: (nblocks, BLOCK) uint8; scales: (nblocks, 1) f32
    -> (nblocks, BLOCK) f32."""
    if codec not in CODE_DTYPES:
        raise ValueError(f"unknown codec {codec!r}")
    return codes.view(CODE_DTYPES[codec]).float() * scales


def dequant_many_ref(codes: Sequence[torch.Tensor],
                     scales: Sequence[torch.Tensor], *,
                     codec: str) -> list[torch.Tensor]:
    """Each segment's codes (1-D uint8, any count) and its
    ceil(count / BLOCK) f32 scales -> its values, 1-D f32."""
    out = []
    for c, s in zip(codes, scales):
        n, nblocks = c.numel(), s.numel()
        if n != nblocks * BLOCK:
            padded = torch.zeros(nblocks * BLOCK, dtype=torch.uint8,
                                 device=c.device)
            padded[:n] = c
            c = padded
        out.append(dequant_ref(c.reshape(nblocks, BLOCK),
                               s.reshape(nblocks, 1),
                               codec=codec).reshape(-1)[:n])
    return out
