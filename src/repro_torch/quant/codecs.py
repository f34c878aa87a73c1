"""Bridge-crossing codecs: FP8-e4m3 and INT8 per-block-scale.

PyTorch counterpart of ``repro.quant.codecs``.  The byte accounting
(``wire_bytes``, the clamp, the opaque rules of ``encode_payload``) and the
accuracy-budget gate (``select_codec``) are the reference's.  What differs:

  * ``encode`` runs in torch on the tensor's own device and gives the same
    codes and scales as the reference's numpy codec, bit for bit.  fp8 is
    ``clamp(+-448)`` then torch's round-to-nearest-even cast to
    ``float8_e4m3fn``; torch writes code 0x80 for a scaled value of -0.0
    where the reference writes 0x00, so a zero scaled value is mapped to
    0x00.  Divisions are tensor by tensor (a division by a Python scalar
    may run as a multiplication by its reciprocal on the card);
  * a floating tensor, bf16 included, is encoded numerically.  The
    reference sees an ``ml_dtypes`` bf16 array as non-float and ships
    wire-sized zeros for it; the byte counts are the same either way;
  * ``decode`` and ``decode_many`` widen through the block-scale dequant
    kernel (``kernels/dequant``): the hand-written CUDA kernel for tensors
    on the card, one launch for a whole list of blocks, its plain version
    on the CPU;
  * a block's wire layout is real: the codes, then the scales' bytes
    (``QuantizedBlock.wire``), exactly ``wire_bytes`` long for an unclamped
    block.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

#: values covered by one f32 scale — the per-block quantization granularity
BLOCK_VALUES = 128
#: bytes per per-block scale on the wire
SCALE_BYTES = 4

#: largest finite e4m3 magnitude (S.1111.110); S.1111.111 is NaN in the
#: "fn" variant, so encode clamps here and never emits a NaN code
_E4M3_MAX = 448.0


class AccuracyBudgetError(ValueError):
    """Raised when a codec's measured round-trip error exceeds the budget."""


@dataclasses.dataclass(frozen=True)
class QuantizedBlock:
    """One encoded payload: codes + scales, with both byte counts.

    ``raw_bytes`` is what the tensor occupies at full width; ``wire_bytes``
    is what actually crosses the bridge.  ``codes`` (uint8, one per value,
    unpadded) and ``scales`` (f32, one per block) are tensors on the device
    the payload was encoded on; ``dtype`` names the payload's element type
    as the reference does ("float32", "bfloat16", ...).
    """

    codec: str
    raw_bytes: int
    wire_bytes: int
    codes: torch.Tensor
    scales: torch.Tensor
    shape: tuple
    dtype: str
    #: opaque payloads (non-float metadata buffers) ship wire-sized zeros —
    #: byte-accounting only, no numeric content to round-trip
    opaque: bool = False

    @property
    def clamped(self) -> bool:
        """The scale overhead would inflate this payload, so it crosses at
        full width (``wire_bytes == raw_bytes``): its own bytes, no codes."""
        return self.wire_bytes == self.raw_bytes

    def wire(self) -> torch.Tensor:
        """The block's wire bytes on its device: the codes, then the
        scales' bytes (``wire_bytes`` long unless opaque or clamped)."""
        return torch.cat([self.codes.reshape(-1),
                          self.scales.reshape(-1).view(torch.uint8)])


def split_wire(wire: torch.Tensor, n_codes: int) -> tuple:
    """Codes (uint8) and scales (f32) from a wire buffer laid out by
    ``QuantizedBlock.wire``, as views where the scales are 4-byte aligned."""
    codes, tail = wire[:n_codes], wire[n_codes:]
    if n_codes % SCALE_BYTES:
        tail = tail.clone()
    return codes, tail.view(torch.float32)


def _dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype's name as numpy spells it ("float32", "bfloat16")."""
    return str(dtype).removeprefix("torch.")


def wire_bytes(raw_bytes: int, itemsize: int = 2) -> int:
    """Wire size of a quantized payload that is ``raw_bytes`` at full width.

    1 byte per value plus one f32 scale per ``BLOCK_VALUES`` block, clamped
    at ``raw_bytes``: quantization never inflates a crossing (conformance
    law Q: wire <= raw).
    """
    if raw_bytes <= 0:
        return 0
    values = max(1, raw_bytes // max(1, itemsize))
    nblocks = -(-values // BLOCK_VALUES)
    return min(raw_bytes, values + nblocks * SCALE_BYTES)


def _pad_blocks(flat: torch.Tensor) -> torch.Tensor:
    """Reshape a flat f32 tensor into (nblocks, BLOCK_VALUES), zero-padded."""
    n = flat.numel()
    nblocks = max(1, -(-n // BLOCK_VALUES))
    if n == nblocks * BLOCK_VALUES:
        return flat.reshape(nblocks, BLOCK_VALUES)
    padded = torch.zeros(nblocks * BLOCK_VALUES, dtype=torch.float32,
                         device=flat.device)
    padded[:n] = flat
    return padded.reshape(nblocks, BLOCK_VALUES)


def _as_tensor(x: Union[torch.Tensor, np.ndarray]) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    return x


class _BlockScaleCodec:
    """Shared per-block-scale machinery; subclasses define the value codec."""

    name = ""
    #: the per-block scale target: block amax maps to this code magnitude
    _scale_den = 1.0

    def _encode_values(self, scaled: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # -- payload API -----------------------------------------------------------------

    def encode(self, x: Union[torch.Tensor, np.ndarray]) -> QuantizedBlock:
        """Codes and per-block scales of a floating tensor, on its device."""
        x = _as_tensor(x).detach()
        raw = x.numel() * x.element_size()
        flat = x.reshape(-1).float()
        blocks = _pad_blocks(flat)
        amax = blocks.abs().amax(dim=1)
        den = torch.full_like(amax, self._scale_den)
        scales = torch.where(amax > 0, amax / den, torch.ones_like(amax))
        codes = self._encode_values(blocks / scales[:, None])
        return QuantizedBlock(
            codec=self.name, raw_bytes=raw,
            wire_bytes=wire_bytes(raw, itemsize=max(1, x.element_size())),
            codes=codes.reshape(-1)[:flat.numel()], scales=scales,
            shape=tuple(x.shape), dtype=_dtype_name(x.dtype))

    def decode(self, qb: QuantizedBlock) -> torch.Tensor:
        """The f32 values of ``qb`` in its payload's shape, widened by the
        dequant kernel (one launch on the card)."""
        return self.decode_many([qb])[0]

    def decode_many(self, qbs: list) -> list:
        """The f32 values of each block in its payload's shape, every block
        that holds codes widened by one ``dequant_many`` (one launch per 64
        blocks on the card; the results are then views of one buffer).  An
        opaque block decodes to zeros (uint8) as in the reference."""
        from repro_torch.kernels.dequant.ops import dequant_many
        for qb in qbs:
            if qb.codec != self.name:
                raise ValueError(f"decode_many: a {qb.codec!r} block given "
                                 f"to the {self.name!r} codec")
        out = [None] * len(qbs)
        widen = []
        for i, qb in enumerate(qbs):
            if qb.opaque:
                out[i] = torch.zeros(qb.shape, dtype=torch.uint8,
                                     device=qb.codes.device)
            elif qb.codes.numel() == 0:
                out[i] = torch.zeros(qb.shape, dtype=torch.float32,
                                     device=qb.codes.device)
            else:
                widen.append(i)
        if widen:
            values = dequant_many([qbs[i].codes.reshape(-1) for i in widen],
                                  [qbs[i].scales.reshape(-1) for i in widen],
                                  codec=self.name)
            for i, v in zip(widen, values):
                out[i] = v.reshape(qbs[i].shape)
        return out

    def measured_error(self, probe=None) -> float:
        """Max per-block relative round-trip error on a seeded probe: max
        |decode - x| / block amax (the reference's metric, on the CPU)."""
        if probe is None:
            probe = np.random.default_rng(0).standard_normal(4096) \
                .astype(np.float32)
        x = _as_tensor(probe).float().cpu()
        dec = self.decode(self.encode(x)).reshape(-1).numpy()
        flat = x.reshape(-1).numpy()
        n = -(-flat.size // BLOCK_VALUES) * BLOCK_VALUES

        def blocks(a):
            return np.pad(a, (0, n - a.size)).reshape(-1, BLOCK_VALUES)

        amax = np.max(np.abs(blocks(flat)), axis=1)
        rel = (np.max(blocks(np.abs(dec - flat)), axis=1)
               / np.maximum(amax, 1e-30))
        return float(np.max(rel))


class Int8BlockScaleCodec(_BlockScaleCodec):
    """INT8 with one f32 scale per block: scale = amax/127, symmetric."""

    name = "int8"
    _scale_den = 127.0

    def _encode_values(self, scaled: torch.Tensor) -> torch.Tensor:
        return torch.round(scaled).clamp(-127, 127).to(torch.int8) \
            .view(torch.uint8)


class Fp8E4M3Codec(_BlockScaleCodec):
    """FP8 e4m3fn with one f32 scale per block: scale = amax/448."""

    name = "fp8"
    _scale_den = _E4M3_MAX

    def _encode_values(self, scaled: torch.Tensor) -> torch.Tensor:
        codes = scaled.clamp(-_E4M3_MAX, _E4M3_MAX) \
            .to(torch.float8_e4m3fn).view(torch.uint8)
        # the reference writes +0 for a zero scaled value, torch -0 for -0.0
        return torch.where(scaled == 0, torch.zeros_like(codes), codes)


CODECS = {c.name: c for c in (Int8BlockScaleCodec(), Fp8E4M3Codec())}


def get_codec(name: str) -> _BlockScaleCodec:
    try:
        return CODECS[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r} (have: {sorted(CODECS)})") from None


def select_codec(name: str,
                 accuracy_budget: float) -> Optional[_BlockScaleCodec]:
    """Resolve a codec by name, refusing it if its measured round-trip
    error exceeds ``accuracy_budget``.  An empty name means quantization is
    off — returns None."""
    if not name:
        return None
    codec = get_codec(name)
    err = codec.measured_error()
    if err > accuracy_budget:
        raise AccuracyBudgetError(
            f"codec {name!r} round-trip error {err:.4f} exceeds "
            f"accuracy_budget {accuracy_budget:.4f}")
    return codec


def encode_payload(codec: _BlockScaleCodec,
                   payload: Union[torch.Tensor, np.ndarray, int]
                   ) -> QuantizedBlock:
    """Encode an offload payload, falling back to byte-accounting for
    non-float buffers.

    A floating tensor (bf16 included) or floating numpy array gets the real
    codec.  Integer buffers — and the bare ``payload_bytes`` int the
    metadata-only offload path carries — get an *opaque* block: wire-sized
    zeros (on the CPU) whose byte counts are exact but whose content is not
    quantized.
    """
    if isinstance(payload, np.ndarray) and \
            np.issubdtype(payload.dtype, np.floating):
        return codec.encode(payload)
    if isinstance(payload, torch.Tensor) and payload.is_floating_point():
        return codec.encode(payload)
    if isinstance(payload, (np.ndarray, torch.Tensor)):
        t = _as_tensor(payload)
        raw = t.numel() * t.element_size()
        shape, dtype = tuple(t.shape), _dtype_name(t.dtype)
        itemsize = max(1, t.element_size())
    else:
        raw = int(payload)
        shape = (raw,)
        dtype = "uint8"
        itemsize = 2  # model KV payloads as bf16-width values
    wire = wire_bytes(raw, itemsize=itemsize if itemsize > 1 else 2)
    return QuantizedBlock(
        codec=codec.name, raw_bytes=raw, wire_bytes=wire,
        codes=torch.zeros(wire, dtype=torch.uint8),
        scales=torch.zeros(0, dtype=torch.float32),
        shape=shape, dtype=dtype, opaque=True)
