"""Quantized bridge crossings: FP8-e4m3 / INT8 per-block-scale codecs.

PyTorch counterpart of ``repro.quant``.  The bridge moves ``wire_bytes``;
widening on restore runs the block-scale dequant kernel
(``kernels/dequant``) and is charged as compute
(``ComputeModel.dequant_charge``), never bridge time.
"""

from .codecs import (                                              # noqa: F401
    BLOCK_VALUES,
    SCALE_BYTES,
    AccuracyBudgetError,
    CODECS,
    Fp8E4M3Codec,
    Int8BlockScaleCodec,
    QuantizedBlock,
    encode_payload,
    get_codec,
    select_codec,
    split_wire,
    wire_bytes,
)
