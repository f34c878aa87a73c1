"""The port's quant codecs and dequant plain version against the reference.

Same seeded numpy inputs through ``repro.quant`` and ``repro_torch.quant``:
the torch encode gives the numpy codec's codes and scales bit for bit (±0,
subnormals, the 448 clamp, round-half-even ties, values over 30 binades),
bf16 tensors encode numerically with the reference's byte counts, the
byte accounting and the accuracy-budget gate agree, and the dequant plain
version equals the reference's Pallas kernel (interpret mode), its jnp
oracle and the host codec's decode on every one of the 256 codes (the two
NaN codes compared as NaN).  The CUDA kernel itself runs only on the card
(``chip_smoke.py`` holds it to the plain version bit for bit).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes

from repro.kernels.dequant import dequant as j_dequant
from repro.kernels.dequant.ref import dequant_ref as j_dequant_ref
from repro.quant import codecs as R
from repro_torch.kernels.dequant import ops
from repro_torch.kernels.dequant.ref import dequant_ref
from repro_torch.quant import codecs as T

CODECS = ["int8", "fp8"]


def _bits(a) -> np.ndarray:
    """f32 values as their bit patterns (compares -0.0 and +0.0 apart)."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def _same_f32(got, want) -> None:
    """Bit-equal f32 arrays, NaN compared as NaN."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape and got.dtype == np.float32
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got[~nan]), _bits(want[~nan]))


def _clamp_blocks(n_blocks: int, den: float, seed: int) -> np.ndarray:
    """Blocks whose amax divided by its own scale lands above ``den`` in
    f32 (so encode's clamp decides the top code)."""
    rng = np.random.default_rng(seed)
    amax = rng.uniform(0.5, 2.0, 1 << 14).astype(np.float32)
    scale = (amax / np.float32(den)).astype(np.float32)
    over = amax[amax / scale > np.float32(den)][:n_blocks]
    blocks = rng.uniform(-1, 1, (over.size, R.BLOCK_VALUES)).astype(np.float32)
    blocks *= over[:, None] * 0.99
    blocks[:, 0] = -over
    return blocks.reshape(-1)


def _tie_blocks(name: str) -> np.ndarray:
    """Blocks with scale exactly 1 (amax = the codec's top code) holding
    values midway between two codes: round-half-even decides them."""
    if name == "int8":
        ties = np.arange(-126.5, 127, 1.0, dtype=np.float32)
        top = 127.0
    else:
        grid = np.unique(np.abs(R._E4M3_LUT[np.isfinite(R._E4M3_LUT)]))
        mids = ((grid[:-1].astype(np.float64) + grid[1:]) / 2).astype(
            np.float32)
        ties = np.concatenate([mids, -mids])
        top = 448.0
    n = -(-ties.size // (R.BLOCK_VALUES - 1))
    out = np.zeros((n, R.BLOCK_VALUES), np.float32)
    out[:, 0] = top
    flat = out[:, 1:].reshape(-1)
    flat[:ties.size] = ties
    out[:, 1:] = flat.reshape(n, -1)
    return out.reshape(-1)


def _inputs(name: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    wide = (rng.standard_normal(1 << 16)
            * np.exp2(rng.integers(-15, 15, 1 << 16))).astype(np.float32)
    special = np.array(
        [0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40, np.finfo(np.float32).tiny,
         448.0, -448.0, 464.0, -500.0, 2.0 ** -9, -(2.0 ** -10), 3.0],
        np.float32)
    zeros = np.concatenate([np.zeros(R.BLOCK_VALUES, np.float32),
                            -np.zeros(R.BLOCK_VALUES, np.float32)])
    # a block of e4m3 subnormals and values that round to zero, scale 1
    sub = np.concatenate([[448.0], np.arange(1, 128) * 2.0 ** -12,
                          -np.arange(1, 128) * 2.0 ** -12]).astype(np.float32)
    den = 127.0 if name == "int8" else 448.0
    return np.concatenate([wide, special, zeros, sub, _tie_blocks(name),
                           _clamp_blocks(64, den, 3),
                           np.array([1.5, -2.5], np.float32)])


@pytest.mark.parametrize("name", CODECS)
def test_encode_is_bit_identical_to_the_numpy_codec(name):
    x = _inputs(name)
    ref = R.get_codec(name).encode(x)
    got = T.get_codec(name).encode(torch.from_numpy(x))
    np.testing.assert_array_equal(got.codes.numpy(), ref.codes)
    np.testing.assert_array_equal(_bits(got.scales), _bits(ref.scales))
    assert (got.raw_bytes, got.wire_bytes, got.shape, got.dtype,
            got.opaque) == (ref.raw_bytes, ref.wire_bytes, ref.shape,
                            ref.dtype, ref.opaque)
    _same_f32(T.get_codec(name).decode(got), R.get_codec(name).decode(ref))
    # the wire layout: codes then the scales' bytes, wire_bytes long
    wire = got.wire()
    assert wire.numel() == got.wire_bytes
    codes, scales = T.split_wire(wire, got.codes.numel())
    assert torch.equal(codes, got.codes)
    assert torch.equal(scales.view(torch.int32), got.scales.view(torch.int32))


@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("shape", [(2, 3, 16, 8), (300,), (1,)])
def test_bf16_tensors_encode_numerically(name, shape):
    x = (np.random.default_rng(1).standard_normal(shape) * 3).astype(
        np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    widened = t.float().numpy()
    got = T.encode_payload(T.get_codec(name), t)
    ref = R.get_codec(name).encode(widened)
    assert not got.opaque and got.dtype == "bfloat16"
    np.testing.assert_array_equal(got.codes.numpy(), ref.codes)
    np.testing.assert_array_equal(_bits(got.scales), _bits(ref.scales))
    # the reference treats an ml_dtypes bf16 array as opaque; its byte
    # counts are what the port's numeric encode must give
    opaque = R.encode_payload(R.get_codec(name),
                              widened.astype(ml_dtypes.bfloat16))
    assert opaque.opaque
    assert (got.raw_bytes, got.wire_bytes) == (opaque.raw_bytes,
                                               opaque.wire_bytes)
    assert got.clamped == (got.wire_bytes == got.raw_bytes)


def test_wire_bytes_formula_and_clamp_match():
    for raw in [0, 1, 2, 3, 5, 8, 17, 255, 256, 257, 4096, 65536, 1 << 21,
                2_000_003]:
        for itemsize in (1, 2, 4, 8):
            assert T.wire_bytes(raw, itemsize) == R.wire_bytes(raw, itemsize)
            assert T.wire_bytes(raw, itemsize) <= raw
    # one full-width KV block of olmo-1b: (2, 16, 16, 16, 128) bf16
    raw = 2 * 16 * 16 * 16 * 128 * 2
    assert T.wire_bytes(raw, 2) == 1_048_576 + 32_768
    assert T.wire_bytes(raw, 2) / raw == 0.515625


@pytest.mark.parametrize("payload", [
    65536, 7, np.arange(512, dtype=np.int32), np.arange(3, dtype=np.int8),
    np.linspace(-1, 1, 256, dtype=np.float32)],
    ids=["bytes", "tiny-bytes", "int32", "int8", "f32"])
def test_encode_payload_matches(payload):
    for name in CODECS:
        ref = R.encode_payload(R.get_codec(name), payload)
        got = T.encode_payload(T.get_codec(name), payload)
        assert (got.codec, got.raw_bytes, got.wire_bytes, got.shape,
                got.dtype, got.opaque) == (ref.codec, ref.raw_bytes,
                                           ref.wire_bytes, ref.shape,
                                           ref.dtype, ref.opaque)
        np.testing.assert_array_equal(got.codes.numpy(), ref.codes)
        if isinstance(payload, np.ndarray):
            tensor = T.encode_payload(T.get_codec(name),
                                      torch.from_numpy(payload))
            np.testing.assert_array_equal(tensor.codes.numpy(), ref.codes)
            assert tensor.wire_bytes == ref.wire_bytes


def test_measured_error_and_budget_gate_match():
    for name in CODECS:
        assert (T.get_codec(name).measured_error()
                == R.get_codec(name).measured_error())
        probe = np.random.default_rng(5).standard_normal(1000).astype(
            np.float32)
        assert (T.get_codec(name).measured_error(probe)
                == R.get_codec(name).measured_error(probe))
    for budget in (0.001, 0.01, 0.03, 0.04, 0.05):
        for name in CODECS:
            try:
                ref = R.select_codec(name, budget).name
            except R.AccuracyBudgetError:
                ref = "refused"
            try:
                got = T.select_codec(name, budget).name
            except T.AccuracyBudgetError:
                got = "refused"
            assert got == ref
    assert T.select_codec("", 0.05) is None
    with pytest.raises(ValueError, match="unknown"):
        T.get_codec("int4")
    with pytest.raises(T.AccuracyBudgetError):
        T.select_codec("fp8", 0.01)


def _all_codes_input(nblocks: int, seed: int):
    """Codes with every one of the 256 values, then seeded random codes;
    seeded f32 scales (one per block)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, nblocks * 128).astype(np.uint8)
    n = min(256, codes.size)
    codes[:n] = np.arange(n, dtype=np.uint8)
    if codes.size < 256:   # one block: the other codes at the next seeds
        codes[:] = np.arange(128, 256, dtype=np.uint8) if seed % 2 else \
            np.arange(128, dtype=np.uint8)
    scales = (rng.standard_normal(nblocks) * 4).astype(np.float32)
    return codes.reshape(nblocks, 128), scales


@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("nblocks,seed", [(1, 0), (1, 1), (127, 2), (128, 3),
                                          (300, 4)])
def test_dequant_plain_version_matches_reference(name, nblocks, seed):
    codes, scales = _all_codes_input(nblocks, seed)
    before = ops.dequant.launches
    got = ops.dequant(torch.from_numpy(codes), torch.from_numpy(scales),
                      codec=name)
    assert ops.dequant.launches == before     # the CPU runs the plain version
    _same_f32(got, np.asarray(j_dequant(codes, scales, codec=name,
                                        force_kernel=True)))
    _same_f32(got, np.asarray(j_dequant_ref(codes, scales[:, None],
                                            codec=name)))
    _same_f32(dequant_ref(torch.from_numpy(codes),
                          torch.from_numpy(scales)[:, None], codec=name), got)
    qb = R.QuantizedBlock(name, 0, 0, codes.reshape(-1), scales,
                          (nblocks * 128,), "float32")
    _same_f32(got.reshape(-1), R.get_codec(name).decode(qb))


def test_plain_fp8_decode_equals_the_lut_on_the_254_finite_codes():
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    got = dequant_ref(codes.reshape(2, 128), torch.ones(2, 1),
                      codec="fp8").reshape(-1)
    _same_f32(got, R._E4M3_LUT)
    assert int(torch.isnan(got).sum()) == 2        # 0x7F and 0xFF


def test_dequant_wrapper_refuses_what_it_cannot_take():
    codes = torch.zeros((4, 128), dtype=torch.uint8)
    scales = torch.ones(4)
    with pytest.raises(ValueError, match="unknown codec"):
        ops.dequant(codes, scales, codec="int4")
    with pytest.raises(ValueError, match="nblocks"):
        ops.dequant(torch.zeros((4, 64), dtype=torch.uint8), scales,
                    codec="int8")
    with pytest.raises(ValueError, match="scales"):
        ops.dequant(codes, torch.ones(3), codec="int8")
    with pytest.raises(ValueError, match="uint8"):
        ops.dequant(codes.to(torch.int8), scales, codec="int8")
    with pytest.raises(ValueError, match="no kernel"):
        ops.dequant(codes.to("meta"), scales.to("meta"), codec="fp8")
