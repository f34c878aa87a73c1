"""The dequant list call (``dequant_many``) and the restore path built on it.

Same seeded numpy inputs through ``repro`` and ``repro_torch`` on the CPU:

  * the plain list version equals, segment by segment, the reference's
    Pallas kernel (interpret mode), its jnp oracle and its host codec's
    decode, bit for bit (NaN as NaN), for lists of 1, 2, 32, 64 and 65
    segments of 1, 127 and 300 quant blocks and a ragged one of 77 values;
  * a numpy emulation of the CUDA kernel's index map (the host's split into
    launches of 64 segments and prefix offsets, the grid sized to the card,
    the grid stride with one unit a thread, the device's binary search
    over the prefix array, the ragged mask) writes every output value once,
    reads no code byte beyond its segment, and widens each value as the
    reference does;
  * ``decode_many`` equals per-block ``decode`` and the reference codec's
    decode, and a restore that mixes quantized, clamped, opaque and
    metadata-only blocks keeps the reference's records and stats while
    only the quantized blocks go through one list call;
  * the wrapper refuses what the kernel cannot take.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds each
list call to the plain version bit for bit).
"""

import dataclasses
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes

from repro.core.bridge import B300 as J_B300, BridgeModel as JBridge
from repro.core.gateway import TransferGateway as JGateway
from repro.core.policy import OffloadPolicy as JOffloadPolicy
from repro.core.policy import cc_aware_defaults as j_defaults
from repro.kernels.dequant import dequant as j_dequant
from repro.kernels.dequant.ref import dequant_ref as j_dequant_ref
from repro.quant import codecs as R
from repro.serving.offload import OffloadManager as JOffload
from repro.trace import TraceRecorder as JRecorder
from repro_torch.core.bridge import B300, BridgeModel
from repro_torch.core.gateway import TransferGateway
from repro_torch.core.policy import OffloadPolicy, cc_aware_defaults
from repro_torch.kernels.dequant import ops
from repro_torch.kernels.dequant.ref import dequant_many_ref
from repro_torch.quant import codecs as T
from repro_torch.serving.offload import OffloadManager
from repro_torch.trace import TraceRecorder, check_tape

CODECS = ["int8", "fp8"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CU = os.path.join(ROOT, "src", "repro_torch", "kernels", "dequant", "csrc",
                  "dequant.cu")
#: segment sizes in values: 1, 127 and 300 quant blocks, and a ragged one
SIZES = [128, 127 * 128, 300 * 128, 77]
#: (segments, first size): every size alone, then the longer lists
LISTS = [(1, 0), (1, 1), (1, 2), (1, 3), (2, 2), (32, 0), (64, 1), (65, 3)]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def _same_f32(got, want) -> None:
    """Bit-equal f32 arrays, NaN compared as NaN."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape and got.dtype == np.float32
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got[~nan]), _bits(want[~nan]))


def _segments(n: int, first: int, seed: int):
    """``n`` segments cycling through SIZES from ``first``: seeded codes
    (every one of the 256 codes at the start of each segment that holds
    them; the 1-block and ragged ones alternate halves) and f32 scales."""
    rng = np.random.default_rng(seed)
    codes, scales = [], []
    for i in range(n):
        size = SIZES[(first + i) % len(SIZES)]
        c = rng.integers(0, 256, size).astype(np.uint8)
        every = np.arange(256, dtype=np.uint8)
        if size < 256:
            every = every[128:] if i % 2 else every[:128]
        c[:min(size, every.size)] = every[:size]
        codes.append(c)
        scales.append((rng.standard_normal(-(-size // 128)) * 4)
                      .astype(np.float32))
    return codes, scales


def _padded(codes: np.ndarray, nblocks: int) -> np.ndarray:
    out = np.zeros(nblocks * 128, np.uint8)
    out[:codes.size] = codes
    return out.reshape(nblocks, 128)


def _reference(codes, scales, name: str):
    """Each segment's values by the Pallas kernel in interpret mode and by
    the jnp oracle (all segments' blocks in one call each), and by the
    host codec's decode."""
    blocks = np.concatenate([_padded(c, s.size) for c, s in
                             zip(codes, scales)])
    flat_scales = np.concatenate(scales)
    kernel = np.asarray(j_dequant(blocks, flat_scales, codec=name,
                                  force_kernel=True)).reshape(-1)
    oracle = np.asarray(j_dequant_ref(blocks, flat_scales[:, None],
                                      codec=name)).reshape(-1)
    out, start = [], 0
    for c, s in zip(codes, scales):
        qb = R.QuantizedBlock(name, 0, 0, c, s, (c.size,), "float32")
        host = R.get_codec(name).decode(qb)
        out.append((kernel[start:start + c.size],
                    oracle[start:start + c.size], host))
        start += s.size * 128
    return out


# ---------------------------------------------------------------------------------
# the plain list version against the reference
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("n,first", LISTS)
def test_plain_list_version_matches_reference(name, n, first):
    codes, scales = _segments(n, first, seed=10 * n + first)
    before = ops.dequant.launches
    got = ops.dequant_many([torch.from_numpy(c) for c in codes],
                           [torch.from_numpy(s) for s in scales], codec=name)
    assert ops.dequant.launches == before     # the CPU runs the plain version
    assert len(got) == n
    plain = dequant_many_ref([torch.from_numpy(c) for c in codes],
                             [torch.from_numpy(s) for s in scales],
                             codec=name)
    for g, p, (kernel, oracle, host) in zip(got, plain,
                                            _reference(codes, scales, name)):
        _same_f32(g, kernel)
        _same_f32(g, oracle)
        _same_f32(g, host)
        _same_f32(p, g)


def test_one_segment_call_is_the_list_call():
    codes, scales = _segments(3, 1, seed=5)
    for name in CODECS:
        c = torch.from_numpy(codes[1]).reshape(-1, 128)
        got = ops.dequant(c, torch.from_numpy(scales[1]), codec=name)
        many, = ops.dequant_many([c.reshape(-1)],
                                 [torch.from_numpy(scales[1])], codec=name)
        assert got.shape == (300, 128)
        _same_f32(got.reshape(-1), many)


# ---------------------------------------------------------------------------------
# the kernel's index map, emulated
# ---------------------------------------------------------------------------------

def _kernel_constants() -> dict:
    """THREADS, CTAS_PER_SM and MAX_SEGMENTS as ``csrc/dequant.cu``
    defines them."""
    src = open(CU).read()
    got = {}
    for key, pat in (("threads", r"constexpr int THREADS = (\d+);"),
                     ("ctas_per_sm", r"constexpr int CTAS_PER_SM = (\d+);"),
                     ("max_segments", r"constexpr int MAX_SEGMENTS = (\d+);"),
                     ("block", r"constexpr int BLOCK_VALUES = (\d+);"),
                     ("vec", r"constexpr int VEC = (\d+);")):
        m = re.search(pat, src)
        assert m, f"{key} not found in dequant.cu"
        got[key] = int(m.group(1))
    assert got["block"] == ops.BLOCK and got["vec"] == 16
    assert got["max_segments"] == ops.MAX_SEGMENTS
    return got


def _find_segment(prefix: np.ndarray, count: int,
                  blk: np.ndarray) -> np.ndarray:
    """The kernel's binary search, elementwise: the last i < count with
    prefix[i] <= blk."""
    lo = np.zeros(blk.shape, np.int64)
    hi = np.full(blk.shape, count, np.int64)
    while True:
        more = hi - lo > 1
        if not more.any():
            return lo
        mid = (lo + hi) >> 1
        go = more & (prefix[np.minimum(mid, count)] <= blk)
        lo = np.where(go, mid, lo)
        hi = np.where(more & ~go, mid, hi)


def _emulate(values: list, sms: int, codes=None, scales=None,
             codec: str = "fp8") -> dict:
    """The wrapper's launches and the kernel's walk over them, warp by warp
    (``csrc/dequant.cu``): the grid, each grid-stride iteration's unit a
    lane, its segment search and 16-byte (or ragged, byte by byte) code
    load, then its four stores, lane l taking values [4l, 4l + 4) of each of the warp's four
    blocks from the shared-memory stage.  Returns the loads made (segment,
    first code, count), how often each (block, lane) store happened, the
    launches, and, given codes and scales, the output buffer (NaN where
    nothing was stored) with per-value store counts."""
    k = _kernel_constants()
    upb = k["block"] // k["vec"]
    offsets = ops.block_offsets(values)
    total_blocks = offsets[-1]
    stores = np.zeros(total_blocks * 32, np.int64)
    value_level = codes is not None
    if value_level:
        out = np.full(total_blocks * 128, np.nan, np.float32)
        written = np.zeros(total_blocks * 128, np.int64)
        lut = np.arange(256, dtype=np.uint8).view(
            np.int8 if codec == "int8" else ml_dtypes.float8_e4m3fn) \
            .astype(np.float32)
    loads, launches = [], 0
    lane = np.arange(32, dtype=np.int64)
    for lo in range(0, len(values), ops.MAX_SEGMENTS):
        seg_values = np.array(values[lo:lo + ops.MAX_SEGMENTS], np.int64)
        count = seg_values.size
        # the C host code: prefix in quant blocks, units, the grid
        prefix = np.concatenate([[0], np.cumsum(-(-seg_values // 128))])
        units = int(prefix[-1]) * upb
        full = sms * k["ctas_per_sm"]
        need = -(-units // k["threads"])
        grid = min(need, full)
        stride = grid * k["threads"]
        launches += 1
        out_base = offsets[lo]                 # the launch's out pointer
        wbase = np.arange(0, stride, 32, dtype=np.int64)
        while wbase.size:
            u = wbase[:, None] + lane[None, :]
            valid = u < units
            blk = u // upb
            s = _find_segment(prefix, count, blk)
            local = blk - prefix[s]
            rest = seg_values[s] - local * 128
            left = np.where(valid, np.minimum(rest, 128), 0)
            first = (u % upb) * 16
            n = np.clip(left - first, 0, 16)
            loads.append(np.stack([(s + lo)[valid], (local * 128 +
                                   first)[valid], n[valid]]))
            if value_level:
                stage = np.zeros(u.shape + (16,), np.uint8)
                for w, ln in zip(*np.nonzero(n)):
                    seg = codes[s[w, ln] + lo]
                    a = local[w, ln] * 128 + first[w, ln]
                    stage[w, ln, :n[w, ln]] = seg[a:a + n[w, ln]]
                stage = stage.reshape(u.shape[0], 512)
                scale = np.zeros(u.shape, np.float32)
                for w, ln in zip(*np.nonzero(valid)):
                    scale[w, ln] = scales[s[w, ln] + lo][local[w, ln]]
            blk0 = wbase // upb
            for i in range(4):
                # lane 8i's block, shuffled to every lane
                ni = np.clip(left[:, 8 * i][:, None] - 4 * lane[None, :],
                             0, 4)
                w, ln = np.nonzero(ni)
                blk_i = blk0[w] + i
                np.add.at(stores, (out_base + blk_i) * 32 + ln, 1)
                if value_level:
                    sc = scale[:, 8 * i]
                    for wi, li, bi in zip(w, ln, blk_i):
                        at = (out_base + bi) * 128 + 4 * li
                        cnt = ni[wi, li]
                        word = stage[wi, 128 * i + 4 * li:
                                     128 * i + 4 * li + 4]
                        out[at:at + cnt] = (lut[word] * sc[wi])[:cnt]
                        written[at:at + cnt] += 1
            wbase = wbase + stride
            wbase = wbase[wbase < units]
    em = dict(loads=np.concatenate(loads, axis=1), stores=stores,
              launches=launches)
    if value_level:
        em.update(out=out, written=written)
    return em


def _check_index_map(values: list, em: dict) -> None:
    """Every code byte loaded once and none beyond its segment; every
    (block, lane) store made once where the block holds values there and
    never elsewhere; the launches the wrapper makes."""
    seg, first, n = em["loads"]
    vals = np.array(values, np.int64)[seg]
    act = n > 0
    assert (first % 16 == 0).all() and (n <= 16).all()
    assert (first[act] + n[act] <= vals[act]).all()     # no read past codes
    assert int(n.sum()) == sum(values)                  # every code once
    key = np.stack([seg[act], first[act]])
    assert np.unique(key, axis=1).shape[1] == key.shape[1]
    offsets = ops.block_offsets(values)
    want = np.zeros_like(em["stores"])
    for o, v in zip(offsets, values):
        lanes = np.arange(-(-v // 4))
        want[(o + lanes // 32) * 32 + lanes % 32] = 1
    np.testing.assert_array_equal(em["stores"], want)
    assert em["launches"] == -(-len(values) // ops.MAX_SEGMENTS)


@pytest.mark.parametrize("sms", [132, 3])
@pytest.mark.parametrize("n,first", LISTS)
def test_kernel_index_map_covers_every_value_once(n, first, sms):
    codes, scales = _segments(n, first, seed=10 * n + first)
    values = [c.size for c in codes]
    offsets = ops.block_offsets(values)
    inside = np.zeros(offsets[-1] * 128, np.int64)
    for o, v in zip(offsets, values):
        inside[o * 128:o * 128 + v] = 1
    for name in CODECS:
        em = _emulate(values, sms, codes, scales, name)
        _check_index_map(values, em)
        np.testing.assert_array_equal(em["written"], inside)
        for i, (_, _, host) in enumerate(_reference(codes, scales, name)):
            start = offsets[i] * 128
            _same_f32(em["out"][start:start + values[i]], host)


def test_kernel_index_map_at_the_restore_shape():
    """32 full-width olmo-1b KV blocks (8,192 quant blocks each), one
    launch over a full wave of the card, 15.5 grid strides a thread."""
    values = [8192 * 128] * 32
    em = _emulate(values, 132)
    _check_index_map(values, em)
    assert em["launches"] == 1


# ---------------------------------------------------------------------------------
# decode_many and the restore path
# ---------------------------------------------------------------------------------

PAYLOADS = [(2, 4, 16, 8), (300,), (77,), (1, 128), (3, 50)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", CODECS)
def test_decode_many_equals_decode_and_the_reference(name, dtype):
    codec, ref = T.get_codec(name), R.get_codec(name)
    qbs, arrays = [], []
    for i, shape in enumerate(PAYLOADS):
        x = (np.random.default_rng(i).standard_normal(shape) * (i + 1)) \
            .astype(np.float32)
        t = torch.from_numpy(x)
        if dtype == "bf16":
            t = t.to(torch.bfloat16)
            x = t.float().numpy()
        qbs.append(codec.encode(t))
        arrays.append(x)
    before = ops.dequant.launches
    many = codec.decode_many(qbs)
    assert ops.dequant.launches == before
    for qb, x, got in zip(qbs, arrays, many):
        assert got.shape == qb.shape and got.dtype == torch.float32
        _same_f32(got, codec.decode(qb))
        _same_f32(got, ref.decode(ref.encode(x)))
        host = R.QuantizedBlock(name, 0, 0, qb.codes.numpy(),
                                qb.scales.numpy(), qb.shape, "float32")
        _same_f32(got, ref.decode(host))


def test_decode_many_keeps_opaque_blocks_and_refuses_other_codecs():
    codec = T.get_codec("fp8")
    opaque = T.encode_payload(codec, 4096)
    coded = codec.encode(torch.ones(300))
    got = codec.decode_many([opaque, coded, opaque])
    assert got[0].dtype == torch.uint8 and not got[0].any()
    assert got[2].shape == opaque.shape
    _same_f32(got[1], codec.decode(coded))
    empty = codec.encode(torch.ones(0, 4))      # no values, one scale
    got, = codec.decode_many([empty])
    assert got.shape == (0, 4) and got.dtype == torch.float32
    with pytest.raises(ValueError, match="int8"):
        codec.decode_many([coded, T.get_codec("int8").encode(torch.ones(8))])


#: (hash, payload): quantized f32 and bf16 blocks (one ragged), a block the
#: clamp keeps at full width, an opaque (integer) block and a metadata-only
#: one (None)
MIXED = [(0, ("f32", (2, 4, 16, 8))), (1, ("clamped", (1,))),
         (2, ("meta", None)), (3, ("bf16", (300,))), (4, ("opaque", (64,))),
         (5, ("f32", (77,)))]


def _mixed_payload(h: int, kind: str, shape):
    if kind == "opaque":
        a = np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape)
        return torch.from_numpy(a.copy()), a
    x = (np.random.default_rng(h).standard_normal(shape) * (h + 1)).astype(
        np.float32)
    if kind == "bf16":
        t = torch.from_numpy(x).to(torch.bfloat16)
        return t, t.float().numpy().astype(ml_dtypes.bfloat16)
    return torch.from_numpy(x), x


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["bulk", "pipelined"])
@pytest.mark.parametrize("name", CODECS)
def test_mixed_restore_widens_only_the_quantized_blocks(name, pipelined,
                                                        monkeypatch):
    jg = JGateway(JBridge(J_B300, cc_on=True), j_defaults(True),
                  pool_workers=4)
    tg = TransferGateway(BridgeModel(B300, cc_on=True),
                         cc_aware_defaults(True), pool_workers=4,
                         device="cpu")
    jg.pool.prewarm()
    tg.pool.prewarm()
    kw = dict(store_threshold=2, block_bytes=4096,
              pipelined_restore=pipelined, restore_chunk_bytes=3000,
              kv_quant=name)
    jm = JOffload(jg, JOffloadPolicy.REUSE_AWARE, **kw)
    tm = OffloadManager(tg, OffloadPolicy.REUSE_AWARE, **kw)
    calls = []
    list_call = ops.dequant_many

    def counted(codes, scales, **kwargs):
        calls.append([c.numel() for c in codes])
        return list_call(codes, scales, **kwargs)

    monkeypatch.setattr(ops, "dequant_many", counted)
    spilled = {}
    with JRecorder(jg, label="mixed") as jrec, \
            TraceRecorder(tg, label="mixed") as trec:
        for h, (kind, shape) in MIXED:
            for mgr in (jm, tm):
                mgr.observe(h)
                mgr.observe(h)
            if kind == "meta":
                assert jm.evict(h) == tm.evict(h)
                continue
            t, a = _mixed_payload(h, kind, shape)
            spilled[h] = (kind, t)
            assert jm.evict(h, payload=a) == tm.evict(h, payload=t)
        keys = [h for h, _ in MIXED] + [99]
        assert tm.restore(keys, key="k") == jm.restore(keys, key="k")
    jrecs = [r.to_dict() for r in jrec.tape().records]
    assert [r.to_dict() for r in trec.tape().records] == jrecs
    assert dataclasses.asdict(tm.stats) == dataclasses.asdict(jm.stats)
    assert dataclasses.asdict(tg.stats) == dataclasses.asdict(jg.stats)
    assert tm.restore_done_t == jm.restore_done_t
    assert check_tape(trec.tape()).ok
    # one list call, holding exactly the quantized blocks, in order
    assert calls == [[2 * 4 * 16 * 8, 300, 77]]
    assert sorted(tm.restored) == [0, 1, 3, 5]
    ref = R.get_codec(name)
    for h in tm.restored:
        kind, t = spilled[h]
        got = tm.restored[h]
        if kind == "clamped":
            assert tm.host_store[h].qblock.clamped
            assert got.dtype == t.dtype and torch.equal(got, t)
            continue
        want = ref.decode(ref.encode(t.float().numpy()))
        assert got.dtype == torch.float32 and got.shape == t.shape
        _same_f32(got, want)


# ---------------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------------

def test_dequant_many_refuses_what_it_cannot_take():
    codes, scales = torch.zeros(300, dtype=torch.uint8), torch.ones(3)
    with pytest.raises(ValueError, match="unknown codec"):
        ops.dequant_many([codes], [scales], codec="int4")
    with pytest.raises(ValueError, match="non-empty"):
        ops.dequant_many([], [], codec="fp8")
    with pytest.raises(ValueError, match="non-empty"):
        ops.dequant_many([codes, codes], [scales], codec="fp8")
    with pytest.raises(ValueError, match="mixed devices"):
        ops.dequant_many([codes, codes.to("meta")], [scales, scales],
                         codec="fp8")
    with pytest.raises(ValueError, match="mixed devices"):
        ops.dequant_many([codes], [scales.to("meta")], codec="fp8")
    with pytest.raises(ValueError, match="uint8"):
        ops.dequant_many([codes.to(torch.int8)], [scales], codec="int8")
    with pytest.raises(ValueError, match="float32"):
        ops.dequant_many([codes], [scales.double()], codec="int8")
    with pytest.raises(ValueError, match="1-D"):
        ops.dequant_many([torch.zeros((3, 128), dtype=torch.uint8)],
                         [scales], codec="int8")
    with pytest.raises(ValueError, match="1-D"):
        ops.dequant_many([codes[:0]], [scales[:0]], codec="int8")
    with pytest.raises(ValueError, match="2 scales for 300 values"):
        ops.dequant_many([codes], [scales[:2]], codec="int8")
    with pytest.raises(ValueError, match="codes must be contiguous and "
                                         "16-byte aligned"):
        ops.dequant_many([torch.zeros(301, dtype=torch.uint8)[1:]], [scales],
                         codec="int8")
    with pytest.raises(ValueError, match="scales must be contiguous"):
        ops.dequant_many([codes], [torch.ones(6)[::2]], codec="int8")
    buf = bytearray(64)
    odd = torch.frombuffer(buf, dtype=torch.float32, count=3, offset=2)
    assert odd.data_ptr() % 4
    with pytest.raises(ValueError, match="scales must be contiguous and "
                                         "4-byte aligned"):
        ops.dequant_many([codes], [odd], codec="int8")
    with pytest.raises(ValueError, match="no kernel"):
        ops.dequant_many([codes.to("meta")], [scales.to("meta")],
                         codec="fp8")
    # dequant(), the one-segment call, refuses non-contiguous codes or
    # scales off the CPU rather than copy them; on the CPU it widens them
    rows = torch.zeros((128, 3), dtype=torch.uint8, device="meta").t()
    with pytest.raises(ValueError, match="codes must be contiguous"):
        ops.dequant(rows, scales.to("meta"), codec="fp8")
    with pytest.raises(ValueError, match="scales must be contiguous"):
        ops.dequant(rows.contiguous(), torch.ones(6, device="meta")[::2],
                    codec="fp8")


@pytest.mark.parametrize("name", CODECS)
def test_dequant_widens_strided_cpu_tensors_as_contiguous_ones(name):
    """On the CPU ``dequant`` takes strided codes and scales (the plain
    version needs no layout) and gives what their contiguous copies and
    the reference's jnp oracle give."""
    rng = np.random.default_rng(3)
    strided = torch.from_numpy(rng.integers(0, 256, (128, 5),
                                            dtype=np.uint8)).t()
    scales = torch.from_numpy(rng.standard_normal(10).astype(np.float32))
    got = ops.dequant(strided, scales[::2], codec=name)
    _same_f32(got, ops.dequant(strided.contiguous(), scales[::2].contiguous(),
                               codec=name))
    _same_f32(got, j_dequant_ref(strided.contiguous().numpy(),
                                 scales[::2].numpy()[:, None], codec=name))
