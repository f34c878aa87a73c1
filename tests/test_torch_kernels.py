"""The port's kernel plain versions against the reference's kernels.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them to these plain versions there); here the plain versions are held to
the reference's jnp oracles over ``tests/test_kernels.py``'s shape sweeps,
and to the Pallas kernels in interpret mode, and so is an emulation of the
flash kernel's tensor-core arithmetic.  Tolerances are
``tests/test_kernels.py``'s: attention 2e-4 in f32 and 3e-2 in bf16; the
mLSTM scan rtol 1e-5 with atol 5e-4 (f32) or 1e-1 (bf16) and a mean error
below 1e-5 (f32) or 1e-3 (bf16).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.flash_attention.flash_attention import flash_attention_kernel
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.mlstm_scan.mlstm_scan import mlstm_scan_kernel
from repro.kernels.mlstm_scan.ref import mlstm_ref
from repro.kernels.paged_attention.paged_attention import paged_attention_kernel
from repro.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.mlstm_scan import ops as ml_ops
from repro_torch.kernels.mlstm_scan.ref import (mlstm_chunked_ref,
                                                 mlstm_sequential_ref)
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref as paged_ref_torch)

torch.set_num_threads(1)

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 2e-4),
          "bf16": (None, jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(rng, dt, *shapes):
    """Normal inputs made with numpy, rounded to ``dt`` once, as jnp arrays
    and CPU tensors holding the same values."""
    _, jdt, _, _ = DTYPES[dt]
    out = []
    for shape in shapes:
        a = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jdt)
        out.append((a, tensor_from_numpy(np.asarray(a), "cpu")))
    return out


def _close(jax_out, torch_out, atol):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out.astype(jnp.float32)),
                               atol=atol)


FLASH_SHAPES = [
    (2, 128, 128, 4, 2, 64, True, None),
    (1, 256, 256, 8, 8, 128, True, None),
    (2, 96, 96, 2, 1, 64, True, 48),      # ragged + sliding window
    (1, 128, 384, 4, 2, 64, False, None),  # cross-attention shape
    (3, 64, 64, 6, 2, 32, True, None),
]


class TestFlashPlain:
    @pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", FLASH_SHAPES)
    @pytest.mark.parametrize("dt", list(DTYPES))
    def test_matches_reference_oracle(self, b, sq, sk, h, kv, d, causal,
                                      window, dt):
        rng = np.random.default_rng(0)
        (qj, qt), (kj, kt), (vj, vt) = _inputs(
            rng, dt, (b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))
        ref = attention_ref(qj, kj, vj, causal=causal, window=window)
        out = flash_attention_ref(qt, kt, vt, causal=causal, window=window)
        assert out.dtype == DTYPES[dt][2]
        _close(ref, out, DTYPES[dt][3])

    def test_matches_pallas_kernel_interpret(self):
        rng = np.random.default_rng(1)
        (qj, qt), (kj, kt), (vj, vt) = _inputs(
            rng, "f32", (1, 80, 4, 32), (1, 80, 2, 32), (1, 80, 2, 32))
        ref = flash_attention_kernel(qj, kj, vj, causal=True, window=40,
                                     block_q=32, block_kv=32, interpret=True)
        _close(ref, flash_attention_ref(qt, kt, vt, causal=True, window=40),
               2e-4)

    def test_wrapper_on_cpu_takes_plain_version_without_launching(self):
        rng = np.random.default_rng(2)
        (_, qt), (_, kt), (_, vt) = _inputs(
            rng, "bf16", (1, 17, 4, 32), (1, 17, 2, 32), (1, 17, 2, 32))
        before = fa_ops.flash_attention.launches
        out = fa_ops.flash_attention(qt, kt, vt, causal=True)
        assert fa_ops.flash_attention.launches == before == 0
        assert torch.equal(out, flash_attention_ref(qt, kt, vt, causal=True))

    def test_wrapper_rejects_bad_shapes(self):
        q = torch.zeros(1, 4, 3, 32)
        k = torch.zeros(1, 4, 2, 32)       # 3 heads over 2 kv heads
        with pytest.raises(ValueError):
            fa_ops.flash_attention(q, k, k)


# The tensor-core kernel's tiles and constants (csrc/flash_attention.cu)
BQ = BK = 64
NEG_INF = -1e30


def _kernel_tile_range(q0, sq, sk, causal, window):
    """The KV tiles the kernel's block at query row ``q0`` runs, computed as
    the kernel computes them: [kt_begin, kt_end)."""
    nk = -(-sk // BK)
    kt_end = min(nk, (q0 + BQ - 1) // BK + 1) if causal else nk
    x = q0 - (window or 0) - (BK - 2)
    kt_begin = -(-x // BK) if window and x > 0 else 0
    return range(kt_begin, kt_end)


def _flash_tensor_core_emulation(q, k, v, *, causal, window, p_terms=2):
    """Test-only emulation of the CUDA kernel's arithmetic in f32, on CPU
    tensors: per 64-row query tile, over the 64-key tiles the kernel runs,
    S = Q.K^T from the unscaled bf16 values (exact products, f32 sums),
    masked with -1e30, an online softmax in f32 with the scale applied
    after the product inside the exponent (exp2(s*c - m*c), c = scale *
    log2 e, m*c = 0 while a row has no unmasked key), and P.V with P split
    into bf16 terms (``p_terms`` 2: hi + lo, as the kernel; 1: one bf16
    P).  Returns the output before its rounding to bf16, (B, Sq, H, D)
    f32."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    c = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32) * np.float32(
        1.4426950408889634)
    qf = q.float().transpose(1, 2)                           # (B, H, Sq, D)
    kf, vf = (torch.nn.functional.pad(
        t.float().repeat_interleave(h // kv, 2).transpose(1, 2),
        (0, 0, 0, -sk % BK)) for t in (k, v))              # zero-filled keys
    out = torch.zeros(b, h, sq, d)
    for q0 in range(0, sq, BQ):
        qt = qf[:, :, q0:q0 + BQ]
        qpos = torch.arange(q0, q0 + qt.shape[2])[:, None]
        m = torch.full(qt.shape[:3], NEG_INF)
        l = torch.zeros(qt.shape[:3])
        acc = torch.zeros(qt.shape)
        for kt in _kernel_tile_range(q0, sq, sk, causal, window):
            kpos = torch.arange(kt * BK, (kt + 1) * BK)[None, :]
            s = qt @ kf[:, :, kt * BK:(kt + 1) * BK].transpose(2, 3)
            ok = kpos < sk
            if causal:
                ok = ok & (kpos <= qpos)
            if window:
                ok = ok & (kpos > qpos - window)
            s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            mc = torch.where(m_new == NEG_INF, 0.0, m_new * c)
            p = torch.exp2(s * c - mc[..., None])
            corr = torch.exp2((m - m_new) * c)
            l = l * corr + p.sum(-1)
            vt = vf[:, :, kt * BK:(kt + 1) * BK]
            acc = acc * corr[..., None]
            rest = p
            for _ in range(p_terms):
                term = rest.bfloat16().float()
                acc = acc + term @ vt
                rest = rest - term
            m = m_new
        out[:, :, q0:q0 + BQ] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2)


class TestFlashTensorCoreArithmetic:
    """The arithmetic of the CUDA kernel, emulated on the CPU, against the
    reference's Pallas kernel in interpret mode and its jnp oracle (3e-2,
    bf16), and before its final rounding against the plain version in f32
    (2e-3)."""

    @pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", FLASH_SHAPES)
    def test_matches_pallas_kernel_and_oracle(self, b, sq, sk, h, kv, d,
                                              causal, window):
        rng = np.random.default_rng(0)
        (qj, qt), (kj, kt), (vj, vt) = _inputs(
            rng, "bf16", (b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))
        kw = dict(causal=causal, window=window)
        emulated = _flash_tensor_core_emulation(qt, kt, vt, **kw)
        pallas = flash_attention_kernel(qj, kj, vj, **kw, block_q=BQ,
                                        block_kv=BK, interpret=True)
        _close(pallas, emulated.bfloat16(), 3e-2)
        _close(attention_ref(qj, kj, vj, **kw), emulated.bfloat16(), 3e-2)
        plain = flash_attention_ref(qt.float(), kt.float(), vt.float(), **kw)
        err = (emulated - plain).abs().max().item()
        one_term = (_flash_tensor_core_emulation(qt, kt, vt, **kw, p_terms=1)
                    - plain).abs().max().item()
        assert err < 2e-3
        assert err < one_term / 16     # P carried well past bf16's 2^-9

    @pytest.mark.parametrize("sk", [1, 63, 64, 65, 300])
    @pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                               (True, 1), (True, 48),
                                               (False, 100)])
    def test_tile_range_is_the_reference_skip_rule(self, sk, causal, window):
        """The kernel's closed-form [kt_begin, kt_end) is exactly the set
        of tiles _flash_kernel's pl.when runs, at 64 x 64 blocks."""
        for q0 in range(0, 640, BQ):
            want = [kt for kt in range(-(-sk // BK))
                    if (not causal or kt * BK <= q0 + BQ - 1)
                    and (window is None or kt * BK + BK - 1 > q0 - window)]
            assert list(_kernel_tile_range(q0, 640, sk, causal,
                                           window)) == want


PAGED_SHAPES = [
    (2, 4, 2, 64, 16, 4, 16),
    (3, 8, 8, 128, 32, 3, 12),
    (1, 4, 1, 64, 8, 6, 8),
    (4, 2, 2, 32, 8, 5, 24),
]


def _paged_case(rng, dt, b, h, kv, d, page, pages_max, n_pages, lengths=None):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        rng, dt, (b, h, d), (n_pages, page, kv, d), (n_pages, page, kv, d))
    bt = rng.integers(0, n_pages, (b, pages_max)).astype(np.int32)
    if lengths is None:
        lengths = [1 + (i * 7 + 5) % (pages_max * page) for i in range(b)]
    ln = np.asarray(lengths, np.int32)
    jargs = (qj, kj, vj, jnp.asarray(bt), jnp.asarray(ln))
    targs = (qt, kt, vt, torch.from_numpy(bt), torch.from_numpy(ln))
    return jargs, targs


class TestPagedPlain:
    @pytest.mark.parametrize("b,h,kv,d,page,pages_max,n_pages", PAGED_SHAPES)
    @pytest.mark.parametrize("dt", list(DTYPES))
    def test_matches_reference_oracle(self, b, h, kv, d, page, pages_max,
                                      n_pages, dt):
        jargs, targs = _paged_case(np.random.default_rng(0), dt, b, h, kv, d,
                                   page, pages_max, n_pages)
        out = paged_ref_torch(*targs)
        assert out.dtype == DTYPES[dt][2]
        _close(paged_attention_ref(*jargs), out, DTYPES[dt][3])

    def test_short_sequences_skip_pages(self):
        """lengths below one page are exact (masking + page skip)."""
        jargs, targs = _paged_case(np.random.default_rng(3), "f32", 2, 4, 2,
                                   64, 16, 4, 8, lengths=[1, 3])
        _close(paged_attention_ref(*jargs), paged_ref_torch(*targs), 2e-4)

    def test_matches_pallas_kernel_interpret(self):
        jargs, targs = _paged_case(np.random.default_rng(4), "f32", 2, 6, 2,
                                   32, 8, 3, 6, lengths=[5, 24])
        _close(paged_attention_kernel(*jargs, interpret=True),
               paged_ref_torch(*targs), 2e-4)

    def test_wrapper_on_cpu_takes_plain_version_without_launching(self):
        _, targs = _paged_case(np.random.default_rng(5), "bf16", 2, 4, 2, 32,
                               8, 3, 6)
        before = pa_ops.paged_attention.launches
        out = pa_ops.paged_attention(*targs)
        assert pa_ops.paged_attention.launches == before == 0
        assert torch.equal(out, paged_ref_torch(*targs))


def _paged_split_emulation(q, k_pages, v_pages, block_tables, lengths,
                           pages_per_split):
    """Test-only emulation of the CUDA paged kernel's arithmetic in f32, on
    CPU tensors: q pre-scaled in f32; for each live split of a row (its
    pages from ``pa_ops.split_ranges``), 128 / lanes row groups (lanes:
    D/8 rounded up to a power of two), group rg
    taking tokens rg, rg + groups, ... of each page below the length, each
    with its own online softmax (m, l, acc) per query head; the groups
    merged by log-sum-exp; a row of one split normalised there, and the
    splits of a longer row merged by log-sum-exp (M = max m_i, out =
    sum e^{m_i-M} acc_i / max(sum e^{m_i-M} l_i, 1e-30)).  A row with no
    page gives zeros.  Returns (B, H, D) f32 before the kernel's rounding
    to bf16."""
    b, h, d = q.shape
    page, kv = k_pages.shape[1], k_pages.shape[2]
    pages_max = block_tables.shape[1]
    lanes = 1 << (d // 8 - 1).bit_length()      # D/8 up to a power of two
    rep, groups = h // kv, 128 // lanes
    scale = torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32)
    qf = (q.float() * scale).view(b, kv, rep, d)
    tables = block_tables.long()
    kf, vf = (t[tables].reshape(b, pages_max * page, kv, d).float()
              for t in (k_pages, v_pages))
    out = torch.zeros(b, kv, rep, d)

    def lse_merge(parts):
        m = torch.stack([p[0] for p in parts])
        w = torch.exp(m - m.amax(0))
        return (m.amax(0), (w * torch.stack([p[1] for p in parts])).sum(0),
                (w[..., None] * torch.stack([p[2] for p in parts])).sum(0))

    for i in range(b):
        length = int(lengths[i])
        splits = []
        for j0, j1 in pa_ops.split_ranges(length, page, pages_max,
                                          pages_per_split):
            parts = []
            for rg in range(groups):
                m = torch.full((kv, rep), NEG_INF)
                l, acc = torch.zeros(kv, rep), torch.zeros(kv, rep, d)
                for j in range(j0, j1):
                    for tok in range(rg, min(page, length - j * page),
                                     groups):
                        pos = j * page + tok
                        s = (qf[i] * kf[i, pos][:, None]).sum(-1)
                        mn = torch.maximum(m, s)
                        corr, p = torch.exp(m - mn), torch.exp(s - mn)
                        l = l * corr + p
                        acc = (acc * corr[..., None]
                               + p[..., None] * vf[i, pos][:, None])
                        m = mn
                parts.append((m, l, acc))
            splits.append(lse_merge(parts))
        if splits:
            _, l, acc = lse_merge(splits) if len(splits) > 1 else splits[0]
            out[i] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.view(b, h, d)


#: split sizes: one page, four pages, the whole row (pages_max)
PAGED_SPLITS = [1, 4, None]


class TestPagedSplitArithmetic:
    """The arithmetic of the split-over-pages CUDA kernel, emulated on the
    CPU, against the reference's Pallas kernel in interpret mode and its
    jnp oracle (2e-4 in f32, 3e-2 in bf16), and against the plain
    version."""

    @pytest.mark.parametrize("b,h,kv,d,page,pages_max,n_pages", PAGED_SHAPES)
    @pytest.mark.parametrize("pps", PAGED_SPLITS)
    @pytest.mark.parametrize("dt", list(DTYPES))
    def test_matches_pallas_kernel_and_oracle(self, b, h, kv, d, page,
                                              pages_max, n_pages, pps, dt):
        jargs, targs = _paged_case(np.random.default_rng(0), dt, b, h, kv, d,
                                   page, pages_max, n_pages)
        out = _paged_split_emulation(*targs, pps or pages_max)
        got = out.to(DTYPES[dt][2])
        tol = DTYPES[dt][3]
        _close(paged_attention_kernel(*jargs, interpret=True), got, tol)
        _close(paged_attention_ref(*jargs), got, tol)
        plain = paged_ref_torch(*(t.float() if t.is_floating_point() else t
                                  for t in targs))
        np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=2e-4)

    def test_lengths_at_the_edges(self):
        """Length 0 (zeros), 1, page +- 1, a split boundary +- 1, the whole
        table and past it, against the Pallas kernel in interpret mode."""
        page, pages_max, pps = 8, 6, 2
        lengths = [0, 1, page - 1, page + 1, pps * page - 1, pps * page,
                   pps * page + 1, pages_max * page, pages_max * page + 9]
        jargs, targs = _paged_case(np.random.default_rng(6), "f32",
                                   len(lengths), 4, 2, 32, page, pages_max,
                                   12, lengths=lengths)
        out = _paged_split_emulation(*targs, pps)
        _close(paged_attention_kernel(*jargs, interpret=True), out, 2e-4)
        assert torch.equal(out[0], torch.zeros_like(out[0]))


SPLIT_LENGTHS = [0, 1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1023, 1024,
                 1025, 5000]


class TestPagedSplitPlan:
    """The host's split plan (``ops.pages_per_split``, from the shapes
    alone) and the pages each split covers (``ops.split_ranges``, as the
    kernel computes them)."""

    @pytest.mark.parametrize("length", SPLIT_LENGTHS)
    @pytest.mark.parametrize("pps", [1, 3, 4, 64, 100])
    def test_splits_cover_every_page_once(self, length, pps):
        page, pages_max = 16, 64
        n_pages = min(-(-length // page), pages_max)
        ranges = pa_ops.split_ranges(length, page, pages_max, pps)
        covered = [j for j0, j1 in ranges for j in range(j0, j1)]
        assert covered == list(range(n_pages))
        assert all(0 < j1 - j0 <= pps for j0, j1 in ranges)
        assert len(ranges) == -(-n_pages // pps)

    @pytest.mark.parametrize("b,kv,pages_max,page", [
        (8, 16, 64, 16), (1, 16, 64, 16), (4, 8, 64, 16), (64, 8, 256, 16),
        (256, 32, 64, 16), (2, 2, 3, 8), (3, 4, 40, 8), (1, 1, 1, 1)])
    def test_pages_per_split(self, b, kv, pages_max, page):
        pps = pa_ops.pages_per_split(b, kv, pages_max, page)
        splits = -(-pages_max // pps)
        assert 1 <= pps <= pages_max
        assert pps == pages_max or pps * page >= pa_ops.SPLIT_TOKENS
        assert pps == pages_max or b * kv * splits <= pa_ops.GRID_CAP
        if (b, kv, pages_max, page) == (8, 16, 64, 16):
            assert pps == 4      # the decode timing shape: 64-token splits


# tests/test_kernels.py's mLSTM sweep: (b, s, h, dk, dv, chunk)
MLSTM_SHAPES = [
    (2, 64, 2, 32, 64, 16),
    (1, 100, 4, 64, 128, 32),   # ragged tail
    (2, 128, 2, 32, 64, 128),   # single chunk
]
MLSTM_TOL = {"f32": (5e-4, 1e-5), "bf16": (1e-1, 1e-3)}   # atol, mean bound


def _mlstm_case(rng, dt, b, s, h, dk, dv, initial_state=False):
    """Inputs as tests/test_kernels.py draws them (q pre-scaled, log_i
    normal x 2, log_f = log_sigmoid(normal + 1)), made with numpy; q/k/v
    rounded to ``dt``, gates and state in f32."""
    _, jdt, _, _ = DTYPES[dt]
    arrays = [rng.standard_normal((b, s, h, dk)) / np.sqrt(dk),
              rng.standard_normal((b, s, h, dk)),
              rng.standard_normal((b, s, h, dv))]
    arrays = [np.asarray(jnp.asarray(a.astype(np.float32)).astype(jdt))
              for a in arrays]
    li = (rng.standard_normal((b, s, h)) * 2.0).astype(np.float32)
    x = rng.standard_normal((b, s, h)).astype(np.float32) + 1.0
    lf = np.minimum(x, 0) - np.log1p(np.exp(-np.abs(x)))      # log_sigmoid
    arrays += [li, lf.astype(np.float32)]
    state = None
    if initial_state:
        state = (rng.standard_normal((b, h, dk, dv)).astype(np.float32),
                 rng.standard_normal((b, h, dk)).astype(np.float32),
                 rng.standard_normal((b, h)).astype(np.float32))
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [tensor_from_numpy(a, "cpu") for a in arrays]
    jstate = None if state is None else tuple(jnp.asarray(a) for a in state)
    tstate = None if state is None else tuple(
        tensor_from_numpy(a, "cpu") for a in state)
    return jargs, targs, jstate, tstate


def _mlstm_close(jax_y, torch_y, dt):
    atol, mean_bound = MLSTM_TOL[dt]
    got = torch_y.float().numpy()
    want = np.asarray(jax_y.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    assert float(np.mean(np.abs(got - want))) < mean_bound


def _state_close(jax_state, torch_state):
    for j, t in zip(jax_state, torch_state):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=5e-4)


class TestMlstmPlain:
    @pytest.mark.parametrize("b,s,h,dk,dv,chunk", MLSTM_SHAPES)
    @pytest.mark.parametrize("dt", list(DTYPES))
    def test_matches_sequential_oracle_and_pallas_kernel(self, b, s, h, dk,
                                                         dv, chunk, dt):
        jargs, targs, _, _ = _mlstm_case(np.random.default_rng(0), dt, b, s,
                                         h, dk, dv)
        y, state = mlstm_chunked_ref(*targs, chunk=chunk)
        assert y.dtype == DTYPES[dt][2]
        ref_y, ref_state = mlstm_ref(*jargs)
        _mlstm_close(ref_y, y, dt)
        _state_close(ref_state, state)
        _mlstm_close(mlstm_scan_kernel(*jargs, chunk=chunk, interpret=True),
                     y, dt)

    @pytest.mark.parametrize("dt", list(DTYPES))
    def test_initial_state(self, dt):
        """A scan that starts from a carried state (C, n, m)."""
        jargs, targs, jstate, tstate = _mlstm_case(
            np.random.default_rng(1), dt, 2, 70, 2, 32, 64,
            initial_state=True)
        y, state = mlstm_chunked_ref(*targs, chunk=32, initial_state=tstate)
        ref_y, ref_state = mlstm_ref(*jargs, initial_state=jstate)
        _mlstm_close(ref_y, y, dt)
        _state_close(ref_state, state)

    def test_sequential_oracle_matches_reference_oracle(self):
        jargs, targs, jstate, tstate = _mlstm_case(
            np.random.default_rng(2), "f32", 1, 40, 2, 32, 64,
            initial_state=True)
        y, state = mlstm_sequential_ref(*targs, initial_state=tstate)
        ref_y, ref_state = mlstm_ref(*jargs, initial_state=jstate)
        _mlstm_close(ref_y, y, "f32")
        _state_close(ref_state, state)

    def test_chunk_invariance_and_state_hand_off(self):
        """Chunkings agree, and scanning two halves with the state handed
        over equals scanning the whole."""
        _, targs, _, _ = _mlstm_case(np.random.default_rng(3), "f32", 1, 96,
                                     2, 32, 64)
        y16, s16 = mlstm_chunked_ref(*targs, chunk=16)
        y48, s48 = mlstm_chunked_ref(*targs, chunk=48)
        np.testing.assert_allclose(y16.numpy(), y48.numpy(), atol=1e-4)
        first = [t[:, :40] for t in targs]
        rest = [t[:, 40:] for t in targs]
        ya, sa = mlstm_chunked_ref(*first, chunk=16)
        yb, sb = mlstm_chunked_ref(*rest, chunk=16, initial_state=sa)
        np.testing.assert_allclose(torch.cat([ya, yb], 1).numpy(),
                                   y16.numpy(), atol=1e-4)
        for a, c in zip(sb, s16):
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5,
                                       atol=1e-4)

    def test_wrapper_on_cpu_takes_plain_version_without_launching(self):
        _, targs, _, tstate = _mlstm_case(np.random.default_rng(4), "f32", 1,
                                          20, 2, 32, 64, initial_state=True)
        before = ml_ops.mlstm_scan.launches
        y, state = ml_ops.mlstm_scan(*targs, chunk=8, initial_state=tstate)
        assert ml_ops.mlstm_scan.launches == before == 0
        ref_y, ref_state = mlstm_chunked_ref(*targs, chunk=8,
                                             initial_state=tstate)
        assert torch.equal(y, ref_y)
        assert all(torch.equal(a, c) for a, c in zip(state, ref_state))

    def test_wrapper_rejects_bad_shapes(self):
        q = torch.zeros(1, 8, 2, 16)
        v = torch.zeros(1, 8, 2, 32)
        gates = torch.zeros(1, 8, 2)
        with pytest.raises(ValueError):
            ml_ops.mlstm_scan(q, q, v, gates, torch.zeros(1, 8, 3), chunk=4)
        with pytest.raises(ValueError):
            ml_ops.mlstm_scan(q, q, v, gates, gates, chunk=4,
                              initial_state=(torch.zeros(1, 2, 16, 16),
                                             torch.zeros(1, 2, 16),
                                             torch.zeros(1, 2)))

    @pytest.mark.parametrize("seed", [0, 8])
    def test_probe_worst_row_terms_sum(self, seed):
        """The probe's readout of the worst row: in every column (kernel,
        plain, f64) the denominator's two parts sum to q.n, the denominator
        is max(|q.n|, e^-m), and the numerator's two parts over the
        denominator give y; the intra-chunk sum as W's row and as the plain
        version's q . (sum_s w_s k_s) agree in f64."""
        from repro_torch.kernels.mlstm_scan import probe
        got = probe.read(seed, "cpu", s=40, dk=16, dv=32, chunk=16)
        row = got["worst_row"]
        assert row["kappa_den"] >= 1 and row["kappa_num"] >= 1
        for impl, rel in (("kernel", 1e-6), ("plain", 1e-6), ("f64", 1e-12)):
            v = {name: row[name][impl] for name in
                 ("qn_intra", "qn_inter", "qdotn", "denom", "exp_neg_m",
                  "num_intra", "num_inter", "y")}
            assert v["qdotn"] == pytest.approx(v["qn_intra"] + v["qn_inter"],
                                               rel=rel, abs=1e-12)
            assert v["denom"] == pytest.approx(
                max(abs(v["qdotn"]), v["exp_neg_m"]), rel=max(rel, 1e-6))
            assert (v["num_intra"] + v["num_inter"]) / v["denom"] == \
                pytest.approx(v["y"], rel=1e-6)
        from repro_torch.kernels.mlstm_scan.probe import draw
        from repro_torch.kernels.mlstm_scan.ref import mlstm_chunked_ref
        terms = []
        mlstm_chunked_ref(*draw(seed, torch.device("cpu"), 1, 40, 4, 16, 32),
                          chunk=16, dtype=torch.float64, terms=terms)
        c, tl = row["chunk"], row["t"] % 16
        w_row = terms[c]["W"][row["b"], tl, row["h"], :tl + 1].sum()
        assert float(w_row) == pytest.approx(row["qn_intra"]["f64"],
                                             rel=1e-9, abs=1e-12)

    @pytest.mark.parametrize("seed", [0, 8])
    def test_probe_reads_kernel_and_plain_against_f64(self, seed):
        # on the CPU the wrapper runs the plain version: both readings agree
        # and nothing lies outside the criterion; the f64 gap is f32-sized
        from repro_torch.kernels.mlstm_scan import probe
        got = probe.read(seed, "cpu", s=40, dk=16, dv=32, chunk=16)
        assert got["seed"] == seed and got["y"]["rows_out"] == 0
        for name in ("y", "C", "n", "m"):
            r = got[name]
            assert r["kernel_vs_f64"] == r["plain_vs_f64"] < 5e-4
            assert r["out_of_criterion"] == 0


# The chunk-parallel mLSTM kernel's arithmetic (csrc/mlstm_scan.cu): tiles
# of 64 rows / keys, K steps of 32, k8 tensor-core steps
MK, MSTEP = 64, 32


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as the kernel rounds it (cvt.rna's rule, on the bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _round_to_zero(x64):
    """f64 -> f32 rounded toward zero (the tensor cores' f32 sums)."""
    x = x64.float()
    over = x.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(x, torch.zeros_like(x)), x)


def _mma3(a, b, one_sum=False):
    """a (M, K) @ b (K, N) in f32 as the kernel's 3xTF32 products compute
    it: hi = tf32(x), lo = tf32(x - hi); per k8 step one tensor-core sum
    (the step's products exact, the sum rounded toward zero); hi.hi summed
    per K step of 32 from zero and added to the running sum rounded to
    nearest, the cross terms hi.lo and lo.hi in their own running sum.
    ``one_sum``: every term in one running tensor-core sum instead."""
    pad = -a.shape[1] % MSTEP
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    big = torch.zeros(a.shape[0], b.shape[1])
    small = torch.zeros_like(big)
    for k0 in range(0, a.shape[1], MSTEP):
        part = big if one_sum else torch.zeros_like(big)
        for k in range(k0, k0 + MSTEP, 8):
            sl = slice(k, k + 8)
            if one_sum:
                part = _round_to_zero(part.double() + al[:, sl] @ bh[sl])
                part = _round_to_zero(part.double() + ah[:, sl] @ bl[sl])
            else:
                small = _round_to_zero(small.double() + al[:, sl] @ bh[sl])
                small = _round_to_zero(small.double() + ah[:, sl] @ bl[sl])
            part = _round_to_zero(part.double() + ah[:, sl] @ bh[sl])
        big = part if one_sum else big + part
    return big + small


def _mlstm_tensor_core_emulation(q, k, v, log_i, log_f, *, chunk,
                                 initial_state=None, terms=None,
                                 tensor_cores=("scores", "out", "state")):
    """Test-only emulation of the CUDA kernel's order of operations, on CPU
    tensors (f32): per chunk and head independently, F summed in f64
    (exact) and kept in f64 for every gate weight's argument, each weight
    rounded once; the row maxima of D from a prefix argmax of li_s - F_s;
    the m carry over chunks in f32; each chunk's own state contribution
    dC = (k kv_w)^T V (3xTF32) and dn, then the combine C_{c+1} = C_c
    w_carry + dC_c in chunk order (one chunk: C0 w_carry + dC directly);
    W = (Q K^T) (3xTF32) times the weights, its row sums by key tile of 64
    summed in order; y = [W | q interw] [V ; C_c] (3xTF32, one product
    over K = L + dk, the C half skipped where C_c is zero) over max(|row
    sum + (q interw) . n_c|, e^{-m_t}).  Returns (y (B,S,H,dv) f32,
    (C, n, m)); with ``terms`` (a dict) also the row maxima m_t (B,S,H).
    ``tensor_cores`` names the products emulated in 3xTF32; the others
    are f32 products (CUDA cores)."""

    def product(name, a, b):
        return _mma3(a, b) if name in tensor_cores else a @ b

    b_, s_, h_, dk = q.shape
    dv = v.shape[-1]
    nc = -(-s_ // chunk)
    q, k, v, li, lf = (t.float() for t in (q, k, v, log_i, log_f))
    y = torch.zeros(b_, s_, h_, dv)
    C_out = torch.zeros(b_, h_, dk, dv)
    n_out, m_out = torch.zeros(b_, h_, dk), torch.zeros(b_, h_)
    mts = torch.zeros(b_, s_, h_)
    for b in range(b_):
        for h in range(h_):
            # pass 1, every chunk on its own
            st = []
            for c in range(nc):
                t0 = c * chunk
                L = min(chunk, s_ - t0)
                F = torch.cumsum(lf[b, t0:t0 + L, h].double(), 0)
                li64 = li[b, t0:t0 + L, h].double()
                val, best, dmax = li64 - F, 0, torch.zeros(L)
                for t in range(L):
                    if val[t] > val[best]:
                        best = t
                    dmax[t] = ((F[t] - F[best]) + li64[best]).float()
                g = ((F[-1] - F) + li64).float().max()
                st.append((t0, L, F, li64, dmax, g))
            m0 = (torch.tensor(NEG_INF, dtype=torch.float32)
                  if initial_state is None else initial_state[2][b, h])
            ms = [m0]
            for (_, _, F, _, _, g) in st:                     # the m carry
                ms.append(torch.maximum(ms[-1] + F[-1].float(), g))
            # pass 2: each chunk's state contribution
            dCs, dns, wcs = [], [], []
            for c, (t0, L, F, li64, _, _) in enumerate(st):
                m, m_next = ms[c].double(), ms[c + 1].double()
                wcs.append(torch.exp((m + F[-1]) - m_next).float())
                kw = torch.exp(((F[-1] - F) + li64) - m_next).float()
                Kw = k[b, t0:t0 + L, h] * kw[:, None]
                dCs.append(product("state", Kw.T.contiguous(),
                                   v[b, t0:t0 + L, h]))
                dns.append(Kw.sum(0))
            # pass 3: the combine (chunk-start states)
            if initial_state is None:
                C, n = torch.zeros(dk, dv), torch.zeros(dk)
            else:
                C, n = initial_state[0][b, h], initial_state[1][b, h]
            starts = []
            for c in range(nc):
                starts.append((C, n))
                C = C * wcs[c] + dCs[c]
                n = n * wcs[c] + dns[c]
            C_out[b, h], n_out[b, h], m_out[b, h] = C, n, ms[-1]
            # pass 4: scores and output, every chunk on its own
            for c, (t0, L, F, li64, dmax, _) in enumerate(st):
                inter = ms[c].double() + F
                mt = torch.maximum(dmax, inter.float())
                iw = torch.exp(inter - mt.double()).float()
                mts[b, t0:t0 + L, h] = mt
                D = (F[:, None] - F[None, :]) + li64[None, :]
                w = torch.exp(D - mt.double()[:, None]).float()
                w = torch.where(torch.ones(L, L, dtype=torch.bool).tril(),
                                w, 0.0)
                W = product("scores", q[b, t0:t0 + L, h],
                            k[b, t0:t0 + L, h].T) * w
                rowsum = sum(W[:, s0:s0 + MK].sum(1)
                             for s0 in range(0, L, MK))
                qi = q[b, t0:t0 + L, h] * iw[:, None]
                Cc, nc_ = starts[c]
                A = torch.nn.functional.pad(W, (0, -L % MSTEP))
                Bm = torch.nn.functional.pad(v[b, t0:t0 + L, h],
                                             (0, 0, 0, -L % MSTEP))
                if c > 0 or initial_state is not None:
                    A, Bm = torch.cat([A, qi], 1), torch.cat([Bm, Cc], 0)
                    qn = (qi * nc_).sum(1)
                else:
                    qn = torch.zeros(L)
                den = torch.maximum((rowsum + qn).abs(), torch.exp(-mt))
                y[b, t0:t0 + L, h] = product("out", A, Bm) / den[:, None]
    if terms is not None:
        terms["m_t"] = mts
    return y, (C_out, n_out, m_out)


MLSTM_TC_CASES = [
    dict(b=1, s=100, h=2, dk=32, dv=64, chunk=32, init=False),  # ragged, nc 4
    dict(b=2, s=64, h=2, dk=32, dv=64, chunk=16, init=False),   # nc 4, B 2
    dict(b=1, s=70, h=2, dk=32, dv=64, chunk=32, init=True),    # carried, nc 3
    dict(b=1, s=128, h=2, dk=64, dv=128, chunk=128, init=False),  # one chunk
]


def _mlstm_tc_inputs(seed, c):
    return _mlstm_case(np.random.default_rng(seed), "f32", c["b"], c["s"],
                       c["h"], c["dk"], c["dv"], initial_state=c["init"])


def _mlstm_worst_row_c(seed, case, tensor_cores=("scores", "out", "state")):
    """The emulation on one draw held to ``chip_smoke.py``'s criterion
    (every element of y, C, n and m; asserted) and y's mean error against
    the plain version (asserted below 1e-5); returns c = |y - y_f64| /
    (eps32 kappa |y_f64|) at y's element furthest from f64, as the probe
    reads its worst row."""
    from repro_torch.kernels.mlstm_scan import probe
    _, targs, _, tstate = _mlstm_tc_inputs(seed, case)
    kw = dict(chunk=case["chunk"], initial_state=tstate)
    y, state = _mlstm_tensor_core_emulation(*targs, **kw,
                                            tensor_cores=tensor_cores)
    py, pstate = mlstm_chunked_ref(*targs, **kw)
    rterms = []
    ry, rstate = mlstm_chunked_ref(*targs, **kw, dtype=torch.float64,
                                   terms=rterms)
    scales = probe.abs_sums(targs, case["chunk"], tstate, rterms)
    for name, got, plain, exact in zip(("y", "C", "n", "m"), (y, *state),
                                       (py, *pstate), (ry, *rstate)):
        arms = probe.criterion(got, plain, exact, scales.get(name), 5e-4)
        assert arms["out"] == 0, (name, case, seed)
    assert float((y - py).abs().mean()) < 1e-5
    err = (y.double() - ry).abs()
    worst = err.argmax()
    return float(err.flatten()[worst]
                 / (probe.EPS32 * scales["y"].flatten()[worst]))


class TestMlstmTensorCoreArithmetic:
    """The arithmetic of the CUDA mLSTM kernel, emulated on the CPU, against
    the reference's Pallas kernel in interpret mode and its jnp oracle at
    tests/test_kernels.py's tolerances (atol 5e-4, rtol 1e-5, mean below
    1e-5), and against an f64 evaluation of the same algorithm by
    ``chip_smoke.py``'s per-element criterion (the plain version's
    tolerance, or c eps32 kappa |x_f64| with c = 2), seeds 0-15."""

    @pytest.mark.parametrize("case", MLSTM_TC_CASES,
                             ids=lambda c: "-".join(f"{k}{v}" for k, v in
                                                    c.items()))
    def test_matches_pallas_kernel_and_oracle(self, case):
        jargs, targs, jstate, tstate = _mlstm_tc_inputs(0, case)
        y, state = _mlstm_tensor_core_emulation(
            *targs, chunk=case["chunk"], initial_state=tstate)
        ref_y, ref_state = mlstm_ref(*jargs, initial_state=jstate)
        _mlstm_close(ref_y, y, "f32")
        _state_close(ref_state, state)
        if not case["init"]:   # the Pallas kernel starts from the empty state
            _mlstm_close(mlstm_scan_kernel(*jargs, chunk=case["chunk"],
                                           interpret=True), y, "f32")

    @pytest.mark.parametrize("seed", range(16))
    def test_within_the_kappa_bound_of_f64(self, seed):
        for case in (MLSTM_TC_CASES[0], MLSTM_TC_CASES[2]):
            assert _mlstm_worst_row_c(seed, case) <= 2.0

    @pytest.mark.parametrize("product", ["scores", "out", "state"])
    def test_each_product_on_tensor_cores_within_the_bound(self, product):
        """The kernel's route for each product: 3xTF32 alone on that
        product (the others f32) keeps the worst row of y within c = 2 of
        the kappa bound over seeds 0-15, and every element within the
        criterion."""
        case = MLSTM_TC_CASES[0]
        for seed in range(16):
            assert _mlstm_worst_row_c(seed, case, (product,)) <= 2.0

    def test_tf32_split(self):
        """hi keeps 10 mantissa bits, rounded to nearest with ties away
        from zero; hi + lo carries x to 2^-22 relative."""
        x = torch.from_numpy(np.random.default_rng(5).standard_normal(
            4096).astype(np.float32)) * 10.0
        hi = _tf32(x)
        lo = _tf32(x - hi)
        assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
        assert torch.all((x - hi).abs() <= x.abs() * 2.0 ** -11)
        assert torch.all((x.double() - hi.double() - lo.double()).abs()
                         <= x.double().abs() * 2.0 ** -22)
        tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
        assert _tf32(tie).tolist() == [1.0 + 2.0 ** -10,
                                       -(1.0 + 2.0 ** -10)]

    def test_prefix_argmax_stabiliser_is_the_row_max(self):
        """m_t from the prefix argmax of li_s - F_s is the plain version's
        max_s D[t,s] (both f32 on F summed exactly) to an f32 rounding."""
        case = MLSTM_TC_CASES[0]
        _, targs, _, _ = _mlstm_tc_inputs(3, case)
        got, want = {}, []
        _mlstm_tensor_core_emulation(*targs, chunk=case["chunk"], terms=got)
        mlstm_chunked_ref(*targs, chunk=case["chunk"], terms=want)
        m_t = torch.cat([t["m_t"] for t in want], 1)[:, :case["s"]]
        np.testing.assert_allclose(got["m_t"].numpy(), m_t.numpy(),
                                   rtol=0, atol=4e-6)

    def test_accumulation_per_k_step(self):
        """At K 512, hi.hi summed per K step of 32 and the cross terms
        apart sit nearer f64 than f32 fmas in one running sum, and at
        least 3x nearer than one running tensor-core sum of all terms."""
        rng = np.random.default_rng(6)
        a = torch.from_numpy(rng.standard_normal((64, 512)).astype(
            np.float32))
        b = torch.from_numpy(rng.standard_normal((512, 32)).astype(
            np.float32))
        exact = a.double() @ b.double()
        fma = torch.zeros(64, 32)
        for i in range(512):
            fma = (fma.double() + a[:, i:i + 1].double()
                   @ b[i:i + 1].double()).float()

        def err(x):
            return float((x.double() - exact).abs().mean())

        assert err(_mma3(a, b)) < err(fma)
        assert 3 * err(_mma3(a, b)) < err(_mma3(a, b, one_sum=True))
