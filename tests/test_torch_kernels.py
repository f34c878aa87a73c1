"""The port's kernel plain versions against the reference's kernels.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them to these plain versions there); here the plain versions are held to
the reference's jnp oracles over ``tests/test_kernels.py``'s shape sweeps,
and to the Pallas kernels in interpret mode on one small shape each.
Tolerances are ``tests/test_kernels.py``'s: 2e-4 in f32, 3e-2 in bf16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.flash_attention.flash_attention import flash_attention_kernel
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.paged_attention.paged_attention import paged_attention_kernel
from repro.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
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
