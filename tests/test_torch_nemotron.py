"""nemotron-4-340b's attention layout on the port: the paged kernel's
D = 192 instantiation and GQA 96/8.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it to its
plain version there at nemotron's full layout).  Here: the wrapper's
``HEAD_DIMS`` against the source's dispatch switch, and the D = 192
instantiation's arithmetic, emulated on the CPU with its row groups (24
chunks a row on 32 lanes: 4 row groups of one warp each) and its split
plan, against the reference's Pallas kernel in interpret mode, its jnp
oracle and the plain version, with ``tests/test_kernels.py``'s
tolerances (2e-4 in f32, 3e-2 in bf16).
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.paged_attention.paged_attention import (  # noqa: E402
    paged_attention_kernel)
from repro.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref as paged_ref_torch)

from test_torch_kernels import (DTYPES, _close, _paged_case,  # noqa: E402
                                _paged_split_emulation)

#: (b, h, kv, d, page, pages_max, n_pages): nemotron's 12 query heads a KV
#: head (two head groups of the kernel's 8) at D = 192, and one KV head
NEMOTRON_SHAPES = [(2, 24, 2, 192, 16, 4, 12), (3, 12, 1, 192, 8, 6, 20)]


def test_paged_head_dims_match_the_cuda_switch():
    """The wrapper's ``HEAD_DIMS`` and the instantiations the CUDA source's
    dispatch ``switch`` names are the same dims, nemotron-4-340b's 192
    among them; the lanes of a row are D/8 rounded up to a power of
    two."""
    src = open(os.path.join(os.path.dirname(pa_ops.__file__), "csrc",
                            "paged_attention.cu")).read()
    cases = sorted(int(d) for d in re.findall(
        r"case (\d+): return launch_d<\1>", src))
    assert tuple(cases) == pa_ops.HEAD_DIMS
    full = get_config("nemotron-4-340b")
    assert full.head_dim == 192 and full.head_dim in pa_ops.HEAD_DIMS
    assert full.n_heads // full.n_kv_heads > pa_ops.HEADS_PER_BLOCK
    assert "lanes_per_row<D>()" in src


def test_split_plan_unchanged_for_nemotron():
    """The split plan depends on the pool's rows, KV, pages_max and page
    only: at nemotron's decode (a pool of 8 rows, KV 8, 64 pages of 16) it
    is 4 pages, as for every pool of up to 8 rows, and every call on the
    8-row pool gets it whatever rows it packs (the token invariant on the
    card rests on it)."""
    for rows in range(1, 9):
        assert pa_ops.pages_per_split(rows, 8, 64, 16) == 4
    k_pages = torch.empty(8 * 64, 16, 8, 192, device="meta")
    for b in range(1, 9):
        tables = torch.zeros(b, 64, dtype=torch.int32)
        assert pa_ops.split_plan(k_pages, tables) == 4


@pytest.mark.parametrize("b,h,kv,d,page,pages_max,n_pages", NEMOTRON_SHAPES)
@pytest.mark.parametrize("pps", [1, 4, None])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_d192_arithmetic_matches_pallas_kernel_and_oracle(
        b, h, kv, d, page, pages_max, n_pages, pps, dt):
    jargs, targs = _paged_case(np.random.default_rng(24), dt, b, h, kv, d,
                               page, pages_max, n_pages)
    out = _paged_split_emulation(*targs, pps or pages_max)
    got = out.to(DTYPES[dt][2])
    tol = DTYPES[dt][3]
    _close(paged_attention_kernel(*jargs, interpret=True), got, tol)
    _close(paged_attention_ref(*jargs), got, tol)
    plain = paged_ref_torch(*(t.float() if t.is_floating_point() else t
                              for t in targs))
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=2e-4)


def test_wrapper_takes_d192_on_the_cpu():
    """On the CPU the wrapper runs its plain version at D = 192 and counts
    no launch."""
    _, targs = _paged_case(np.random.default_rng(3), "bf16", 2, 24, 2, 192,
                           16, 4, 8)
    before = pa_ops.paged_attention.launches
    out = pa_ops.paged_attention(*targs)
    assert pa_ops.paged_attention.launches == before
    assert torch.equal(out, paged_ref_torch(*targs))
