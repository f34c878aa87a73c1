"""The port's cost counter (``launch/cost_analysis.py``) against analytic
ground truth: every case of ``tests/test_hlo_analysis.py``, with the same
counts.

PyTorch has no while loop: where the reference scans, the port loops in
Python, so each pass is counted by itself and ``trip_counts`` holds the
passes a loop reports (``kernels.note_loop``).  Collectives run on a
process group of the "fake" backend, opened in the test and destroyed on
its exit.
"""

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.kernels import kernel_region, note_loop  # noqa: E402
from repro_torch.launch import cost_analysis  # noqa: E402
from repro_torch.launch.mesh import fake_world  # noqa: E402


def analyze(fn, *args):
    return cost_analysis.analyze(fn, *args)


def looped(n: int):
    """``n`` chained products, as the reference's ``lax.scan`` of length
    ``n``: the loop reports its passes."""
    def f(a):
        note_loop("scan", n)
        c = a
        for _ in range(n):
            c = c @ c
        return c
    return f


class TestFlops:
    def test_single_matmul(self):
        x = torch.zeros((256, 256))
        r = analyze(lambda a, b: a @ b, x, x)
        assert r["flops"] == pytest.approx(2 * 256 ** 3, rel=0.01)

    def test_looped_matmul_counts_every_pass(self):
        x = torch.zeros((256, 256))
        r = analyze(looped(12), x)
        assert r["flops"] == pytest.approx(12 * 2 * 256 ** 3, rel=0.02)
        assert 12 in r["trip_counts"]

    def test_nested_loop(self):
        x = torch.zeros((128, 128))

        def f(a):
            note_loop("outer", 5)
            for _ in range(5):
                a = looped(3)(a)
            return a
        r = analyze(f, x)
        assert r["flops"] == pytest.approx(15 * 2 * 128 ** 3, rel=0.05)
        assert r["trip_counts"] == [5] + [3] * 5

    def test_rectangular_dot_contraction(self):
        a = torch.zeros((64, 512))
        b = torch.zeros((512, 32))
        r = analyze(lambda x, y: x @ y, a, b)
        assert r["flops"] == pytest.approx(2 * 64 * 512 * 32, rel=0.01)

    def test_batched_and_einsum_products(self):
        """``einsum`` and ``bmm`` reach the counter as the products they
        decompose into."""
        a, b = torch.zeros((4, 64, 32)), torch.zeros((4, 32, 16))
        r = analyze(lambda x, y: torch.einsum("bij,bjk->bik", x, y), a, b)
        assert r["flops"] == pytest.approx(2 * 4 * 64 * 32 * 16, rel=0.01)


class TestBytes:
    def test_matmul_bytes(self):
        x = torch.zeros((512, 512))
        r = analyze(lambda a, b: a @ b, x, x)
        assert r["bytes_accessed"] == pytest.approx(3 * 512 * 512 * 4,
                                                    rel=0.05)

    def test_loop_bytes_scale_with_passes(self):
        x = torch.zeros((256, 256))

        def f(n):
            return analyze(looped(n), x)["bytes_accessed"]
        assert f(16) > 3 * f(4)

    def test_views_and_copies(self):
        """A view touches nothing; a copy counts in ``bytes_accessed`` and
        not in ``bytes_accessed_no_copy``."""
        x = torch.zeros((256, 256))
        r = analyze(lambda a: a.t().unsqueeze(0)[:, :10], x)
        assert r["bytes_accessed"] == 0
        r = analyze(lambda a: a.clone(), x)
        assert r["bytes_accessed"] == 2 * 256 * 256 * 4
        assert r["bytes_accessed_no_copy"] == 0

    def test_gather_reads_rows_not_table(self):
        """An embedding lookup reads the rows it returns, as the
        reference's analyser prices a gather."""
        table = torch.zeros((10000, 64))
        idx = torch.arange(8)
        r = analyze(lambda t, i: t[i], table, idx)
        assert r["bytes_accessed"] == 2 * 8 * 64 * 4 + 8 * 8


class TestMarkedRegions:
    def test_region_attribution(self):
        x = torch.zeros((256, 256))

        def f(a, b):
            with kernel_region("test_region"):
                y = a @ b
            return y + a
        r = analyze(f, x, x)
        assert "test_region" in r["marked_bytes"]
        assert r["marked_bytes"]["test_region"] >= 3 * 256 * 256 * 4 * 0.9
        assert r["region_entries"] == {"test_region": 1}

    def test_wrapper_marks_its_region_on_meta(self):
        """A kernel wrapper given meta tensors runs its plain version inside
        its region: the counter attributes that work to the kernel."""
        from repro_torch.kernels.flash_attention import ops as fa
        q = torch.empty((1, 64, 4, 32), dtype=torch.bfloat16, device="meta")
        r = analyze(lambda: fa.flash_attention(q, q, q, causal=True))
        assert r["region_entries"] == {"flash_attention": 1}
        assert r["marked_bytes"]["flash_attention"] == r["bytes_accessed"]
        assert r["flops"] == pytest.approx(2 * 2 * 4 * 64 * 64 * 32)


class TestCollectives:
    def test_all_reduce_counted(self):
        """An all-reduce on a fake group of 2 counts its tensor's bytes
        (the reference skips this case with one host device)."""
        with fake_world(2):
            x = torch.ones(1024)
            r = analyze(lambda: dist.all_reduce(x))
        assert r["collectives"]["bytes"]["all-reduce"] == 1024 * 4
        assert r["collectives"]["counts"]["all-reduce"] == 1
        assert r["collectives"]["total_bytes"] == 1024 * 4

    def test_sharded_matmul_counts_per_device(self):
        """A product sharded 4 ways: each rank's counter sees a quarter of
        the flops, and the all-gather DTensor issues to replicate the
        result."""
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate, Shard
        with fake_world(4):
            mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
            a = DTensor.from_local(torch.zeros((64, 256)), mesh, [Shard(0)],
                                   run_check=False)
            b = DTensor.from_local(torch.zeros((256, 256)), mesh,
                                   [Replicate()], run_check=False)
            r = analyze(lambda: (a @ b).redistribute(mesh, [Replicate()]))
        assert r["flops"] == pytest.approx(2 * 256 ** 3 / 4, rel=0.01)
        assert r["collectives"]["bytes"]["all-gather"] == 256 * 256 * 4
