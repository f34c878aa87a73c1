"""The port's cluster bench (``repro_torch.bench.cluster``) against the
reference's (``benchmarks/bench_cluster.py``).

Both serve the smoke olmo-1b from confidential clusters on the virtual
clock: CC on / off throughput under the shared budget, least-loaded
against prefix-affinity warm TTFT, concurrent tenants.  No row depends on
the weights (each side draws its own), so every row equals the
reference's: names in order, values within 1e-9 relative, derived text
equal.  ``reference_rows.json``'s cluster rows equal the fresh
reference's.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_bench_run import (check_reference_section,  # noqa: E402
                                  check_row, row_names)

from repro_torch.bench import cluster  # noqa: E402
from repro_torch.trace.harness import smoke_model  # noqa: E402


@pytest.fixture(scope="module")
def lines():
    from benchmarks import bench_cluster
    return {"reference": bench_cluster.run(), "port": cluster.run("cpu")}


@pytest.mark.parametrize("name", row_names("cluster"))
def test_row_equals_reference(lines, name):
    check_row(name, lines["port"], lines["reference"])


def test_reference_rows_file_equals_fresh_reference(lines):
    check_reference_section("cluster", lines["reference"])


def test_rows_do_not_depend_on_the_weights(lines):
    """Another draw of the weights gives the same rows (the reason the
    comparison above needs no shared weights)."""
    model = smoke_model(device="cpu", seed=7)
    got = [f"{n},{v:.4f},{d}" for fn in (cluster.budget_throughput_rows,
                                         cluster.tenancy_rows)
           for n, v, d in fn(model)]
    want = [ln for ln in lines["port"]
            if not ln.startswith(("cluster/least_loaded", "cluster/prefix",
                                  "cluster/affinity"))]
    assert got == want
