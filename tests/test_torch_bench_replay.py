"""The port's bridge-tape replay bench (``repro_torch.bench.replay``)
against the reference's (``benchmarks/bench_replay.py``).

Both record the golden harness's async CC-on run on the virtual clock's
``tpu-v5e`` bridge profile and reprice it seven ways.  Every row equals
the reference's: names in order, values within 1e-9 relative, derived
text equal; ``replay/counterfactuals_per_engine_run`` is host wall time
and exempt.  ``reference_rows.json``'s replay rows equal the fresh
reference's.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_bench_run import (check_reference_section,  # noqa: E402
                                  check_row, row_names)

from repro_torch.bench import replay  # noqa: E402


@pytest.fixture(scope="module")
def lines():
    from benchmarks import bench_replay
    return {"reference": bench_replay.run(), "port": replay.run("cpu")}


@pytest.mark.parametrize("name", row_names("replay"))
def test_row_equals_reference(lines, name):
    check_row(name, lines["port"], lines["reference"])


def test_reference_rows_file_equals_fresh_reference(lines):
    check_reference_section("replay", lines["reference"])


def test_profile_is_the_virtual_clock_s(lines):
    """The recorded tape's profile is the modelled tpu-v5e bridge."""
    assert lines["port"][0].endswith("one async cc-on engine run on tpu-v5e")
