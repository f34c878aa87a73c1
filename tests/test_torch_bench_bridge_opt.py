"""The port's bridge_opt bench (``repro_torch.bench.bridge_opt``) against
the reference's (``benchmarks/bench_bridge_opt.py``).

Both serve the smoke olmo-1b on the virtual clock: the five-variant
ablation, the fresh-share ladder and its stall attribution, the
compute-charged scheduling ladder at c = 2 and 8, the overlap guardrail
and slot-masked decode.  Every row equals the reference's: names in
order, values within 1e-9 relative, derived text equal.
``reference_rows.json``'s bridge_opt rows equal the fresh reference's.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_bench_run import (check_reference_section,  # noqa: E402
                                  check_row, row_names)

from repro_torch.bench import bridge_opt  # noqa: E402

#: the rows the bench states as claims (0/1): each must read 1
CLAIMS = ("bridge_opt/fresh_share_strictly_decreasing",
          "bridge_opt/conformance_pass", "obs/fresh_toll_monotone",
          "obs/serialization_monotone",
          "bridge_opt/ladder_worker_beats_flag_at_high_c",
          "bridge_opt/ladder_conformance_pass",
          "bridge_opt/overlap_guardrail_ok",
          "bridge_opt/slot_masked_beats_barrier",
          "bridge_opt/slot_masked_tokens_identical",
          "bridge_opt/slot_masked_conformance_pass")


@pytest.fixture(scope="module")
def lines():
    from benchmarks import bench_bridge_opt
    return {"reference": bench_bridge_opt.run(),
            "port": bridge_opt.run("cpu")}


@pytest.mark.parametrize("name", row_names("bridge_opt"))
def test_row_equals_reference(lines, name):
    check_row(name, lines["port"], lines["reference"])


def test_reference_rows_file_equals_fresh_reference(lines):
    check_reference_section("bridge_opt", lines["reference"])


@pytest.mark.parametrize("name", CLAIMS)
def test_claim_holds(lines, name):
    row = next(ln for ln in lines["port"] if ln.startswith(name + ","))
    assert float(row.split(",")[1]) == 1.0


def test_closure_and_deadline_flushes(lines):
    value = {ln.split(",")[0]: float(ln.split(",")[1]) for ln in lines["port"]}
    assert value["obs/closure_min"] >= 0.99
    assert value["bridge_opt/ladder_deadline_flushes"] > 0
