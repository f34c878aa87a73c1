"""The port's analytic paper benches (``repro_torch.bench.{bridge,serving,
loader,offload,fabric}``) and their workloads against the reference's
(``benchmarks/bench_*.py``, ``benchmarks/workloads.py``).

Every row's name and derived text equal the reference's and every value
is within 1e-9 relative, both as ``rows()`` returns them and as ``run()``
prints them.  The calibrated workloads' fitted fields equal the
reference's.  The serving bench's arbitration patch restores the
simulator's ``ARB_ON_MS`` when the pricing raises (the reference's copy
does not).
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from benchmarks import (bench_bridge, bench_fabric, bench_loader,  # noqa: E402
                        bench_offload, bench_serving)
from benchmarks import workloads as JW  # noqa: E402
from repro_torch.bench import REL_TOL  # noqa: E402
from repro_torch.bench import (bridge, fabric, loader, offload,  # noqa: E402
                               serving)
from repro_torch.bench import workloads as TW  # noqa: E402
from repro_torch.core import simulator as TS  # noqa: E402

#: (port module, reference module)
PAIRS = {
    "bridge": (bridge, bench_bridge),
    "loader": (loader, bench_loader),
    "fabric": (fabric, bench_fabric),
    "serving": (serving, bench_serving),
    "offload": (offload, bench_offload),
}

SERVING_PARTS = ("serving_matrix_rows", "accounting_rows",
                 "patch_refutation_rows", "inversion_rows",
                 "worker_drain_rows", "compute_window_rows")


@pytest.fixture(scope="module")
def reference():
    """Every reference output, computed once: ``run()`` lines and the row
    tuples of each part."""
    out = {name: {"run": ref.run()} for name, (_, ref) in PAIRS.items()}
    for name in ("bridge", "loader", "fabric"):
        out[name]["rows"] = PAIRS[name][1].rows()
    for part in SERVING_PARTS:
        out["serving"][part] = getattr(bench_serving, part)()
    out["offload"]["spill"] = bench_offload.spill_volume_rows()
    out["offload"]["churn"] = bench_offload.churn_ttft_rows()
    return out


def _same_rows(got, want):
    assert [r[0] for r in got] == [r[0] for r in want]
    for (name, gv, gd), (_, wv, wd) in zip(got, want):
        assert math.isclose(gv, wv, rel_tol=REL_TOL, abs_tol=1e-300), name
        assert gd == wd, name


@pytest.mark.parametrize("name", ["bridge", "loader", "fabric"])
def test_rows_equal_reference(reference, name):
    port = PAIRS[name][0]
    _same_rows(port.rows(), reference[name]["rows"])


@pytest.mark.parametrize("part", SERVING_PARTS)
def test_serving_rows_equal_reference(reference, part):
    _same_rows(getattr(serving, part)(), reference["serving"][part])


def test_offload_rows_equal_reference(reference):
    _same_rows(offload.spill_volume_rows("cpu"), reference["offload"]["spill"])
    _same_rows(offload.churn_ttft_rows(), reference["offload"]["churn"])


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_printed_lines_equal_reference(reference, name):
    port = PAIRS[name][0]
    got = port.run("cpu") if name == "offload" else port.run()
    assert got == reference[name]["run"]


def _fields(w) -> dict:
    return {f.name: getattr(w, f.name) for f in dataclasses.fields(w)}


def _same_workload(got, want):
    g, w = _fields(got), _fields(want)
    assert list(g) == list(w)
    for key in g:
        if isinstance(w[key], float):
            assert math.isclose(g[key], w[key], rel_tol=REL_TOL,
                                abs_tol=1e-300), key
        else:
            assert g[key] == w[key], key


@pytest.mark.parametrize("fit", ["qwen27b_c128", "h200_boundary"])
def test_workload_fits_equal_reference(fit):
    _same_workload(getattr(TW, fit)(), getattr(JW, fit)())


@pytest.mark.parametrize("fit", ["sweep_workloads",
                                 "serving_matrix_workloads"])
def test_workload_tables_equal_reference(fit):
    got, want = getattr(TW, fit)(), getattr(JW, fit)()
    assert list(got) == list(want)
    for key in got:
        _same_workload(got[key], want[key])


def test_workload_constants_equal_reference():
    assert TW.SERVING_MATRIX == JW.SERVING_MATRIX
    assert TW.PROFILE_TPOT == JW.PROFILE_TPOT
    assert TW.PROFILE_OP_CLASSES == JW.PROFILE_OP_CLASSES
    assert TW.PAPER_KV_LEN == JW.PAPER_KV_LEN


def test_arbitration_restored_after_a_patch_raises(monkeypatch):
    """A pricing that raises under a patched arbitration leaves
    ``ARB_ON_MS`` as it was, and later prices unchanged."""
    original = TS.ARB_ON_MS
    before = serving.patch_refutation_rows()
    real = serving.tpot_ms

    def raises_when_patched(*a):
        if TS.ARB_ON_MS != original:
            raise RuntimeError("patched pricing failed")
        return real(*a)
    monkeypatch.setattr(serving, "tpot_ms", raises_when_patched)
    with pytest.raises(RuntimeError, match="patched pricing failed"):
        serving.patch_refutation_rows()
    assert TS.ARB_ON_MS == original
    monkeypatch.setattr(serving, "tpot_ms", real)
    assert serving.patch_refutation_rows() == before
