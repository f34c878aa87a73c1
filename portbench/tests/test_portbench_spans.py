"""The reading of the program's ranges (``portbench/spans.py``) and the
readers of the metrics they feed, on hand-built events and totals."""

import sys
import types

import pytest

from portbench import spans as S
from portbench import spec


def _range(name, start, end, corr, thread=1):
    return dict(kind="range", name=name, start=start, end=end,
                thread=thread, corr=corr, link=0)


def _device(name, start, end, link):
    return dict(kind="device", name=name, start=start, end=end, thread=0,
                corr=0, link=link)


def _annotation(name, start, end):
    return dict(kind="annotation", name=name, start=start, end=end,
                thread=0, corr=0, link=0)


#: one decode step, in microseconds: an aten GEMM inside
#: ``model/attention``, a kernel launched through ctypes inside
#: ``kernel/paged_attention`` (no aten op around its launch), a copy
#: launched from ``engine/drain``
STEP = [
    _range("engine/step", 0, 1000, 1),
    _range("engine/decode", 10, 600, 2),
    _range("model/decode_step", 20, 590, 3),
    _range("model/attention", 30, 300, 4),
    _range("aten::mm", 40, 50, 5),
    _range("kernel/paged_attention", 100, 120, 6),
    _range("model/ffn", 300, 580, 7),
    _range("aten::mm", 310, 320, 8),
    _range("engine/drain", 700, 990, 9),
    _range("aten::copy_", 710, 980, 10),
    _device("gemm_qkv", 60, 160, link=5),
    _device("paged_split_kernel_192", 160, 400, link=6),
    _device("gemm_ffn", 400, 650, link=8),
    _device("memcpy_dtoh", 900, 910, link=10),
]


def test_an_annotation_is_no_device_operation():
    with_ann = STEP + [_annotation("engine/step", 0, 1000),
                       _annotation("model/ffn", 300, 900)]
    assert S.busy(with_ann) == S.busy(STEP) == [[60, 650], [900, 910]]
    assert S.read(with_ann) == S.read(STEP)
    assert S.idle(with_ann) == S.idle(STEP)


def test_device_time_goes_to_the_range_open_at_its_launch():
    rec = S.read(STEP)
    attn = ("engine/step", "engine/decode", "model/decode_step",
            "model/attention")
    # the aten GEMM's launch is inside model/attention
    assert rec[attn][2] == pytest.approx(100e-6)
    # the ctypes launch has no aten op: its own range takes it
    assert rec[attn + ("kernel/paged_attention",)][2] == \
        pytest.approx(240e-6)
    assert rec[attn[:3] + ("model/ffn",)][2] == pytest.approx(250e-6)
    assert rec[("engine/step", "engine/drain")][2] == pytest.approx(10e-6)
    # host seconds and entries of each path
    assert rec[attn][:2] == [pytest.approx(270e-6), 1]
    # inclusive sums over paths
    assert S.seconds(rec, "model/attention", column=2) == \
        pytest.approx(100e-6)
    assert S.seconds(rec, "kernel/paged_attention", column=2,
                     under="model/attention") == pytest.approx(240e-6)
    total = sum(e["end"] - e["start"] for e in STEP
                if e["kind"] == "device") * 1e-6
    assert sum(v[2] for v in rec.values()) == pytest.approx(total)


def test_a_launch_with_no_host_record_is_unattributed():
    rec = S.read(STEP + [_device("orphan", 1200, 1300, link=0)])
    assert rec[()][2] == pytest.approx(100e-6)


def test_ranges_on_two_threads_stay_apart():
    events = STEP + [_range("gateway/d2h", 700, 990, 20, thread=2),
                     _range("aten::copy_", 705, 985, 21, thread=2),
                     _device("memcpy_worker", 950, 960, link=21)]
    rec = S.read(events)
    assert rec[("gateway/d2h",)][2] == pytest.approx(10e-6)
    assert rec[("engine/step", "engine/drain")][2] == pytest.approx(10e-6)


def test_idle_by_innermost_range_and_inside_the_drain():
    idle = S.idle(STEP)
    # one gap, 650..900, whose middle (775) the host spends in the drain
    assert idle == {"engine/drain": pytest.approx(250e-6)}
    # the drain (700..990) overlaps the gap for 200 us
    assert S.idle_inside(STEP, "engine/drain") == pytest.approx(200e-6)
    assert S.idle_inside(STEP, "model/ffn") == 0.0
    # a gap where no program range is open
    late = STEP + [_device("late", 1500, 1510, link=0)]
    assert S.idle(late)[""] == pytest.approx(590e-6)


@pytest.fixture
def program(monkeypatch):
    """A stand-in for the program's modules in ``sys.modules``: the
    range totals and the MoE block's counters."""
    ranges = types.ModuleType("repro_torch.obs.ranges")
    totals = {}
    ranges.totals = lambda: dict(totals)
    layers = types.ModuleType("repro_torch.models.layers")

    def moe_block():
        pass
    moe_block.decode_assignments, moe_block.decode_slots = 384, 4096
    layers.moe_block = moe_block
    monkeypatch.setitem(sys.modules, "repro_torch.obs.ranges", ranges)
    monkeypatch.setitem(sys.modules, "repro_torch.models.layers", layers)
    return totals, moe_block


def _step_totals(totals, steps=2):
    d = ("engine/step", "engine/decode", "model/decode_step")
    a = ("engine/step", "engine/admit", "model/prefill")
    totals.update({
        ("engine/step",): (0.100 * steps, steps),
        ("engine/step", "engine/admit"): (0.030, 1),
        a: (0.025, 1),
        a + ("model/attention",): (0.010, 4),
        ("engine/step", "engine/decode"): (0.050 * steps, steps),
        d: (0.048 * steps, steps),
        d + ("model/attention",): (0.020 * steps, 4 * steps),
        d + ("model/ffn",): (0.025 * steps, 4 * steps),
        ("engine/step", "engine/drain"): (0.012 * steps, steps),
        ("engine/step", "engine/drain", "gateway/d2h"): (0.001, 1),
    })


def test_readers_of_the_program_spans(program):
    totals, _ = program
    _step_totals(totals)
    read = {n: spec.reader(n)({}) for n in (
        "engine.drain_ms_per_step", "engine.self_ms_per_step",
        "model.attention_host_ms", "model.ffn_host_ms",
        "model.prefill_host_ms")}
    assert read["engine.drain_ms_per_step"] == pytest.approx(12.0)
    # 200 ms of steps less a 25 ms prefill, 96 ms of decode, 24 of drain
    assert read["engine.self_ms_per_step"] == pytest.approx(
        (200 - 25 - 96 - 24) / 2)
    # the prefill's attention is not the decode call's
    assert read["model.attention_host_ms"] == pytest.approx(20.0)
    assert read["model.ffn_host_ms"] == pytest.approx(25.0)
    assert read["model.prefill_host_ms"] == pytest.approx(25.0)
    # the suffixed names read through the same files
    assert spec.reader("model.ffn_host_ms.hostpaced")({}) == \
        pytest.approx(25.0)


def test_slot_use_reads_the_counters(program):
    assert spec.reader("model.moe_slot_use.hostpaced")({}) == \
        pytest.approx(9.375)


NEW = ("engine.drain_ms_per_step", "engine.self_ms_per_step",
       "model.attention_host_ms", "model.ffn_host_ms",
       "model.prefill_host_ms", "model.moe_slot_use")


@pytest.mark.parametrize("name", NEW)
def test_new_readers_read_nothing_from_a_program_without_them(
        name, monkeypatch):
    # the parent's program: no totals, no counters
    monkeypatch.setitem(sys.modules, "repro_torch.obs.ranges",
                        types.ModuleType("repro_torch.obs.ranges"))
    monkeypatch.setitem(sys.modules, "repro_torch.models.layers",
                        types.ModuleType("repro_torch.models.layers"))
    assert spec.reader(name)({}) is None
    monkeypatch.delitem(sys.modules, "repro_torch.obs.ranges")
    monkeypatch.delitem(sys.modules, "repro_torch.models.layers")
    assert spec.reader(name)({}) is None


@pytest.mark.parametrize("name", NEW)
def test_new_readers_read_nothing_from_an_empty_slice(name, program):
    _, block = program
    block.decode_assignments = block.decode_slots = 0
    assert spec.reader(name)({}) is None
