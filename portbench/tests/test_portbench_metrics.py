import pytest

np = pytest.importorskip("numpy")

from portbench import spec, stats  # noqa: E402


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1001])
def test_percentile_over_every_sample(n):
    vals = list(np.random.default_rng(n).lognormal(0, 1, n))
    for q in (50, 95, 99):
        assert stats.percentile(vals, q) == pytest.approx(
            float(np.percentile(vals, q)), rel=1e-12)
    assert stats.percentile([], 95) is None


def _rec(**kw):
    rec = dict(tokens=0, window_s=1.0, ttft_s=[], itl_s=[], steps=[],
               setup_s=1.0, gateway=dict(crossings=0, bridge_s=0.0))
    rec.update(kw)
    return rec


def test_rate_is_over_the_whole_window():
    read = spec.reader("output_tok_s")
    assert read(_rec(tokens=900, window_s=30.0)) == pytest.approx(30.0)


def test_tails_take_every_sample():
    ttft = [(v / 10, False) for v in range(100)] + [(100.0, True)]
    rec = _rec(ttft_s=ttft, itl_s=ttft)
    want = stats.percentile([v for v, _ in ttft], 95) * 1e3
    assert spec.reader("ttft_p95_ms")(rec) == pytest.approx(want)
    assert spec.reader("itl_p95_ms")(rec) == pytest.approx(want)
    quiet = stats.percentile([v for v, p in ttft if not p], 95) * 1e3
    assert spec.reader("service.ttft_p95_ms.hostpaced")(rec) == \
        pytest.approx(quiet)


def test_per_step_readers():
    steps = [dict(t0=0.0, t1=0.1, profiled=False),
             dict(t0=0.1, t1=0.3, profiled=True),
             dict(t0=0.3, t1=0.4, profiled=False)]
    calls = [dict(kind="decode", host_s=0.02, lengths=[5], profiled=False),
             dict(kind="decode", host_s=0.05, lengths=[6], profiled=True),
             dict(kind="prefill", host_s=0.04, prompt=4, profiled=False)]
    rec = _rec(steps=steps, calls=calls,
               gateway=dict(crossings=9, bridge_s=0.006))
    assert spec.reader("engine.host_ms_per_step")(rec) == pytest.approx(
        (0.2 - 0.06) / 2 * 1e3)
    assert spec.reader("model.decode_host_ms")(rec) == pytest.approx(20.0)
    assert spec.reader("gateway.crossings_per_step")(rec) == 3
    assert spec.reader("gateway.modelled_bridge_ms_per_step")(rec) == \
        pytest.approx(2.0)


def test_readers_without_a_trace_return_nothing():
    rec = _rec(steps=[dict(t0=0, t1=1, profiled=False)], calls=[])
    for name in ("model.decode_device_ms", "kernel.paged_roofline",
                 "kernel.flash_roofline", "device.idle_share", "model.mfu"):
        assert spec.reader(name)(rec) is None


def test_union_of_intervals():
    assert stats.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert stats.merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]


def test_every_metric_has_a_reader():
    bench = spec.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for w in bench["workloads"]:
        for trace in (False, True):
            names = [m["name"] for m in spec.metrics(bench, w["name"], trace)]
            assert names, (w["name"], trace)
        assert "setup_s" in [m["name"] for m in
                             spec.metrics(bench, w["name"], False)]


def test_a_split_name_is_read_by_its_quantity():
    rec = _rec(tokens=900, window_s=30.0)
    assert spec.reader("output_tok_s.hostpaced")(rec) == pytest.approx(30.0)
    assert spec.reader("service.ttft_p95_ms.hostpaced").__module__ != \
        spec.reader("ttft_p95_ms").__module__
