"""The program's ranges on the profiler's clock (``repro_torch.obs.span``).

With ``torch.profiler`` off a range is one check and a shared no-op: an
engine step and a prefill enter no record function.  Under the CPU
profiler the engine, gateway and model open the named ranges, nested as
the work is (a tiny dense and a tiny MoE model), and the program keeps
their host totals by path.  The drain worker's thread records nothing:
the profiler's state is per thread.  Tokens do not depend on the
profiler.  ``moe_block`` counts a decode call's routed assignments and
computed slots from shapes.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.configs.base import get_config, smoke_config  # noqa: E402
from repro_torch.core.policy import (SchedulingPolicy,  # noqa: E402
                                     cc_aware_defaults)
from repro_torch.kernels import kernel_region  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import block_kind  # noqa: E402
from repro_torch.obs import ranges  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.sampler import SamplingParams  # noqa: E402

torch.set_num_threads(1)

SLOTS = 4
MAX_LEN = 48
ARCHS = ("olmo-1b", "deepseek-moe-16b")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = smoke_config(get_config(request.param))
    return Model(cfg, seed=0, device="cpu")


def _engine(model, policy=SchedulingPolicy.SYNC_DRAIN):
    defaults = dataclasses.replace(cc_aware_defaults(True), scheduling=policy)
    return ServingEngine(model, max_batch=SLOTS, max_len=MAX_LEN,
                         cc_on=True, defaults=defaults, seed=3,
                         device="cpu")


def _submit(engine, n=3, new_tokens=4):
    for i in range(n):
        engine.submit(Request(f"r{i}", prompt=list(range(1, 7 + 2 * i)),
                              sampling=SamplingParams(
                                  max_new_tokens=new_tokens)))


def _paths(prof) -> set:
    """The nesting of the program's ranges in a profile: each range's
    path of program ranges, outermost first."""
    out = set()
    for e in prof.events():
        if not e.name.startswith(("engine/", "gateway/", "model/",
                                  "kernel/")):
            continue
        path, p = [e.name], e.cpu_parent
        while p is not None:
            if p.name.startswith(("engine/", "gateway/", "model/",
                                  "kernel/")):
                path.insert(0, p.name)
            p = p.cpu_parent
        out.add(tuple(path))
    return out


class _Counting:
    """Counts the record functions entered: the op-scope ranges the
    program opens and user-scope ``record_function`` ranges."""

    def __init__(self, monkeypatch):
        self.n = 0
        fast = ranges._RecordFunctionFast
        counter = self

        class Fast:
            def __init__(self, *a, **kw):
                self._fn = fast(*a, **kw)

            def __enter__(self):
                counter.n += 1
                return self._fn.__enter__()

            def __exit__(self, *exc):
                return self._fn.__exit__(*exc)

        monkeypatch.setattr(ranges, "_RecordFunctionFast", Fast)
        enter = torch.autograd.profiler.record_function.__enter__

        def user_enter(rf):
            counter.n += 1
            return enter(rf)
        monkeypatch.setattr(torch.autograd.profiler.record_function,
                            "__enter__", user_enter)


def test_off_a_step_and_a_prefill_enter_no_record_function(model,
                                                           monkeypatch):
    engine = _engine(model)
    _submit(engine)
    counting = _Counting(monkeypatch)
    assert not torch._C._autograd._profiler_enabled()
    engine.step()                      # admissions (prefills) + a decode
    engine.step()                      # a packed decode step
    model.prefill(torch.ones((1, 5), dtype=torch.int64), MAX_LEN)
    assert engine.trace[-1].packed == 3
    assert counting.n == 0
    # the same counting sees the ranges once the profiler records
    with profile(activities=[ProfilerActivity.CPU]):
        engine.step()
    assert counting.n > 0
    engine.close()


def test_off_span_is_one_shared_noop():
    assert not torch._C._autograd._profiler_enabled()
    a, b = obs.span("engine/step"), obs.span("model/ffn", "r1")
    assert a is b
    with a as got:
        assert got is None


def _expected(moe: bool) -> set:
    step, admit = ("engine/step",), ("engine/step", "engine/admit")
    prefill = admit + ("model/prefill",)
    decode = step + ("engine/decode", "model/decode_step")
    want = {step, admit, admit + ("gateway/h2d",), admit + ("gateway/d2h",),
            prefill, step + ("engine/prep",),
            step + ("engine/prep", "gateway/batch_h2d"),
            step + ("engine/decode",), decode, step + ("engine/sample",),
            step + ("engine/drain",), step + ("engine/drain", "gateway/d2h"),
            step + ("engine/consume",)}
    for call in (prefill, decode):
        want |= {call + (n,) for n in ("model/embed", "model/attention",
                                       "model/ffn", "model/logits")}
        if moe:
            want |= {call + ("model/ffn", f"model/moe/{n}")
                     for n in ("route", "dispatch", "experts", "shared")}
    return want


def test_profiled_steps_open_the_named_ranges_nested(model):
    moe = model.cfg.n_routed_experts > 0
    engine = _engine(model)
    _submit(engine)
    obs.clear_totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.step()
        engine.step()
    got = _paths(prof)
    want = _expected(moe)
    assert want <= got, sorted(want - got)
    # nothing else: every program range is one of the named ones
    assert got == want, sorted(got - want)
    # the program's own totals hold the same paths, with entries
    totals = obs.totals()
    assert set(totals) == want
    assert totals[("engine/step",)][1] == 2
    assert totals[("engine/step", "engine/admit")][1] == 3
    n_layers = model.cfg.n_layers
    decode = ("engine/step", "engine/decode", "model/decode_step")
    assert totals[decode][1] == 2
    assert totals[decode + ("model/attention",)][1] == 2 * n_layers
    assert totals[decode + ("model/ffn",)][1] == 2 * n_layers
    inner = sum(s for p, (s, _) in totals.items()
                if len(p) == 4 and p[:3] == decode)
    assert inner <= totals[decode][0]
    obs.clear_totals()
    assert obs.totals() == {}
    engine.close()


def test_admission_range_carries_the_request_id(model):
    engine = _engine(model)
    _submit(engine, n=2)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        engine.step()
    ids = sorted(e.kwinputs.get("args") for e in prof.events()
                 if e.name == "engine/admit")
    assert ids == ["r0", "r1"]
    engine.close()


def test_worker_drain_records_no_range_on_its_thread(model):
    """Under ``WORKER_DRAIN`` the drain's copy runs on the worker thread,
    started before the profiler: the profiler's state is per thread, so
    it records no ``gateway/d2h`` there.  The engine thread's
    ``engine/drain`` (the hand-off and the wait) is recorded."""
    engine = _engine(model, SchedulingPolicy.WORKER_DRAIN)
    assert engine._worker is not None
    _submit(engine)
    engine.step()
    seen = []
    d2h = engine.gateway.d2h

    def spy(*a, **kw):
        seen.append(torch._C._autograd._profiler_enabled())
        return d2h(*a, **kw)
    engine.gateway.d2h = spy
    obs.clear_totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.step()
    assert seen == [False]
    got = _paths(prof)
    assert ("engine/step", "engine/drain") in got
    assert not any(p[-1] == "gateway/d2h" for p in got)
    assert not any(p[-1] == "gateway/d2h" for p in obs.totals())
    engine.close()


def test_tokens_do_not_depend_on_the_profiler(model):
    def serve(profiled):
        engine = _engine(model)
        _submit(engine, n=5, new_tokens=5)
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]):
                engine.run()
        else:
            engine.run()
        engine.close()
        return {r.request_id: list(r.output_tokens)
                for r in engine.finished}
    off, on = serve(False), serve(True)
    assert len(off) == 5 and on == off


def test_moe_decode_counts_assignments_and_slots():
    cfg = smoke_config(get_config("deepseek-moe-16b"))
    model = Model(cfg, seed=0, device="cpu")
    engine = _engine(model)
    _submit(engine, new_tokens=8)
    engine.step()                      # admissions: prefills do not count
    a0, s0 = (layers.moe_block.decode_assignments,
              layers.moe_block.decode_slots)
    steps = 3
    for _ in range(steps):
        engine.step()
    moe_layers = sum(block_kind(cfg, i) == "moe"
                     for i in range(cfg.n_layers))
    # every packed step runs the engine's max_batch rows; capacity = rows
    calls = steps * moe_layers
    k, e = cfg.moe_top_k, cfg.n_routed_experts
    assert layers.moe_block.decode_assignments - a0 == calls * SLOTS * k
    assert layers.moe_block.decode_slots - s0 == calls * e * SLOTS
    engine.close()


def test_moe_block_counts_only_no_drop_calls():
    cfg = smoke_config(get_config("deepseek-moe-16b"))
    p = layers.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, 5, cfg.d_model).to(cfg.dtype)
    a0, s0 = (layers.moe_block.decode_assignments,
              layers.moe_block.decode_slots)
    layers.moe_block(p, x, cfg, capacity_factor=1.25, no_drop=False)
    assert (layers.moe_block.decode_assignments,
            layers.moe_block.decode_slots) == (a0, s0)
    layers.moe_block(p, x, cfg, no_drop=True)
    t, k, e = 10, cfg.moe_top_k, cfg.n_routed_experts
    assert layers.moe_block.decode_assignments - a0 == t * k
    assert layers.moe_block.decode_slots - s0 == e * t


def test_kernel_region_opens_a_kernel_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with kernel_region("paged_attention"):
            torch.ones(2).add_(1)
    names = [e.name for e in prof.events()]
    assert "kernel/paged_attention" in names
    # the roofline readers match kernel names by these fragments
    assert not any("paged_split_kernel" in n or "flash_fwd_kernel" in n
                   for n in names)


def test_totals_add_up_by_path():
    obs.clear_totals()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with obs.span("engine/step"):
                with obs.span("engine/drain"):
                    pass
        with obs.span("engine/drain"):
            pass
    totals = obs.totals()
    assert totals[("engine/step",)][1] == 3
    assert totals[("engine/step", "engine/drain")][1] == 3
    assert totals[("engine/drain",)][1] == 1
    assert totals[("engine/step",)][0] >= \
        totals[("engine/step", "engine/drain")][0] > 0
    obs.clear_totals()
