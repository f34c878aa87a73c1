"""A run with its timed path broken underneath reads ``correct`` false:
each fault a served cell can have, at smoke size on the CPU, judged by
the cell's own limit.  (A cell on one card has no exchange between
chips to leave out.)"""

import time
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

from portbench import serve, spec  # noqa: E402
from portbench.tests import smoke  # noqa: E402

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
#: the smoke window, on ``StepClock``: some 20 steps, so the requests it
#: finishes have made several decode steps
WINDOW_S = 1.0


class StepClock:
    """``serve``'s clock in the smoke runs: each reading moves it by one
    tick, so a window is a number of steps however loaded the CPU is."""

    def __init__(self, tick: float = 0.015):
        self.t, self.tick = 0.0, tick

    def perf_counter(self) -> float:
        self.t += self.tick
        return self.t

    time = staticmethod(time.time)


def _smoke_run(*args, **kw):
    with mock.patch.object(serve, "time", StepClock()):
        return serve.run_cell(*args, **kw)


def _run(cell: str, patch=None, seed: int = 2**31 + 9):
    w = spec.workload(spec.load_benchmark(), cell)
    return _smoke_run(smoke.config(w["config"]), smoke.mix(w["traffic"]),
                          seed, WINDOW_S, trace=False, device="cpu",
                          t0=time.time(), limits=spec.limits(cell),
                          patch=patch)


def state_unchanged(engine):
    """Each decode step works on a copy of the cache and returns the
    cache as it was."""
    real = engine.model.decode_step

    def step(caches, *args, **kw):
        def copy(tree):
            return ({k: copy(v) for k, v in tree.items()}
                    if isinstance(tree, dict) else tree.clone())
        logits, _ = real(copy(caches), *args, **kw)
        return logits, caches
    engine.model.decode_step = step


def half_batch(engine):
    """The second half of each decode step's rows is left out: those rows
    take the first half's answers."""
    real = engine.model.decode_step

    def step(*args, **kw):
        logits, caches = real(*args, **kw)
        logits = logits.clone()
        b = logits.shape[0]
        logits[b // 2:] = logits[:b - b // 2]
        return logits, caches
    engine.model.decode_step = step


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    got = _run(cell)
    assert got["correct"] is True, got["check"]
    assert got["failed"] == 0 and got["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_a_request_that_fills_the_cache_gets_every_token(cell):
    """Prompt and answer together as long as the cache (the mixes' 1k
    and 1k in 2048): no request is cut short."""
    w = spec.workload(spec.load_benchmark(), cell)
    mix = smoke.mix(w["traffic"])
    mix.update(prompt=dict(dist="uniform", min=16, max=16),
               output=dict(dist="uniform", min=16, max=16), max_len=32)
    got = _smoke_run(smoke.config(w["config"]), mix, 2**31 + 5,
                         WINDOW_S, trace=False, device="cpu",
                         t0=time.time(), limits=spec.limits(cell))
    assert got["failed"] == 0 and got["correct"] is True, got["check"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [state_unchanged, half_batch])
def test_a_broken_step_is_caught(cell, fault):
    got = _run(cell, patch=fault)
    assert got["correct"] is False, got["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_token_is_caught(cell, monkeypatch):
    from repro_torch.serving import engine as engine_mod
    real = engine_mod.sample

    def altered(logits, generator, params):
        tokens = real(logits, generator, params).clone()
        tokens[0] = (tokens[0] + 1) % logits.shape[-1]
        return tokens
    monkeypatch.setattr(engine_mod, "sample", altered)
    got = _run(cell)
    assert got["correct"] is False, got["check"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_reads_above_the_program(cell, seed):
    """The reference in float8 puts other tokens first than the program's
    bf16 path does: each number the cell compares reads higher for it
    (the chip's readings at the cell's size set the limit between)."""
    w = spec.workload(spec.load_benchmark(), cell)
    got = _smoke_run(smoke.config(w["config"]), smoke.mix(w["traffic"]),
                     seed, WINDOW_S, trace=False, device="cpu",
                     t0=time.time(), control=True)
    for name, entry in spec.limits(cell).items():
        if entry["limit"] is not None:
            assert got["check"]["control_" + name] > got["check"][name]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(card, cell):
    """On the card at the cell's own size, three seeds: the program within
    every limit, the float8 control above one of them."""
    bench = spec.load_benchmark()
    w = spec.workload(bench, cell)
    limits = spec.limits(cell)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        got = serve.run_cell(spec.config(bench, w["config"]),
                             spec.mix(w["traffic"]), seed,
                             bench["run_seconds"], trace=False,
                             device="cuda", t0=time.time(), limits=limits,
                             control=True)
        assert got["correct"] is True, got["check"]
        assert any(got["check"]["control_" + name] > c["limit"]
                   for name, c in got["compared"].items()), got["check"]
