"""Prefill calls recorded as a CUDA graph and replayed
(``repro_torch.models.decode_graph.PrefillGraphs``, ``cfg.prefill_graphs``),
on the CPU: the bookkeeping of ``Model.prefill`` driven through a stand-in
for the capture and the replay, its results bit-equal to the eager
prefill's, and the default, every call eager."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config, smoke_config  # noqa: E402
from repro_torch.models import decode_graph  # noqa: E402
from repro_torch.models.model import Model, prefill  # noqa: E402

MAX_LEN = 32


def _put(dst, src):
    """Write every tensor of ``src`` into the same place of ``dst``."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _put(dst[k], src[k])
    else:
        for d, s in zip(dst, src):
            _put(d, s)


class _Graph:
    def __init__(self, call, owner):
        self.call, self.owner, self.out = call, owner, None

    def replay(self):
        self.owner.replays += 1
        _put(self.out, self.call())


class _StandIn:
    """A capture that records ``call`` and a replay that runs it again,
    writing what it returns into what the capture returned, as a graph's
    replay rewrites its outputs."""

    def __init__(self):
        self.captures, self.replays = 0, 0

    def capture(self, call, device):
        self.captures += 1
        graph = _Graph(call, self)
        graph.out = call()
        return graph, graph.out, None


@pytest.fixture
def stand_in(monkeypatch):
    """Prefill calls on the CPU taken for calls on the card."""
    fake = _StandIn()
    monkeypatch.setattr(decode_graph, "_on_card",
                        lambda t: not decode_graph.is_dtensor(t))
    monkeypatch.setattr(decode_graph, "_capturing", lambda: False)
    monkeypatch.setattr(decode_graph, "capture", fake.capture)
    return fake


def _model(arch="olmo-1b", keep=1, **extra):
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              prefill_graphs=keep, **extra)
    return Model(cfg, seed=0, device="cpu")


def _prompt(model, n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(1, model.cfg.vocab_size, (1, n), generator=gen)


def _how(model, tokens):
    before = dict(Model.prefill_calls)
    out = model.prefill(tokens, MAX_LEN)
    ran = [k for k, n in Model.prefill_calls.items() if n != before[k]]
    assert len(ran) == 1 and Model.prefill_calls[ran[0]] == before[ran[0]] + 1
    return ran[0], out


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("arch, extra", [
    ("olmo-1b", {}), ("deepseek-moe-16b", {}),
    ("deepseek-v3", dict(experts_held=4, experts_offset=4))])
def test_second_call_captures_later_replay_bit_equal(stand_in, arch, extra):
    model = _model(arch, **extra)
    hows = []
    for seed in range(4):
        tokens = _prompt(model, 12, seed)
        how, got = _how(model, tokens)
        hows.append(how)
        with torch.no_grad():
            want = prefill(model.params, model.cfg, tokens, MAX_LEN)
        assert _equal(got, want), (arch, seed, how)
    assert hows == ["eager", "captured", "replayed", "replayed"]
    assert (stand_in.captures, stand_in.replays) == (1, 3)


def test_returned_results_do_not_alias_the_next_calls(stand_in):
    model = _model()
    for seed in range(2):
        model.prefill(_prompt(model, 8, seed), MAX_LEN)
    logits, cache, total = model.prefill(_prompt(model, 8, 2), MAX_LEN)
    kept = [logits.clone(), cache["blocks"]["kv"]["k"].clone()]
    model.prefill(_prompt(model, 8, 3), MAX_LEN)
    assert torch.equal(logits, kept[0])
    assert torch.equal(cache["blocks"]["kv"]["k"], kept[1])
    assert total == 8


def test_the_least_recently_used_shape_goes(stand_in):
    model = _model(keep=1)
    a, b = _prompt(model, 8), _prompt(model, 9)
    assert [_how(model, t)[0] for t in (a, a, b, b, a, a)] == [
        "eager", "captured", "eager", "captured", "captured", "replayed"]
    assert len(model.prefill_graphs._graphs) == 1


@pytest.mark.parametrize("max_len", [MAX_LEN, 2 * MAX_LEN])
def test_max_len_is_part_of_the_key(stand_in, max_len):
    model = _model(keep=2)
    tokens = _prompt(model, 8)
    model.prefill(tokens, MAX_LEN)
    model.prefill(tokens, MAX_LEN)
    before = dict(Model.prefill_calls)
    model.prefill(tokens, max_len)
    ran = [k for k, n in Model.prefill_calls.items() if n != before[k]]
    assert ran == (["replayed"] if max_len == MAX_LEN else ["eager"])


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-moe-16b",
                                  "deepseek-v3"])
def test_every_prefill_eager_by_default(stand_in, arch):
    model = Model(smoke_config(get_config(arch)), seed=0, device="cpu")
    assert model.cfg.prefill_graphs == 0
    tokens = _prompt(model, 8)
    assert [_how(model, tokens)[0] for _ in range(3)] == ["eager"] * 3
    assert stand_in.captures == 0


def test_the_cpu_path_stays_eager():
    model = _model(keep=2)
    tokens = _prompt(model, 8)
    for _ in range(3):
        how, got = _how(model, tokens)
        assert how == "eager"
        with torch.no_grad():
            assert _equal(got, prefill(model.params, model.cfg, tokens,
                                       MAX_LEN))
