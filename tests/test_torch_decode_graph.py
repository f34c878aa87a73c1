"""Decode calls recorded once as a CUDA graph and replayed
(``repro_torch.models.decode_graph``), on the CPU: the rotary frequencies
built once and bit-equal to the per-call expression they replace, the
bookkeeping of ``Model.decode_step`` driven through a stand-in for the
capture and the replay, and the CPU path, eager and bit-equal."""

import contextlib
import gc
import math
import weakref

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import all_configs, get_config, smoke_config  # noqa: E402
from repro_torch.kernels import HOST_COUNTERS, _LISTENERS  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.models import decode_graph  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import Model, decode_step  # noqa: E402
from repro_torch.training.optimizer import leaves  # noqa: E402

ROWS, MAX_LEN = 4, 32


def _old_rope_table(positions, dim, theta):
    """``layers.rope_table`` as it built its frequencies on every call."""
    half = dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exponent)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def _rope_cases():
    cases = set()
    for name, cfg in sorted(all_configs().items()):
        for c in (cfg, smoke_config(cfg)):
            cases.add((c.head_dim, float(c.rope_theta)))
            if c.use_mla:
                cases.add((c.rope_head_dim, float(c.rope_theta)))
    return sorted(cases)


@pytest.mark.parametrize("dim, theta", _rope_cases())
def test_rope_table_bit_equal_to_the_per_call_build(dim, theta):
    positions = torch.tensor([[0, 1, 2, 1023, 4095], [7, 64, 511, 2047, 9]])
    for _ in range(2):                  # built, then read from the cache
        got = layers.rope_table(positions, dim, theta)
        want = _old_rope_table(positions, dim, theta)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert layers.rope_freqs(dim, theta, "cpu") is layers.rope_freqs(
        dim, theta, torch.device("cpu"))


class _StandIn:
    """A capture that records ``call`` and a replay that runs it again,
    writing what it returns into the tensor the capture returned, as a
    graph's replay rewrites its outputs; no host counter moves in a replay,
    as no Python runs in a real one.  Each capture hands back a buffer of
    its own for split tickets (``tickets``)."""

    def __init__(self):
        self.captures, self.replays, self.graphs = 0, 0, []
        self.tickets = []

    def capture(self, call, device):
        self.captures += 1
        graph = _Graph(call, self)
        graph.out = call()
        self.graphs.append(graph)
        self.tickets.append(torch.zeros(self.captures, dtype=torch.int32))
        return graph, graph.out, self.tickets[-1]

    def release(self):
        """Drop the recorded calls, whose closures hold the caches: a real
        graph keeps no Python reference to what it reads."""
        for graph in self.graphs:
            graph.call = None


class _Graph:
    def __init__(self, call, owner):
        self.call, self.owner, self.out = call, owner, None

    def replay(self):
        self.owner.replays += 1
        held = list(HOST_COUNTERS)
        before = [getattr(o, n) for o, n in held]
        self.out.copy_(self.call())
        for (o, n), v in zip(held, before):
            setattr(o, n, v)


@pytest.fixture
def stand_in(monkeypatch):
    """Decode calls on the CPU taken for calls on the card, through the
    stand-in's capture and replay."""
    fake = _StandIn()
    monkeypatch.setattr(decode_graph, "_on_card",
                        lambda t: not decode_graph.is_dtensor(t))
    monkeypatch.setattr(decode_graph, "_capturing", lambda: False)
    monkeypatch.setattr(decode_graph, "capture", fake.capture)
    return fake


def _model(arch="olmo-1b"):
    return Model(smoke_config(get_config(arch)), seed=0, device="cpu")


def _inputs(model, step, rows=ROWS):
    gen = torch.Generator().manual_seed(step)
    tokens = torch.randint(1, model.cfg.vocab_size, (rows, 1), generator=gen,
                           dtype=torch.int32)
    index = torch.arange(rows, dtype=torch.int32) + step
    return tokens, index, torch.arange(rows, dtype=torch.int32)


def _how(model, caches, tokens, index, slots, max_len=MAX_LEN):
    before = dict(Model.decode_calls)
    logits, out = model.decode_step(caches, tokens, index, slots, max_len)
    assert out is caches
    ran = [k for k, n in Model.decode_calls.items() if n != before[k]]
    assert len(ran) == 1 and Model.decode_calls[ran[0]] == before[ran[0]] + 1
    return ran[0], logits


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-moe-16b"])
def test_first_call_eager_second_captures_later_replay(stand_in, arch):
    model = _model(arch)
    caches = model.init_cache(ROWS, MAX_LEN)
    twin = model.init_cache(ROWS, MAX_LEN)
    hows = []
    for step in range(5):
        tokens, index, slots = _inputs(model, step)
        how, logits = _how(model, caches, tokens, index, slots)
        want, _ = decode_step(model.params, model.cfg, twin, tokens, index,
                              slots, MAX_LEN)
        assert torch.equal(logits, want)
        hows.append(how)
    assert hows == ["eager", "captured", "replayed", "replayed", "replayed"]
    assert (stand_in.captures, stand_in.replays) == (1, 4)
    assert all(torch.equal(a, b) for a, b in zip(
        leaves(caches), leaves(twin)))


@pytest.mark.parametrize("change", ["width", "max_len", "storage"])
def test_a_new_key_captures_anew(stand_in, change):
    model = _model()
    caches = model.init_cache(ROWS, MAX_LEN)
    for step in range(3):
        assert _how(model, caches, *_inputs(model, step))[0] == [
            "eager", "captured", "replayed"][step]
    max_len, rows = MAX_LEN, ROWS
    if change == "width":
        rows = ROWS - 1
    elif change == "max_len":
        max_len = MAX_LEN - 8
    else:
        caches = model.init_cache(ROWS, MAX_LEN)
    hows = [_how(model, caches, *_inputs(model, 3 + step, rows), max_len)[0]
            for step in range(3)]
    assert hows == ["eager", "captured", "replayed"]
    assert stand_in.captures == 2
    # each graph keeps the tickets its capture used
    held = [e.tickets for e in model.decode_graphs._entries.values()]
    assert len(held) == 2
    assert all(h is t for h, t in zip(held, stand_in.tickets))


@pytest.mark.parametrize("calls", [1, 3])
def test_freed_caches_drop_their_graph(stand_in, calls):
    model = _model()
    caches = model.init_cache(ROWS, MAX_LEN)
    for step in range(calls):
        _how(model, caches, *_inputs(model, step))
    assert len(model.decode_graphs._entries) == 1
    del caches
    stand_in.release()
    gc.collect()
    fresh = model.init_cache(ROWS, MAX_LEN)
    hows = [_how(model, fresh, *_inputs(model, 3 + s))[0] for s in range(3)]
    assert hows == ["eager", "captured", "replayed"]
    assert len(model.decode_graphs._entries) == 1


@pytest.mark.parametrize("engines", [2, 6])
def test_every_live_engine_keeps_its_graph(stand_in, engines):
    """A cluster's replicas share one model, each with caches of its own,
    called in turn: each replays from its third call on."""
    model = _model()
    kept = [model.init_cache(ROWS, MAX_LEN) for _ in range(engines)]
    for step, want in enumerate(["eager", "captured", "replayed",
                                 "replayed"]):
        for caches in kept:
            assert _how(model, caches, *_inputs(model, step))[0] == want
    assert len(model.decode_graphs._entries) == engines
    assert stand_in.captures == engines


@pytest.mark.parametrize("mode", ["eager", "captured", "replayed"])
def test_moe_counters_advance_once_a_call(stand_in, mode):
    model = _model("deepseek-moe-16b")
    cfg = model.cfg
    caches = model.init_cache(ROWS, MAX_LEN)
    block = layers.moe_block
    moe_layers = cfg.n_layers - 1
    step = ["eager", "captured", "replayed"].index(mode)
    for s in range(step):
        _how(model, caches, *_inputs(model, s))
    a0, s0 = block.decode_assignments, block.decode_slots
    assert _how(model, caches, *_inputs(model, step))[0] == mode
    assert block.decode_assignments - a0 == moe_layers * ROWS * cfg.moe_top_k
    assert block.decode_slots - s0 == moe_layers * cfg.n_routed_experts * ROWS


def test_returned_logits_do_not_alias_the_next_calls(stand_in):
    model = _model()
    caches = model.init_cache(ROWS, MAX_LEN)
    kept = []
    for step in range(4):
        kept.append((_how(model, caches, *_inputs(model, step))[1], None))
        kept[-1] = (kept[-1][0], kept[-1][0].clone())
    assert len({t.data_ptr() for t, _ in kept}) == len(kept)
    assert all(torch.equal(t, copy) for t, copy in kept)
    assert not torch.equal(kept[-1][0], kept[-2][0])


def test_the_cpu_path_stays_eager_and_bit_equal():
    model = _model("deepseek-moe-16b")
    caches = model.init_cache(ROWS, MAX_LEN)
    twin = model.init_cache(ROWS, MAX_LEN)
    for step in range(4):
        tokens, index, slots = _inputs(model, step)
        how, logits = _how(model, caches, tokens, index, slots)
        want, _ = decode_step(model.params, model.cfg, twin, tokens, index,
                              slots, MAX_LEN)
        assert how == "eager" and torch.equal(logits, want)
    assert not model.decode_graphs._entries


def _old_gelu(x):
    """``layers.gelu`` as it made its constants on every call."""
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    return x * (0.5 * (1 + torch.tanh(c * (x + k * (x * x * x)))))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gelu_bit_equal_to_the_per_call_constants(dtype):
    x = torch.randn(3, 257, generator=torch.Generator().manual_seed(1)) * 4
    x = x.to(dtype)
    for _ in range(2):                  # made, then read from the cache
        assert torch.equal(layers.gelu(x), _old_gelu(x))


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "xlstm-1.3b",
                                  "hymba-1.5b", "deepseek-v2-lite-16b"])
def test_every_family_records_its_decode(stand_in, arch):
    model = _model(arch)
    enc = model.cfg.frontend_tokens if model.cfg.encoder_layers else 0
    caches = model.init_cache(ROWS, MAX_LEN, enc_len=enc)
    hows = [_how(model, caches, *_inputs(model, s))[0] for s in range(3)]
    assert hows == ["eager", "captured", "replayed"]


class _Listener:
    """A cost counter that counts nothing."""

    def __getattr__(self, name):
        return lambda *a, **k: None


@pytest.mark.parametrize("hold", ["switched_off", "listener", "capturing"])
def test_held_eager(stand_in, monkeypatch, hold):
    model = _model()
    caches = model.init_cache(ROWS, MAX_LEN)
    held = contextlib.nullcontext()
    if hold == "switched_off":
        held = model.decode_graphs.eager()
    elif hold == "listener":            # a cost counter counting the ops
        _LISTENERS.append(_Listener())
    else:                               # inside a caller's own capture
        monkeypatch.setattr(decode_graph, "_capturing", lambda: True)
    try:
        with held:
            hows = [_how(model, caches, *_inputs(model, s))[0]
                    for s in range(3)]
    finally:
        if hold == "listener":
            _LISTENERS.pop()
    assert hows == ["eager"] * 3 and stand_in.captures == 0
    assert model.decode_graphs.on


@pytest.mark.parametrize("on", [True, False])
def test_eager_restores_the_switch_it_found(on):
    graphs = _model().decode_graphs
    graphs.on = on
    with graphs.eager():
        assert not graphs.on
        with graphs.eager():
            assert not graphs.on
        assert not graphs.on
    assert graphs.on is on


def test_split_tickets_are_zeroed_before_a_capture(monkeypatch):
    cpu = torch.device("cpu")
    monkeypatch.setattr(pa_ops, "_TICKETS", {})
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    first = pa_ops._tickets(cpu, 1, 12)
    assert first.numel() == 12 and not first.any()
    capturing[0] = True
    with pytest.raises(RuntimeError, match="prepare_capture"):
        pa_ops._tickets(cpu, 2, 12)
    capturing[0] = False                # prepared before the capture
    pa_ops.prepare_capture(cpu, 2)
    capturing[0] = True
    made = pa_ops._tickets(cpu, 2, 12)
    assert made.numel() == 12 and not made.any() and made is not first
    assert pa_ops._tickets(cpu, 2, 12) is made
    capturing[0] = False
    assert pa_ops._tickets(cpu, 1, 12) is first


class _FakeStream:
    """A capture stream on the CPU."""
    cuda_stream = 99

    def __init__(self, device=None):
        pass

    def wait_stream(self, other):
        pass


class _FakeCUDAGraph:
    """A capture that marks the stream as capturing while it is open."""
    capturing = False

    def capture_begin(self, capture_error_mode):
        _FakeCUDAGraph.capturing = True

    def capture_end(self):
        _FakeCUDAGraph.capturing = False


def test_a_graph_keeps_its_tickets_when_a_wider_capture_outgrows_them(
        monkeypatch):
    """``decode_graph.capture`` on the CPU, with the CUDA calls stood in
    for: the buffer a capture hands back is the one its calls used, and it
    stays alive with that handle once a wider capture has given the
    capture stream a larger buffer."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(pa_ops, "_TICKETS", {})
    monkeypatch.setattr(decode_graph, "_STREAMS", {})
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeCUDAGraph)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: _FakeCUDAGraph.capturing)
    used = []

    def call(n):                        # a decode call's paged launches
        used.append(pa_ops._tickets(cpu, _FakeStream.cuda_stream, n))
        return torch.zeros(1)

    pa_ops._tickets(cpu, 0, 12)         # the eager call before each capture
    first = decode_graph.capture(lambda: call(12), cpu)[2]
    pa_ops._tickets(cpu, 0, 40)         # a wider engine's eager call
    second = decode_graph.capture(lambda: call(40), cpu)[2]
    assert used[0] is first and used[1] is second
    assert (first.numel(), second.numel()) == (12, 40)
    assert pa_ops._TICKETS[(None, _FakeStream.cuda_stream)] is second
    kept = weakref.ref(first)
    used.clear()
    gc.collect()
    assert kept() is first and not first.any()
    del first
    gc.collect()
    assert kept() is None               # nothing else held it
