"""The packed decode step at one executed width per engine.

Every packed step runs ``Model.decode_step`` over the engine's
``max_batch`` rows in the dense step's layout (row i is slot i), each
slot that does not step copying the first stepping row
(``ServingEngine._decode_packed``, the width ``_bucket``), so a row's bits
do not depend on how many rows step beside it.  On the card that matters
because cuBLAS picks a GEMM's algorithm by its row count M.  Here
``torch.einsum``, as the port's ``models.layers`` reaches it, is replaced
by a product whose rounding depends on M (the contraction split in two
halves, each rounded, above ``SMALL_M`` rows): it moves the raw model's
rows across widths, and no row and no token through the engine, in every
decoder family the engine serves.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.core.policy import SchedulingPolicy, cc_aware_defaults
from repro_torch.models import layers
from repro_torch.models.model import Model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.sampler import SamplingParams

torch.set_num_threads(1)

#: ``tests/test_torch_engine.py``'s ragged workload: (unused, prompt
#: length, new tokens) for 6 requests through 4 slots, so slots free one by
#: one, queued requests admit mid-run and the stepping rows shrink and
#: regrow
WORKLOAD = [((i * 37) % 500 + 1, 3 + 2 * (i % 2), 4 + i) for i in range(6)]
SLOTS = 4
#: the emulated GEMM rounds one way up to this many rows, another above,
#: so widths 1-2 and 3-4 of a 4-slot engine fall on either side
SMALL_M = 2
#: each family's config changes and engine length: xLSTM with an sLSTM
#: block; hymba past its smoke window of 64, so its sliding layer decodes
#: through the ring beside a global layer on the paged kernel and its
#: Mamba-2 state; MoE after a dense ``block0``; MLA's latent cache
FAMILIES = {"olmo-1b": ({}, 48), "xlstm-1.3b": ({"slstm_every": 2}, 48),
            "hymba-1.5b": ({}, 96), "deepseek-moe-16b": ({}, 48),
            "deepseek-v2-lite-16b": ({}, 48)}


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    over, max_len = FAMILIES[request.param]
    cfg = dataclasses.replace(smoke_config(get_config(request.param)), **over)
    return Model(cfg, seed=0, device="cpu"), max_len


def _m_dependent(einsum):
    """``einsum`` for every equation, except a two-operand product over
    more than ``SMALL_M`` rows, which sums its first contracted dimension
    in two halves, each rounded to the output's dtype.  The rows M are the
    first operand's dimensions that reach the output and are not the
    second's (batch dimensions, in both, do not count): a dense
    projection's b*s, an expert's capacity slots."""
    def product(eq, *ops):
        if len(ops) != 2 or "." in eq or "->" not in eq:
            return einsum(eq, *ops)
        lhs, out = eq.replace(" ", "").split("->")
        a, b = lhs.split(",")
        m = math.prod(ops[0].shape[i] for i, c in enumerate(a)
                      if c in out and c not in b)
        k = [c for c in a if c in b and c not in out]
        if m <= SMALL_M or not k or ops[0].shape[a.index(k[0])] < 2:
            return einsum(eq, *ops)
        ia, ib = a.index(k[0]), b.index(k[0])
        n = ops[0].shape[ia]
        halves = [einsum(eq, ops[0].narrow(ia, lo, ln),
                         ops[1].narrow(ib, lo, ln))
                  for lo, ln in ((0, n // 2), (n // 2, n - n // 2))]
        return halves[0] + halves[1]
    return product


@pytest.fixture
def m_dependent(monkeypatch):
    """The card's M-dependent GEMM, emulated for the test's duration."""
    monkeypatch.setattr(layers.torch, "einsum",
                        _m_dependent(layers.torch.einsum))


def _engine(model, max_len, *, packed=True, policy="sync"):
    return ServingEngine(
        model, max_batch=SLOTS, max_len=max_len,
        policy=SchedulingPolicy(policy), cc_on=True, seed=0, device="cpu",
        defaults=dataclasses.replace(cc_aware_defaults(True),
                                     packed_decode=packed))


def _serve(engine):
    """WORKLOAD through ``engine``; its tokens by request."""
    rng = np.random.default_rng(11)
    try:
        for i, (_, n, new) in enumerate(WORKLOAD):
            engine.submit(Request(f"r{i}", prompt=rng.integers(
                1, engine.cfg.vocab_size, n).tolist(),
                sampling=SamplingParams(max_new_tokens=new)))
        engine.run()
    finally:
        engine.close()
    assert len(engine.finished) == len(WORKLOAD)
    return {r.request_id: list(r.output_tokens) for r in engine.finished}


def _resident(model, max_len, n):
    """An engine of SLOTS slots with ``n`` requests resident after one
    decode step; their (slots, tokens, index) by slot."""
    engine = _engine(model, max_len)
    rng = np.random.default_rng(5)
    for i in range(n):
        engine.submit(Request(f"p{i}", prompt=rng.integers(
            1, model.cfg.vocab_size, 6 + 5 * i).tolist(),
            sampling=SamplingParams(max_new_tokens=8)))
    engine.step()
    engine.close()
    slots = sorted(engine.active)
    assert len(slots) == n
    return (engine, slots,
            {s: engine.active[s].output_tokens[-1] for s in slots},
            {s: engine.active[s].index for s in slots})


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _slot_leaves(engine, caches, slot):
    """Every cache leaf's row at ``slot`` (the slot axis is 1 for a
    scan-stacked config's ``blocks``, 0 elsewhere)."""
    out = []

    def walk(tree, stacked):
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v, stacked)
        elif isinstance(tree, list):
            for v in tree:
                walk(v, stacked)
        else:
            out.append(tree[:, slot] if stacked else tree[slot])

    for key, sub in caches.items():
        walk(sub, engine.cfg.scan_layers and key == "blocks")
    return out


def _inputs(rows, tokens, index):
    return (torch.tensor([[tokens[s]] for s in rows], dtype=torch.int32),
            torch.tensor([index[s] for s in rows], dtype=torch.int32),
            torch.tensor(rows, dtype=torch.int32))


def _cyclic(slots, w):
    """Calls of ``w`` rows covering every slot: s, ..., s+w-1 cyclically."""
    n = len(slots)
    return [[slots[(i + j) % n] for j in range(w)] for i in range(0, n, w)]


def _by_width(slots, run):
    """Each slot's logits at every width 1 ... SLOTS: ``run(rows)`` gives
    {slot: logits} for one call."""
    out = {}
    for w in range(1, SLOTS + 1):
        for rows in _cyclic(slots, w):
            for s, lg in run(sorted(set(rows))).items():
                out.setdefault(s, {}).setdefault(w, lg)
    return out


# ---------------------------------------------------------------------------------
# (a) every packed step runs max_batch rows in the dense layout
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["sync", "async", "worker"])
def test_packed_steps_run_max_batch_rows_in_the_dense_layout(
        monkeypatch, policy):
    """A spy on ``Model.decode_step``: every packed step of the ragged
    workload calls it with exactly ``max_batch`` rows, stepping slot s at
    row s with its own token and index, every other row a copy of the
    first stepping row; the step traces stay sized to the stepping rows."""
    model = Model(smoke_config(get_config("olmo-1b")), seed=0, device="cpu")
    engine = _engine(model, 48, policy=policy)
    inner, seen = Model.decode_step, []

    def spy(self, caches, tokens, index, slots=None, max_len=0):
        ready = sorted(engine.active)       # no restores: every slot steps
        first = ready[0]
        want_tok = [engine.active[s if s in ready else first]
                    .output_tokens[-1] for s in range(SLOTS)]
        want_idx = [engine.active[s if s in ready else first].index
                    for s in range(SLOTS)]
        assert slots.tolist() == [s if s in ready else first
                                  for s in range(SLOTS)]
        assert tokens[:, 0].tolist() == want_tok
        assert index.tolist() == want_idx
        assert max_len == 48
        seen.append(len(ready))
        return inner(self, caches, tokens, index, slots, max_len)

    monkeypatch.setattr(Model, "decode_step", spy)
    _serve(engine)
    assert seen == [t.packed for t in engine.trace] == \
        [t.active for t in engine.trace]
    assert min(seen) < SLOTS == max(seen)


# ---------------------------------------------------------------------------------
# (b) an M-dependent GEMM moves the raw model's rows, not the engine's
# ---------------------------------------------------------------------------------

def test_m_dependent_product_moves_raw_rows_not_engine_rows(
        family, m_dependent):
    """All SLOTS rows resident, each run at every width 1 ... SLOTS:
    through ``model.decode_step`` at the call's own width some row's
    logits differ between widths (the emulation bites); through the
    engine's ``_decode_packed`` every row is bit-equal at every width, and
    every pad row's logits equal the row it copies."""
    model, max_len = family
    engine, slots, tokens, index = _resident(model, max_len, SLOTS)
    saved = _clone(engine.caches)

    def raw(rows):
        logits, _ = model.decode_step(_clone(saved),
                                      *_inputs(rows, tokens, index),
                                      max_len=max_len)
        return {s: logits[j] for j, s in enumerate(rows)}

    def padded(rows):
        engine.caches = _clone(saved)
        logits = engine._decode_packed(*_inputs(rows, tokens, index))
        assert logits.shape[0] == SLOTS
        for p in set(range(SLOTS)) - set(rows):
            assert torch.equal(logits[p], logits[rows[0]]), (rows, p)
        return {s: logits[s] for s in rows}

    moved = {s: any(not torch.equal(lg, by_w[SLOTS])
                    for lg in by_w.values())
             for s, by_w in _by_width(slots, raw).items()}
    assert any(moved.values()), "the emulated product did not bite"
    for s, by_w in _by_width(slots, padded).items():
        for w, lg in by_w.items():
            assert torch.equal(lg, by_w[SLOTS]), (s, w)


def test_m_dependent_product_moves_no_token(family, m_dependent):
    """Under the emulated product, the ragged workload's packed tokens
    equal the dense step's (both run ``max_batch`` rows)."""
    model, max_len = family
    assert _serve(_engine(model, max_len)) == \
        _serve(_engine(model, max_len, packed=False))


# ---------------------------------------------------------------------------------
# (c) a padded step's writes equal a dense step's
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("emulated", [False, True], ids=["cpu", "m-dependent"])
def test_padded_step_writes_equal_dense_step(family, emulated, monkeypatch):
    """Three of four slots resident, two stepping: after a padded step the
    stepping slots' caches and logits are bit-equal to a dense step's
    (every slot, the resident ones with their own tokens, the free one
    zeros), the deferred and the free slot's caches are untouched (a pad
    row writes only where the first stepping row writes), and the pad
    rows' logits equal that row's."""
    if emulated:
        monkeypatch.setattr(layers.torch, "einsum",
                            _m_dependent(layers.torch.einsum))
    model, max_len = family
    engine, slots, tokens, index = _resident(model, max_len, SLOTS - 1)
    ready = [slots[0], slots[2]]
    saved = _clone(engine.caches)

    engine.caches = _clone(saved)
    padded = engine._decode_packed(*_inputs(ready, tokens, index))
    dense_tok = {s: tokens.get(s, 0) for s in range(SLOTS)}
    dense_idx = {s: index.get(s, 0) for s in range(SLOTS)}
    dense, dense_caches = model.decode_step(
        _clone(saved), *_inputs(list(range(SLOTS)), dense_tok, dense_idx),
        max_len=max_len)

    for s in range(SLOTS):
        got = _slot_leaves(engine, engine.caches, s)
        want = _slot_leaves(engine, dense_caches if s in ready else saved, s)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), s
        if s in ready:
            assert torch.equal(padded[s], dense[s]), s
        else:
            assert torch.equal(padded[s], padded[ready[0]]), s
