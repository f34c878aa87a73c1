"""hymba-1.5b's hybrid blocks in the port against the reference: Mamba-2
(SSD) heads, sliding-window ring caches, the parallel attention + Mamba
block and the model, at the reference's smoke width with shared weights.

Weights come from the reference's ``init`` (a jax PRNG key), exported to
numpy and moved across with ``repro_torch.convert``; inputs come from
``numpy.random.default_rng``.  The reference's prefill of an unrolled
stack runs eagerly and its decode compiled (``jax.jit``), as its serving
engine runs them; the port emulates the compiled decode's excess
precision (``_mamba_proj(fused=True)``, the f32 residual feeding each
norm).  Measured distances are stated beside each tolerance.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import all_configs, smoke_config
from repro.models import layers as JL
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models.model import Model as JModel
from repro_torch.configs.base import get_config, smoke_config as t_smoke
from repro_torch.convert import (cache_from_numpy, params_from_numpy,
                                 tensor_from_numpy)
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model

torch.set_num_threads(1)

#: the reference's own decode-vs-forward bound for the family
#: (tests/test_models.py)
LOGITS_TOL = 0.02


def T(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def F32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16(rng, *shape, scale=1.0):
    return jnp.asarray((scale * rng.standard_normal(shape)).astype(
        np.float32)).astype(jnp.bfloat16)


@pytest.fixture(scope="module")
def hymba():
    """(jax cfg, jax params, jax model, port model) sharing one weight set:
    2 layers (layer 0 global, layer 1 a 64-token window), 4 heads (2 KV),
    Mamba-2 e 256 = 4 heads of 64, state 8."""
    jcfg = smoke_config(all_configs()["hymba-1.5b"])
    tcfg = t_smoke(get_config("hymba-1.5b"))
    jm = JModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jparams, jm, Model(tcfg, params=tparams, device="cpu")


def _state(rng, jcfg, b):
    e = jcfg.ssm_expand * jcfg.d_model
    dh = e // jcfg.n_heads
    return {"ssm": jnp.asarray(0.1 * rng.standard_normal(
                (b, jcfg.n_heads, dh, jcfg.ssm_state)).astype(np.float32)),
            "conv": _bf16(rng, b, jcfg.conv_width - 1, e)}


# ---------------------------------------------------------------------------------
# Mamba-2 / SSD
# ---------------------------------------------------------------------------------

class TestMamba:
    @pytest.mark.parametrize("carried", [False, True],
                             ids=["empty", "carried"])
    @pytest.mark.parametrize("s", [1, 255, 256, 257, 600])
    def test_mamba_chunked_matches_reference(self, hymba, s, carried):
        """The chunked scan (chunk 256, the prompt padded to whole chunks)
        against the reference's eager ``mamba_chunked``.  The bf16
        projections' f32 sums run in another order (XLA's against torch's),
        so an element now and then rounds to the neighbouring bf16 value:
        output and conv history within 2^-5 (measured <= 2^-6 at S = 600,
        one step at magnitude 2-4), the f32 state within 1e-5 of its
        largest magnitude (measured <= 4.9e-6)."""
        jcfg, jparams, _, model = hymba
        rng = np.random.default_rng(s)
        x = _bf16(rng, 2, s, jcfg.d_model)
        state = _state(rng, jcfg, 2) if carried else None
        jy, jst = JS.mamba_chunked(jparams["blocks"][1]["ssm"], x, jcfg,
                                   state=state)
        tstate = (None if state is None
                  else cache_from_numpy(jax.tree.map(np.asarray, state), "cpu"))
        ty, tst = TS.mamba_chunked(model.params["blocks"][1]["ssm"], T(x),
                                   model.cfg, state=tstate)
        assert ty.dtype == torch.bfloat16 and tst["ssm"].dtype == torch.float32
        assert tst["conv"].dtype == torch.bfloat16        # the input's dtype
        np.testing.assert_allclose(tst["conv"].float().numpy(),
                                   F32(jst["conv"]), atol=2 ** -5)
        want = F32(jst["ssm"])
        assert np.abs(tst["ssm"].numpy() - want).max() <= 1e-5 * np.abs(
            want).max()
        np.testing.assert_allclose(ty.float().numpy(), F32(jy), atol=2 ** -5)

    def test_mamba_step_matches_compiled_reference(self, hymba):
        """One decode step against the reference's compiled ``mamba_step``
        (as its jitted decode runs it).  The f32 ``dt`` product reads the
        SiLU's f32 result, as XLA fuses it (the eager reference rounds it
        first, which the prefill path copies).  The conv history is equal;
        the f32 state within 1e-5 of its largest magnitude (XLA contracts
        ``state * decay + B x`` differently: measured 1.4e-6 at
        magnitudes up to ~0.5), and so the output within one bf16 step
        (measured: 2 of 384 elements one step apart)."""
        jcfg, jparams, _, model = hymba
        rng = np.random.default_rng(3)
        p = jparams["blocks"][0]["ssm"]
        step = jax.jit(lambda p, x, st: JS.mamba_step(p, x, jcfg, st))
        for trial in range(4):
            x = _bf16(rng, 3, 1, jcfg.d_model)
            state = _state(rng, jcfg, 3)
            jy, jst = step(p, x, state)
            ty, tst = TS.mamba_step(
                model.params["blocks"][0]["ssm"], T(x), model.cfg,
                cache_from_numpy(jax.tree.map(np.asarray, state), "cpu"))
            np.testing.assert_allclose(ty.float().numpy(), F32(jy),
                                       rtol=2 ** -7, atol=1e-6)
            np.testing.assert_array_equal(tst["conv"].float().numpy(),
                                          F32(jst["conv"]))
            want = F32(jst["ssm"])
            assert np.abs(tst["ssm"].numpy() - want).max() <= 1e-5 * np.abs(
                want).max()

    def test_softplus_is_the_reference_formula(self):
        """``max(x, 0) + log1p(exp(-|x|))``: within two f32 ulps of XLA's
        (its exp and log1p differ from torch's in the last bit: measured
        120 of 2001 points one ulp apart)."""
        x = np.linspace(-30, 30, 2001, dtype=np.float32)
        np.testing.assert_allclose(
            TS.softplus(torch.from_numpy(x)).numpy(),
            np.asarray(jax.jit(jax.nn.softplus)(jnp.asarray(x))),
            rtol=2 ** -22, atol=0)

    def test_empty_state_dtypes(self, hymba):
        _, _, _, model = hymba
        st = TS.init_mamba_state(2, model.cfg)
        assert st["ssm"].dtype == st["conv"].dtype == torch.float32
        assert tuple(st["ssm"].shape) == (2, 4, 64, 8)
        assert tuple(st["conv"].shape) == (2, 3, 256)


# ---------------------------------------------------------------------------------
# sliding-window ring caches
# ---------------------------------------------------------------------------------

def test_layer_windows_and_caps(hymba):
    jcfg, _, _, model = hymba
    cfg = model.cfg
    for i in range(cfg.n_layers):
        assert TT.layer_window(cfg, i) == JT._layer_window(jcfg, i)
    assert TT.layer_cap(256, 64) == 64 and TT.layer_cap(32, 64) == 32
    assert TT.layer_cap(256, None) == 256
    # a ring only where the window is shorter than max_len (or max_len is
    # unknown and the cache is the window)
    assert TT.uses_ring(64, 64, 256) and TT.uses_ring(64, 64, 0)
    assert not TT.uses_ring(64, 64, 64)
    assert not TT.uses_ring(32, 64, 32) and not TT.uses_ring(32, 64, 0)
    assert not TT.uses_ring(256, None, 256)
    caches = model.init_cache(2, 256)
    assert caches["blocks"][0]["kv"]["k"].shape[1] == 256
    assert caches["blocks"][1]["kv"]["k"].shape[1] == 64
    ref = jax.tree.map(np.shape, JModel(jcfg).init_cache(2, 256))
    assert jax.tree.map(lambda t: tuple(t.shape), caches) == ref


#: a prompt past the 64-token window whose length is not a multiple of it
RING_PROMPT, RING_MAX_LEN = 100, 256


def test_ring_prefill_layout_and_copied_fault(hymba):
    """The ring prefill keeps the prompt's last ``cap`` positions in order
    (slot j holds position s - cap + j), as the reference lays them out;
    the first decode writes position s at slot s % cap, which overwrites
    position s - cap + s % cap = 72 while it is still inside the window
    (72 > 100 - 64): the reference's layout fault, held on both packages.
    Cache contents, ``pos`` and every later write agree over 8 steps, and
    tokens are equal.  On the same cache the ring attention equals the
    reference's ``_ring_decode_attention`` run op by op, bit for bit, and
    its compiled form within one bf16 step (XLA's fused softmax rounds an
    output element the other way now and then: 0.0039 on step 1 here)."""
    jcfg, jparams, jm, model = hymba
    rng = np.random.default_rng(8)
    prompt = rng.integers(1, jcfg.vocab_size, (2, RING_PROMPT)).astype(
        np.int32)
    jl, jc, idx = jm.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                             max_len=RING_MAX_LEN)
    tl, tc, tidx = model.prefill(torch.from_numpy(prompt), RING_MAX_LEN)
    assert idx == tidx == RING_PROMPT
    cap, s = 64, RING_PROMPT
    want_pos = np.broadcast_to(np.arange(s - cap, s), (2, cap))
    for pos in (np.asarray(jc["blocks"][1]["kv"]["pos"]),
                tc["blocks"][1]["kv"]["pos"].numpy()):
        np.testing.assert_array_equal(pos, want_pos)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["blocks"][1]["kv"][name].float().numpy(),
                                   F32(jc["blocks"][1]["kv"][name]),
                                   atol=2 ** -5)      # measured 2^-6

    decode = jax.jit(jm.decode_step)
    index = np.full((2,), idx, np.int32)
    jtok = np.asarray(jnp.argmax(jl[:, -1].astype(jnp.float32), -1), np.int32)
    ttok = torch.argmax(tl[:, -1].float(), -1).to(torch.int32)
    np.testing.assert_array_equal(jtok, ttok.numpy())
    lost = s - cap + s % cap
    assert lost == 72 and lost > s - 64
    for step in range(8):
        # the ring layer's attention on the reference's cache, bit for bit
        h = _bf16(rng, 2, 1, jcfg.d_model)
        p = jparams["blocks"][1]["attn"]
        ij = jnp.asarray(index)

        def ref(p, h, c):
            return JT._ring_decode_attention(
                p, h, jcfg, positions=ij[:, None], cache=c, cache_index=ij,
                window=64)[0]

        jy = ref(p, h, jc["blocks"][1]["kv"])
        jy_compiled = jax.jit(ref)(p, h, jc["blocks"][1]["kv"])
        kv = cache_from_numpy(jax.tree.map(np.asarray, jc["blocks"][1]["kv"]),
                              "cpu")
        ty = TT.ring_decode_attention(
            model.params["blocks"][1]["attn"], T(h), model.cfg,
            positions=torch.from_numpy(index)[:, None], cache=kv,
            cache_index=torch.from_numpy(index), slots=torch.arange(2),
            window=64)
        np.testing.assert_array_equal(ty.float().numpy(), F32(jy),
                                      err_msg=f"step {step}")
        np.testing.assert_allclose(ty.float().numpy(), F32(jy_compiled),
                                   atol=2 ** -7, err_msg=f"step {step}")

        jl, jc = decode(jparams, jc, jnp.asarray(jtok[:, None]),
                        jnp.asarray(index))
        tl, tc = model.decode_step(tc, ttok[:, None], torch.from_numpy(index),
                                   max_len=RING_MAX_LEN)
        if step == 0:
            for pos in (np.asarray(jc["blocks"][1]["kv"]["pos"]),
                        tc["blocks"][1]["kv"]["pos"].numpy()):
                assert (pos[:, s % cap] == s).all()
                assert not (pos == lost).any()        # lost inside the window
        np.testing.assert_array_equal(tc["blocks"][1]["kv"]["pos"].numpy(),
                                      np.asarray(jc["blocks"][1]["kv"]["pos"]))
        jtok = np.asarray(jnp.argmax(jl[:, -1].astype(jnp.float32), -1),
                          np.int32)
        ttok = torch.argmax(tl[:, -1].float(), -1).to(torch.int32)
        np.testing.assert_array_equal(jtok, ttok.numpy())
        index += 1


def test_windowed_layer_with_a_full_cache_takes_the_paged_kernel(hymba,
                                                                  monkeypatch):
    """A sliding layer whose cache holds max_len <= window positions decodes
    through the paged kernel (its window cannot bite) and gives the
    reference's ``_ring_decode_attention`` output with the window."""
    jcfg, jparams, jm, model = hymba
    rng = np.random.default_rng(9)
    prompt = rng.integers(1, jcfg.vocab_size, (3, 20)).astype(np.int32)
    _, jc, idx = jm.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                            max_len=64)
    index = np.asarray([20, 20, 20], np.int32)
    h = _bf16(rng, 3, 1, jcfg.d_model)
    ij = jnp.asarray(index)
    jy, _ = jax.jit(lambda p, h, c: JT._ring_decode_attention(
        p, h, jcfg, positions=ij[:, None], cache=c, cache_index=ij,
        window=64))(jparams["blocks"][1]["attn"], h, jc["blocks"][1]["kv"])
    calls = []
    monkeypatch.setattr(TT, "ring_decode_attention",
                        lambda *a, **k: calls.append(1))
    kv = cache_from_numpy(jax.tree.map(np.asarray, jc["blocks"][1]["kv"]), "cpu")
    ty = TT.decode_kv(model.params["blocks"][1]["attn"], T(h), model.cfg,
                      positions=torch.from_numpy(index)[:, None], cache=kv,
                      cache_index=torch.from_numpy(index),
                      slots=torch.arange(3), window=64, max_len=64)
    assert calls == []
    np.testing.assert_array_equal(ty.float().numpy(), F32(jy))


# ---------------------------------------------------------------------------------
# the hybrid block
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("layer", [0, 1], ids=["global", "sliding"])
def test_hybrid_block_matches_reference(hymba, layer):
    """One hybrid block: its eager prefill against the reference's (f32
    sums in another order round an element the other way now and then:
    the stream within 2^-5, measured 2^-6; the f32 Mamba state within 1e-4
    of its largest magnitude) and its decode against the reference's
    compiled decode block (``fused``: the MLP norm reads the f32 residual
    sum), within 2^-5 (measured 2^-6: XLA's fused softmax rounds an
    attention element the other way now and then; on most draws the block
    is bit-equal)."""
    jcfg, jparams, jm, model = hymba
    rng = np.random.default_rng(10 + layer)
    pj, pt = jparams["blocks"][layer], model.params["blocks"][layer]
    x = _bf16(rng, 2, 30, jcfg.d_model)
    pos = jnp.broadcast_to(jnp.arange(30)[None], (2, 30))
    jx, jnc, _ = JT.block_apply(pj, x, jcfg, layer, mode="prefill",
                                positions=pos,
                                cache=JT.init_layer_cache(jcfg, layer, 2, 64))
    tx, _, tnc = TT.block_apply(pt, T(x), model.cfg, layer, mode="prefill",
                                positions=torch.from_numpy(np.asarray(pos)),
                                max_len=64, fused=False)
    np.testing.assert_allclose(tx.float().numpy(), F32(jx), atol=2 ** -5)
    want = F32(jnc["ssm"]["ssm"])
    assert np.abs(tnc["ssm"]["ssm"].numpy() - want).max() <= 1e-4 * np.abs(
        want).max()

    xd = _bf16(rng, 2, 1, jcfg.d_model)
    ij = jnp.asarray(np.full((2,), 30, np.int32))
    run = jax.jit(lambda p, x, c: JT.block_apply(
        p, x, jcfg, layer, mode="decode", positions=ij[:, None], cache=c,
        cache_index=ij)[0])
    jxd = run(pj, xd, jnc)
    tcache = cache_from_numpy(jax.tree.map(np.asarray, jnc), "cpu")
    txd, resid, _ = TT.block_apply(
        pt, T(xd), model.cfg, layer, mode="decode",
        positions=torch.from_numpy(np.asarray(ij))[:, None], cache=tcache,
        cache_index=torch.from_numpy(np.asarray(ij)), slots=torch.arange(2),
        max_len=64, keep_f32=True)
    np.testing.assert_allclose(txd.float().numpy(), F32(jxd), atol=2 ** -5)
    assert resid.dtype == torch.float32
    assert torch.equal(resid.to(torch.bfloat16), txd)


# ---------------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------------

def test_hymba_prefill_and_greedy_decode_match_reference(hymba):
    """Prefill and 8 greedy decode steps against the reference's prefill
    and compiled decode_step: tokens equal; logits within LOGITS_TOL
    (measured 0.0156: rare one-ulp steps of f32 attention sums, in XLA's
    order against torch's, amplified by the stack); caches likewise."""
    jcfg, jparams, jm, model = hymba
    prompt = np.random.default_rng(6).integers(
        1, jcfg.vocab_size, (2, 11)).astype(np.int32)
    jl, jc, idx = jm.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                             max_len=32)
    tl, tc, tidx = model.prefill(torch.from_numpy(prompt), 32)
    assert idx == tidx == 11
    assert tc["blocks"][0]["ssm"]["conv"].dtype == torch.bfloat16
    np.testing.assert_allclose(tl.float().numpy(), F32(jl), atol=LOGITS_TOL)
    decode = jax.jit(jm.decode_step)
    jtok = np.asarray(jnp.argmax(jl[:, -1].astype(jnp.float32), -1), np.int32)
    ttok = torch.argmax(tl[:, -1].float(), -1).to(torch.int32)
    np.testing.assert_array_equal(jtok, ttok.numpy())
    index = np.full((2,), idx, np.int32)
    for _ in range(8):
        jl, jc = decode(jparams, jc, jnp.asarray(jtok[:, None]),
                        jnp.asarray(index))
        tl, tc = model.decode_step(tc, ttok[:, None], torch.from_numpy(index))
        np.testing.assert_allclose(tl.float().numpy(), F32(jl),
                                   atol=LOGITS_TOL)
        jtok = np.asarray(jnp.argmax(jl[:, -1].astype(jnp.float32), -1),
                          np.int32)
        ttok = torch.argmax(tl[:, -1].float(), -1).to(torch.int32)
        np.testing.assert_array_equal(jtok, ttok.numpy())
        index += 1
    for i in range(2):
        np.testing.assert_array_equal(
            tc["blocks"][i]["kv"]["pos"].numpy(),
            np.asarray(jc["blocks"][i]["kv"]["pos"]))
        np.testing.assert_allclose(
            tc["blocks"][i]["ssm"]["ssm"].numpy(),
            F32(jc["blocks"][i]["ssm"]["ssm"]), atol=1e-2)


def test_hymba_decode_matches_reference_forward(hymba):
    """Teacher-forced, as tests/test_models.py runs the reference: the
    port's prefill of 6 tokens and decode of the next 4 against the
    reference's parallel ``forward`` at each position.  The port copies
    the reference's compiled decode (its serving path), which sits further
    from ``forward`` than its eager decode does (eager: 0; compiled:
    0.0430 here, where tests/test_models.py's 0.02 bounds the eager one);
    the port may sit no further from ``forward`` than the reference's
    compiled decode does (measured: equal, 0.0430)."""
    _decode_vs_forward(*hymba)


def _decode_vs_forward(jcfg, jparams, jm, model, seed=12):
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    full, _ = jm.forward(jparams, {"tokens": jnp.asarray(tokens)})
    full = F32(full)
    decode = jax.jit(jm.decode_step)
    jl, jc, idx = jm.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :6])},
                             max_len=32)
    tl, tc, _ = model.prefill(torch.from_numpy(tokens[:, :6]), 32)
    ours = [np.abs(tl[:, 0].float().numpy() - full[:, 5]).max()]
    ref = [np.abs(F32(jl)[:, 0] - full[:, 5]).max()]
    for t in range(6, 10):
        index = np.full((2,), t, np.int32)
        jl, jc = decode(jparams, jc, jnp.asarray(tokens[:, t:t + 1]),
                        jnp.asarray(index))
        tl, tc = model.decode_step(tc, torch.from_numpy(tokens[:, t:t + 1]),
                                   torch.from_numpy(index))
        ours.append(np.abs(tl[:, 0].float().numpy() - full[:, t]).max())
        ref.append(np.abs(F32(jl)[:, 0] - full[:, t]).max())
    assert max(ours) <= max(ref), (ours, ref)
    return max(ours), max(ref)


def test_params_from_numpy_takes_per_layer_lists(hymba):
    jcfg, jparams, _, model = hymba
    assert isinstance(model.params["blocks"], list)
    assert len(model.params["blocks"]) == jcfg.n_layers
    assert model.params["blocks"][1]["ssm"]["w_dt"].dtype == torch.float32
    bad = jax.tree.map(np.asarray, jparams)
    bad["blocks"] = bad["blocks"][:1]
    with pytest.raises(ValueError, match="1 layers"):
        params_from_numpy(bad, model.cfg, "cpu")


def test_random_init_matches_reference_layout(hymba):
    """``Model(cfg)`` drawing its own weights gives the reference's tree:
    the same leaves, shapes and dtypes."""
    jcfg, jparams, _, _ = hymba
    ours = Model(t_smoke(get_config("hymba-1.5b")), device="cpu").params
    ref = jax.tree.map(lambda p: (tuple(p.value.shape), p.value.dtype.name),
                       jparams, is_leaf=JL.is_param)
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).removeprefix("torch.")), ours)
    assert got == ref
