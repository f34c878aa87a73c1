"""The port's dense model against the reference, with shared weights.

Weights come from the reference's ``init`` (a jax PRNG key), exported to
numpy and moved across with ``repro_torch.convert``; inputs come from
``numpy.random.default_rng``.  Layer functions are held to the reference
op by op; prefill logits and 8 greedy decode steps to the reference model
(logits within 3e-2 in bf16, tokens identical).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import ARCH_IDS, all_configs, smoke_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model import Model as JModel
from repro_torch.configs.base import get_config, smoke_config as t_smoke
from repro_torch.convert import (cache_from_numpy, params_from_numpy,
                                 tensor_from_numpy)
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model

torch.set_num_threads(1)

#: the dense archs at smoke width: olmo-1b (tied embeddings, non-parametric
#: LN), qwen3p6-27b and qwen3-32b (qk_norm with GQA), qwen1.5-4b (QKV bias,
#: MHA), nemotron-4-340b (squared-ReLU, GQA); all but olmo-1b untied
ARCHS = ["olmo-1b", "qwen3p6-27b", "qwen1.5-4b", "qwen3-32b",
         "nemotron-4-340b"]
BF16_TOL = 3e-2


def T(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def close(jax_out, torch_out, atol=BF16_TOL):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jnp.asarray(jax_out).astype(jnp.float32)),
                               atol=atol)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, jax params, port cfg, port model) sharing one weight set."""
    jcfg = smoke_config(all_configs()[request.param])
    tcfg = t_smoke(get_config(request.param))
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jparams, tcfg, Model(tcfg, params=tparams, device="cpu")


def _layer0(jparams, part):
    return jax.tree.map(lambda p: p.value[0], jparams["blocks"][part],
                        is_leaf=JL.is_param)


def _bf16(rng, *shape):
    return jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(
        jnp.bfloat16)


# ---------------------------------------------------------------------------------
# convert.py
# ---------------------------------------------------------------------------------

class TestConvert:
    @pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32, jnp.int32])
    def test_round_trip_is_bit_exact(self, dtype):
        rng = np.random.default_rng(0)
        a = jnp.asarray(rng.standard_normal((3, 5, 7)) * 100).astype(dtype)
        t = tensor_from_numpy(np.asarray(a), "cpu")
        back = t.view(torch.int16).numpy() if dtype == jnp.bfloat16 else t.numpy()
        want = np.asarray(a).view(np.int16) if dtype == jnp.bfloat16 else np.asarray(a)
        assert t.shape == a.shape
        np.testing.assert_array_equal(back, want)

    def test_param_tree_keeps_stacked_layout_and_tied_embedding(self, pair):
        jcfg, jparams, tcfg, model = pair
        assert "unembed" not in model.params if tcfg.tie_embeddings else True
        for name in ("wq", "wk", "wv", "wo"):
            j = np.asarray(jparams["blocks"]["attn"][name].value)
            t = model.params["blocks"]["attn"][name]
            assert t.shape == j.shape and t.shape[0] == tcfg.n_layers
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          j.view(np.int16))

    def test_cache_from_numpy(self, pair):
        jcfg, jparams, tcfg, _ = pair
        jm = JModel(jcfg)
        _, jc, _ = jm.prefill(jparams, {"tokens": jnp.ones((1, 5), jnp.int32)},
                              max_len=16)
        tc = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
        assert tc["blocks"]["kv"]["pos"].dtype == torch.int32
        np.testing.assert_array_equal(tc["blocks"]["kv"]["pos"].numpy(),
                                      np.asarray(jc["blocks"]["kv"]["pos"]))
        close(jc["blocks"]["kv"]["k"], tc["blocks"]["kv"]["k"], 0)


# ---------------------------------------------------------------------------------
# layers.py
# ---------------------------------------------------------------------------------

class TestLayers:
    @pytest.mark.parametrize("kind", ["rmsnorm", "layernorm",
                                      "nonparametric_ln"])
    def test_norms(self, kind):
        rng = np.random.default_rng(1)
        x = _bf16(rng, 2, 5, 64)
        params = {}
        if kind != "nonparametric_ln":
            params["scale"] = _bf16(rng, 64)
        if kind == "layernorm":
            params["bias"] = _bf16(rng, 64)
        jp = {k: JL.Param(v, ("embed",)) for k, v in params.items()}
        tp = {k: T(v) for k, v in params.items()}
        close(JL.apply_norm(jp, x, kind), TL.apply_norm(tp, T(x), kind), 0)

    def test_rope_is_half_split_and_matches(self):
        rng = np.random.default_rng(2)
        x = _bf16(rng, 2, 7, 3, 32)
        pos = np.arange(7)[None].repeat(2, 0) + np.asarray([[0], [40]])
        sj, cj = JL.rope_table(jnp.asarray(pos), 32, 1e6)
        st, ct = TL.rope_table(torch.from_numpy(pos), 32, 1e6)
        close(sj, st, 1e-6)
        close(cj, ct, 1e-6)
        close(JL.apply_rope(x, sj, cj), TL.apply_rope(T(x), st, ct))

    def test_attention_block(self, pair):
        jcfg, jparams, tcfg, model = pair
        rng = np.random.default_rng(3)
        x = _bf16(rng, 2, 9, jcfg.d_model)
        pos = jnp.broadcast_to(jnp.arange(9)[None], (2, 9))
        jy, (jk, jv) = JL.attention_block(
            jax.tree.map(lambda v: JL.Param(v, ()), _layer0(jparams, "attn")),
            x, jcfg, positions=pos, return_kv=True)
        ty, (tk, tv) = TL.attention_block(
            TT.layer_params(model.params["blocks"], 0)["attn"], T(x), tcfg,
            positions=torch.arange(9)[None].expand(2, 9), return_kv=True)
        close(jy, ty)
        close(jk, tk)
        close(jv, tv)

    @pytest.mark.parametrize("mlp_kind", ["swiglu", "squared_relu", "gelu"])
    def test_mlp_kinds(self, pair, mlp_kind):
        jcfg, _, tcfg, _ = pair
        jcfg = dataclasses.replace(jcfg, mlp_kind=mlp_kind)
        tcfg = dataclasses.replace(tcfg, mlp_kind=mlp_kind)
        jp = JL.init_mlp(jax.random.PRNGKey(4), jcfg)
        tp = {k: T(v.value) for k, v in jp.items()}
        x = _bf16(np.random.default_rng(4), 2, 5, jcfg.d_model)
        close(JL.mlp_block(jp, x, jcfg), TL.mlp_block(tp, T(x), tcfg))

    @pytest.mark.parametrize("causal,window", [(True, None), (True, 6),
                                               (False, None)])
    def test_dense_and_blockwise_attention(self, causal, window):
        rng = np.random.default_rng(5)
        q, k, v = (jnp.asarray(rng.standard_normal((1, 20, 2, 16)),
                               jnp.float32) for _ in range(3))
        close(JL.dense_attention(q, k, v, causal=causal, window=window),
              TL.dense_attention(T(q), T(k), T(v), causal=causal,
                                 window=window), 2e-4)
        close(JL.blockwise_attention(q, k, v, causal=causal, window=window,
                                     block_kv=8),
              TL.blockwise_attention(T(q), T(k), T(v), causal=causal,
                                     window=window, block_kv=8), 2e-4)


# ---------------------------------------------------------------------------------
# model.py: prefill + greedy decode
# ---------------------------------------------------------------------------------

def test_prefill_and_greedy_decode_match_reference(pair):
    jcfg, jparams, tcfg, model = pair
    jm = JModel(jcfg)
    prompt = np.random.default_rng(6).integers(
        1, jcfg.vocab_size, (2, 11)).astype(np.int32)
    jl, jc, idx = jm.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                             max_len=32)
    tl, tc, tidx = model.prefill(torch.from_numpy(prompt), 32)
    assert idx == tidx == 11
    close(jl, tl)
    np.testing.assert_array_equal(tc["blocks"]["kv"]["pos"].numpy(),
                                  np.asarray(jc["blocks"]["kv"]["pos"]))
    close(jc["blocks"]["kv"]["k"], tc["blocks"]["kv"]["k"])
    decode = jax.jit(jm.decode_step)
    jtok = np.asarray(jnp.argmax(jl[:, -1].astype(jnp.float32), -1), np.int32)
    ttok = torch.argmax(tl[:, -1].float(), -1).to(torch.int32)
    np.testing.assert_array_equal(jtok, ttok.numpy())
    index = np.full((2,), idx, np.int32)
    for _ in range(8):
        jl, jc = decode(jparams, jc, jnp.asarray(jtok[:, None]),
                        jnp.asarray(index))
        tl, tc = model.decode_step(tc, ttok[:, None], torch.from_numpy(index))
        close(jl, tl)
        jtok = np.asarray(jnp.argmax(jl[:, -1].astype(jnp.float32), -1),
                          np.int32)
        ttok = torch.argmax(tl[:, -1].float(), -1).to(torch.int32)
        np.testing.assert_array_equal(jtok, ttok.numpy())
        index += 1
    close(jc["blocks"]["kv"]["v"], tc["blocks"]["kv"]["v"])
    np.testing.assert_array_equal(tc["blocks"]["kv"]["pos"].numpy(),
                                  np.asarray(jc["blocks"]["kv"]["pos"]))


# ---------------------------------------------------------------------------------
# transformer.py: the paged-layout decode against _ring_decode_attention
# ---------------------------------------------------------------------------------

def test_paged_decode_matches_ring_decode_attention(pair):
    """The in-place, paged-kernel decode gives the reference's output and
    cache on the same cache, for packed rows naming a subset of slots, and
    its lengths mask selects exactly the ``pos`` mask's keys."""
    jcfg, jparams, tcfg, model = pair
    rng = np.random.default_rng(7)
    n_slots, cap = 4, 32
    jm = JModel(jcfg)
    prompts = [rng.integers(1, jcfg.vocab_size, (1, n)).astype(np.int32)
               for n in (3, 16, 9, 31)]
    layer_caches = [jax.tree.map(lambda t: t[0],
                                 jm.prefill(jparams, {"tokens": jnp.asarray(p)},
                                            max_len=cap)[1]["blocks"]["kv"])
                    for p in prompts]
    cache = jax.tree.map(lambda *xs: jnp.concatenate(xs), *layer_caches)
    slots = np.asarray([1, 3, 0], np.int32)          # packed rows, any order
    index = np.asarray([16, 31, 3], np.int32)        # each slot's length
    h = _bf16(rng, 3, 1, jcfg.d_model)
    p_attn = jax.tree.map(lambda v: JL.Param(v, ()), _layer0(jparams, "attn"))
    packed = jax.tree.map(lambda t: t[slots], cache)
    jy, jnew = JT._ring_decode_attention(
        p_attn, h, jcfg, positions=jnp.asarray(index)[:, None], cache=packed,
        cache_index=jnp.asarray(index), window=None)

    tcache = cache_from_numpy(jax.tree.map(np.asarray, cache), "cpu")
    ty = TT.decode_attention(
        TT.layer_params(model.params["blocks"], 0)["attn"], T(h), tcfg,
        positions=torch.from_numpy(index)[:, None], cache=tcache,
        cache_index=torch.from_numpy(index), slots=torch.from_numpy(slots))
    close(jy, ty)
    for name in ("k", "v", "pos"):
        close(jnew[name], tcache[name][torch.from_numpy(slots).long()], 0)

    # the kernel's mask (position < index + 1 in the slot's identity pages)
    # selects the same keys as the reference's (0 <= pos <= index)
    cpos = tcache["pos"][torch.from_numpy(slots).long()]
    kpos = torch.arange(cap)[None, :]
    lengths_mask = kpos < torch.from_numpy(index)[:, None] + 1
    pos_mask = (cpos >= 0) & (cpos <= torch.from_numpy(index)[:, None])
    assert torch.equal(lengths_mask, pos_mask)
    page = TT.page_size_for(cap)
    tables = TT.slot_block_tables(torch.from_numpy(slots), cap, page)
    assert tables.dtype == torch.int32
    assert torch.equal(tables[:, 0], torch.from_numpy(slots) * (cap // page))


# ---------------------------------------------------------------------------------
# device and family guards
# ---------------------------------------------------------------------------------

def test_model_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(t_smoke(get_config("olmo-1b")))


@pytest.mark.parametrize("arch,change,feature", [
    ("internvl2-76b", {"family": "video"}, "family 'video'"),
    ("seamless-m4t-medium", {"hybrid": True, "ssm_kind": "rwkv"},
     "hybrid ssm_kind 'rwkv'"),
])
def test_unported_families_raise(arch, change, feature):
    """Every arch in ARCH_IDS runs, the encoder-decoder and vision
    families too; the model refuses a layout no registered config uses,
    naming the missing feature."""
    Model(t_smoke(get_config(arch)), device="cpu")
    cfg = dataclasses.replace(t_smoke(get_config(arch)), **change)
    with pytest.raises(NotImplementedError, match=feature) as err:
        Model(cfg, device="cpu")
    assert "not ported to PyTorch" in str(err.value)


def _same_dtype(jdtype, tdtype) -> bool:
    return jnp.dtype(jdtype).name == str(tdtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", list(ARCH_IDS))
def test_config_matches_reference(arch):
    """The port's config of every arch equals the reference's field by
    field (dtypes mapped by name), and so does its parameter count."""
    ref, ours = all_configs()[arch], get_config(arch)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(ours, f.name)
        if f.name in ("dtype", "logits_dtype"):
            assert _same_dtype(a, b), (f.name, a, b)
        else:
            assert a == b, (f.name, a, b)
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()
