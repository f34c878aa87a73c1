"""The port's MLA (deepseek-v2-lite-16b: multi-head latent attention on
MoE blocks) against the reference at its smoke width with shared weights:
the decompressed prefill through the flash kernel's wrapper (V padded to
the score head dim), the absorbed decode over the latent cache, the model;
and the flash kernel's head dims, D = 192 included for full-width MLA.

Weights come from the reference's ``init`` (a jax PRNG key), exported to
numpy and moved across with ``repro_torch.convert``; inputs come from
``numpy.random.default_rng``.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models import layers as JL
from repro_torch.configs.base import get_config, smoke_config as t_smoke
from repro_torch.convert import cache_from_numpy, tensor_from_numpy
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model
from test_torch_moe import _pair
from test_torch_hybrid import _decode_vs_forward

torch.set_num_threads(1)

#: the reference's own decode-vs-forward bound for MLA (tests/test_models.py)
MLA_TOL = 0.12


def T(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def F32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16(rng, *shape):
    return jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(
        jnp.bfloat16)


@pytest.fixture(scope="module")
def mla():
    """deepseek-v2-lite-16b at smoke width: latent 32, rope 16, nope 32,
    v 32; a dense layer 0 and 2 stacked MoE layers."""
    return _pair("deepseek-v2-lite-16b")


def test_mla_prefill_matches_reference(mla, monkeypatch):
    """The decompressed prefill: the flash wrapper gets q and k at head
    dim nope + rope and V zero-padded to it (sliced back after); the
    output and the post-RoPE latents match the reference's op-by-op
    ``mla_block`` (latents bit for bit; the output within one bf16 step:
    the attention's f32 sums in another order, measured 2^-8)."""
    jcfg, jparams, _, model = mla
    rng = np.random.default_rng(30)
    x = _bf16(rng, 2, 17, jcfg.d_model)
    pos = jnp.broadcast_to(jnp.arange(17)[None], (2, 17))
    pj = jparams["block0"]["attn"]
    jy, (jc, jk) = JL.mla_block(pj, x, jcfg, positions=pos, return_kv=True)
    seen = []
    inner = TL.attention_core

    def core(q, k, v, **kw):
        seen.append((q.shape, k.shape, v.clone(), kw))
        return inner(q, k, v, **kw)

    monkeypatch.setattr(TL, "attention_core", core)
    ty, (tc, tk) = TL.mla_block(model.params["block0"]["attn"], T(x),
                                model.cfg,
                                positions=torch.from_numpy(np.asarray(pos)),
                                return_kv=True)
    (qs, ks, v, kw), = seen
    cfg = model.cfg
    d = cfg.nope_head_dim + cfg.rope_head_dim
    assert qs[-1] == ks[-1] == v.shape[-1] == d and kw == {"causal": True}
    assert not v[..., cfg.v_head_dim:].any()
    np.testing.assert_array_equal(tc.float().numpy(), F32(jc))
    np.testing.assert_array_equal(tk.float().numpy(), F32(jk))
    np.testing.assert_allclose(ty.float().numpy(), F32(jy), atol=2 ** -6)


def test_absorbed_decode_matches_compiled_reference(mla):
    """The absorbed decode against the reference's compiled ``mla_block``
    decode on the same latent cache, bit for bit, for packed rows naming
    a subset of slots in any order: output, the latents written at
    ``[slot, index]``, and ``pos`` left as the prefill set it (the
    reference's decode does not write it)."""
    jcfg, jparams, jm, model = mla
    rng = np.random.default_rng(31)
    lens = (5, 12, 9, 3)
    layer_caches = []
    for n in lens:
        prompt = rng.integers(1, jcfg.vocab_size, (1, n)).astype(np.int32)
        layer_caches.append(jm.prefill(jparams, {"tokens": jnp.asarray(
            prompt)}, max_len=16)[1]["block0"]["kv"])
    cache = jax.tree.map(lambda *xs: jnp.concatenate(xs), *layer_caches)
    slots = np.asarray([2, 0, 3], np.int32)
    index = np.asarray([lens[2], lens[0], lens[3]], np.int32)
    pj = jparams["block0"]["attn"]
    for trial in range(3):
        h = _bf16(rng, 3, 1, jcfg.d_model)
        ij = jnp.asarray(index)
        packed = jax.tree.map(lambda t: t[slots], cache)
        jy, jnew = jax.jit(lambda p, h, c: JL.mla_block(
            p, h, jcfg, positions=ij[:, None], cache=c, cache_index=ij))(
                pj, h, packed)
        tcache = cache_from_numpy(jax.tree.map(np.asarray, cache), "cpu")
        before = tcache["pos"].clone()
        ty = TL.mla_decode(model.params["block0"]["attn"], T(h), model.cfg,
                           positions=torch.from_numpy(index)[:, None],
                           cache=tcache, cache_index=torch.from_numpy(index),
                           slots=torch.from_numpy(slots))
        np.testing.assert_array_equal(ty.float().numpy(), F32(jy))
        rows = torch.from_numpy(slots).long()
        for name in ("c", "k_pe", "pos"):
            np.testing.assert_array_equal(
                tcache[name][rows].float().numpy(), F32(jnew[name]))
        assert torch.equal(tcache["pos"], before)
        index = index + 1


def test_mla_prefill_and_greedy_decode_match_reference(mla):
    """Prefill and 8 greedy decode steps against the reference's prefill
    and compiled decode_step: tokens equal; logits within MLA_TOL
    (measured 0.0195: the eager block0 prefill's attention sums round a
    latent the other way now and then)."""
    jcfg, jparams, jm, model = mla
    assert "c" in model.init_cache(1, 8)["blocks"]["kv"]
    prompt = np.random.default_rng(6).integers(
        1, jcfg.vocab_size, (2, 11)).astype(np.int32)
    jl, jc, idx = jm.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                             max_len=32)
    tl, tc, tidx = model.prefill(torch.from_numpy(prompt), 32)
    assert idx == tidx == 11
    np.testing.assert_allclose(tl.float().numpy(), F32(jl), atol=MLA_TOL)
    decode = jax.jit(jm.decode_step)
    jtok = np.asarray(jnp.argmax(jl[:, -1].astype(jnp.float32), -1), np.int32)
    ttok = torch.argmax(tl[:, -1].float(), -1).to(torch.int32)
    index = np.full((2,), idx, np.int32)
    for _ in range(8):
        jl, jc = decode(jparams, jc, jnp.asarray(jtok[:, None]),
                        jnp.asarray(index))
        tl, tc = model.decode_step(tc, ttok[:, None], torch.from_numpy(index))
        np.testing.assert_allclose(tl.float().numpy(), F32(jl), atol=MLA_TOL)
        jtok = np.asarray(jnp.argmax(jl[:, -1].astype(jnp.float32), -1),
                          np.int32)
        ttok = torch.argmax(tl[:, -1].float(), -1).to(torch.int32)
        np.testing.assert_array_equal(jtok, ttok.numpy())
        index += 1
    for part in ("block0", "blocks"):
        np.testing.assert_array_equal(tc[part]["kv"]["pos"].numpy(),
                                      np.asarray(jc[part]["kv"]["pos"]))
        np.testing.assert_allclose(tc[part]["kv"]["c"].float().numpy(),
                                   F32(jc[part]["kv"]["c"]), atol=2 ** -5)


def test_mla_decode_matches_reference_forward():
    """Teacher-forced against the reference's ``forward`` under no-drop
    capacity (capacity factor 16, as tests/test_models.py): within the
    reference's MLA bound (measured 0.0469), and no further than the
    reference's own compiled decode (measured equal)."""
    ours, ref = _decode_vs_forward(*_pair("deepseek-v2-lite-16b",
                                          capacity_factor=16.0))
    assert ours < MLA_TOL and ours <= ref


def test_prompt_longer_than_the_latent_cache_raises(mla):
    _, _, _, model = mla
    with pytest.raises(ValueError, match="does not fit"):
        model.prefill(torch.ones((1, 9), dtype=torch.int32), 8)


# ---------------------------------------------------------------------------------
# the flash kernel's head dims
# ---------------------------------------------------------------------------------

def test_flash_head_dims_match_the_cuda_switch():
    """The wrapper's ``HEAD_DIMS`` and the instantiations the CUDA source's
    dispatch ``switch`` names are the same dims, 192 (MLA: nope 128 + rope
    64) among them; the source raises the shared-memory limit through a
    once-per-instantiation helper, not on every launch."""
    src = open(os.path.join(os.path.dirname(fa_ops.__file__), "csrc",
                            "flash_attention.cu")).read()
    cases = sorted(int(d) for d in re.findall(
        r"case (\d+): return launch<\1>", src))
    assert tuple(cases) == fa_ops.HEAD_DIMS
    assert 192 in fa_ops.HEAD_DIMS
    full = get_config("deepseek-v2-lite-16b")
    assert full.nope_head_dim + full.rope_head_dim in fa_ops.HEAD_DIMS
    assert src.count("cudaFuncSetAttribute(") == 1
    assert "allow_smem<D>()" in src


def test_flash_plain_version_takes_d192():
    """On the CPU the wrapper runs its plain version at D = 192, as the
    MLA prefill gives it (causal, V zero-padded), and agrees with the
    reference's dense attention."""
    rng = np.random.default_rng(32)
    q, k, v = (_bf16(rng, 1, 40, 2, 192) for _ in range(3))
    v = v.at[..., 128:].set(0)
    want = JL.attention_core(q, k, v, impl="dense", causal=True)
    got = fa_ops.flash_attention(T(q), T(k), T(v), causal=True)
    np.testing.assert_allclose(got.float().numpy(), F32(want), atol=2 ** -8)
    assert not got[..., 128:].any()


def test_random_init_matches_reference_layout(mla):
    jcfg, jparams, _, _ = mla
    ours = Model(t_smoke(get_config("deepseek-v2-lite-16b")),
                 device="cpu").params
    ref = jax.tree.map(lambda p: (tuple(p.value.shape), p.value.dtype.name),
                       jparams, is_leaf=JL.is_param)
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).removeprefix("torch.")), ours)
    assert got == ref
    assert TT.first_stacked_layer(jcfg) == 1
