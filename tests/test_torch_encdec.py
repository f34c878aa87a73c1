"""The port's encoder-decoder (seamless-m4t-medium) and vision-language
(internvl2-76b) families against the reference, with shared weights.

Weights come from the reference's ``init`` (a jax PRNG key) and cross
through ``convert.params_from_numpy``; frames and patch embeddings are the
reference's own arrays (``numpy.random.default_rng`` draws times 0.02, as
its ``synthetic_frontend_embeddings`` scales them) passed through numpy,
never random draws compared across frameworks.  Logits are held within
the bf16 tolerance 3e-2 of the reference's (forward, prefill, teacher-forced
decode; measured: seamless 0.0156 / 0 / 0.0156, internvl 0.0234 / 0.0234
/ 0.0166, one or two bf16 ulps of logits near 2 to 4), the cross caches
bit-equal to theirs (measured so).  The reference's
setup is ``tests/test_models.py::test_prefill_decode_matches_forward``'s
(B 2, S 10, prompt 6, ``max_len`` 32).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import all_configs, smoke_config
from repro.models import frontends as JF
from repro.models import model as JM
from repro_torch.configs.base import get_config, smoke_config as t_smoke
from repro_torch.convert import (numpy_from_params, params_from_numpy,
                                 tensor_from_numpy)
from repro_torch.models import frontends as TF
from repro_torch.models import model as TM
from repro_torch.models.model import Model

torch.set_num_threads(1)

BF16_TOL = 3e-2
ARCHS = ["seamless-m4t-medium", "internvl2-76b"]
B, S, P = 2, 10, 6


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, jax params, port cfg, port model, batch)."""
    jcfg = smoke_config(all_configs()[request.param])
    tcfg = t_smoke(get_config(request.param))
    jparams = JM.Model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)}
    emb = (rng.standard_normal((B, jcfg.frontend_tokens, jcfg.d_model))
           * 0.02).astype(np.float32)
    emb = np.asarray(jnp.asarray(emb).astype(jcfg.dtype))    # bf16 arrays
    batch["frames" if jcfg.encoder_layers else "patch_embeds"] = emb
    return jcfg, jparams, tcfg, Model(tcfg, params=tparams, device="cpu"), batch


def _frontend_kw(batch):
    return {k: tensor_from_numpy(v, "cpu") for k, v in batch.items()
            if k in ("frames", "patch_embeds")}


def test_frontend_contract():
    for arch in ARCHS:
        jcfg, tcfg = all_configs()[arch], get_config(arch)
        assert TF.frontend_embedding_shape(tcfg, 3) == \
            JF.frontend_embedding_shape(jcfg, 3)
        g = torch.Generator().manual_seed(0)
        x = TF.synthetic_frontend_embeddings(g, t_smoke(tcfg), 2)
        assert x.shape == (2, t_smoke(tcfg).frontend_tokens, 128)
        assert x.dtype == torch.bfloat16
        assert 0.01 < float(x.float().std()) < 0.03
    with pytest.raises(ValueError, match="no modality frontend"):
        TF.frontend_embedding_shape(get_config("olmo-1b"), 1)


def test_param_tree_and_round_trip(pair):
    jcfg, jparams, tcfg, model, _ = pair
    params = model.params
    if tcfg.encoder_layers:
        assert set(params["encoder"]) == {"blocks", "final_norm"}
        assert params["encoder"]["blocks"]["attn"]["wq"].shape[0] == \
            tcfg.encoder_layers
        assert "cross" in params["blocks"] and "cross_norm" in params["blocks"]
        assert "cross" not in params["encoder"]["blocks"]
    else:
        assert "encoder" not in params and "cross" not in params["blocks"]
    # numpy_from_params inverts params_from_numpy, bf16 bit for bit
    back = numpy_from_params(params, bf16=jnp.bfloat16)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jparams)),
                    jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    # the port's own init draws the same tree
    own = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.structure(numpy_from_params(own)) == \
        jax.tree.structure(back)


def test_forward_matches_reference(pair):
    jcfg, jparams, tcfg, model, batch = pair
    jl, jaux = jax.jit(lambda p, b: JM.forward(p, jcfg, b))(jparams, batch)
    tb = dict(_frontend_kw(batch), tokens=torch.from_numpy(batch["tokens"]))
    with torch.no_grad():
        tl, taux = model(tb)
    assert tl.shape == (B, S, tcfg.vocab_size)      # the patch prefix cut
    np.testing.assert_allclose(tl.float().numpy(), _np(jl), atol=BF16_TOL)
    assert float(taux) == float(jaux) == 0.0


def test_prefill_decode_match_reference(pair):
    jcfg, jparams, tcfg, model, batch = pair
    kw = _frontend_kw(batch)
    jbatch = dict(batch, tokens=batch["tokens"][:, :P])
    jl, jc, jidx = JM.prefill(jparams, jcfg, jbatch, max_len=32)
    tl, tc, tidx = model.prefill(torch.from_numpy(batch["tokens"][:, :P]),
                                 32, **kw)
    prefix = 0 if tcfg.encoder_layers else tcfg.frontend_tokens
    assert jidx == tidx == P + prefix
    np.testing.assert_allclose(tl.float().numpy(), _np(jl), atol=BF16_TOL)
    if tcfg.encoder_layers:
        for name in ("cross_k", "cross_v"):
            want, got = _np(jc["blocks"][name]), tc["blocks"][name].float()
            assert got.shape == (tcfg.n_layers, B, tcfg.frontend_tokens,
                                 tcfg.n_kv_heads, tcfg.head_dim)
            np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tc["blocks"]["kv"]["pos"].numpy(),
                                  np.asarray(jc["blocks"]["kv"]["pos"]))
    decode = jax.jit(lambda p, c, t, i: JM.decode_step(p, jcfg, c, t, i))
    index = np.full((B,), jidx, np.int32)
    for t in range(P, S):
        tok = batch["tokens"][:, t:t + 1]
        jl, jc = decode(jparams, jc, jnp.asarray(tok), jnp.asarray(index))
        tl, tc = model.decode_step(tc, torch.from_numpy(tok),
                                   torch.from_numpy(index))
        np.testing.assert_allclose(tl.float().numpy(), _np(jl),
                                   atol=BF16_TOL)
        index += 1
    # decode leaves the cross cache as prefill wrote it
    if tcfg.encoder_layers:
        np.testing.assert_array_equal(tc["blocks"]["cross_k"].float().numpy(),
                                      _np(jc["blocks"]["cross_k"]))


def test_teacher_forced_decode_matches_forward(pair):
    """The reference's own criterion (tests/test_models.py): teacher-forced
    decode within 0.02 of the parallel forward, on the port alone."""
    jcfg, jparams, tcfg, model, batch = pair
    kw = _frontend_kw(batch)
    tokens = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        full, _ = model(dict(kw, tokens=tokens))
    logits, cache, idx = model.prefill(tokens[:, :P], 32, **kw)
    errs = [float((logits[:, 0].float() - full[:, P - 1].float()).abs().max())]
    index = torch.full((B,), idx, dtype=torch.int32)
    for t in range(P, S):
        sl, cache = model.decode_step(cache, tokens[:, t:t + 1], index)
        errs.append(float((sl[:, 0].float() - full[:, t].float()).abs().max()))
        index += 1
    assert max(errs) < 0.02, errs


def test_cross_decode_reads_the_slots_rows():
    """Packed rows naming cache slots read those slots' cross K/V: decode
    of rows (1, 0) of a two-row cache equals decode of the rows as they
    lie, swapped."""
    cfg = t_smoke(get_config("seamless-m4t-medium"))
    model = Model(cfg, device="cpu")
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    frames = TF.synthetic_frontend_embeddings(g, cfg, B)
    _, cache, idx = model.prefill(tokens[:, :P], 32, frames=frames)
    twin = jax.tree.map(torch.clone, cache)
    index = torch.full((B,), idx, dtype=torch.int32)
    straight, _ = model.decode_step(cache, tokens[:, P:P + 1], index)
    swapped, _ = model.decode_step(twin, tokens[[1, 0], P:P + 1], index,
                                   slots=torch.tensor([1, 0]))
    torch.testing.assert_close(swapped, straight[[1, 0]], atol=0, rtol=0)


def test_encdec_needs_frames():
    model = Model(t_smoke(get_config("seamless-m4t-medium")), device="cpu")
    with pytest.raises(ValueError, match="frames"):
        model.prefill(torch.zeros((1, 4), dtype=torch.int64), 16)


def test_train_reaches_encoder_and_cross_leaves():
    """Gradients of seamless's loss reach every encoder and cross-attention
    leaf (nonzero), through the encoder's train-mode attention."""
    cfg = t_smoke(get_config("seamless-m4t-medium"))
    model = Model(cfg, device="cpu").train()
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=g)
    frames = TF.synthetic_frontend_embeddings(g, cfg, 2)
    loss, _ = model.loss({"tokens": tokens, "targets": tokens,
                          "frames": frames})
    loss.backward()
    enc = [t for t in model.buffers() if t.grad is None]
    assert not enc
    for name, t in TM._flatten(model.params):
        if name.startswith("encoder") or "cross" in name:
            assert bool((t.grad != 0).any()), name


def test_encoder_copies_the_reference_s_causal_scan():
    """The reference's scanned encoder attends causally (its
    ``scan_blocks`` does not pass ``causal=False`` on; only its unrolled
    loop does), and the port copies both: the scanned encoder matches the
    reference's and differs from the bidirectional unrolled one, which
    matches the reference's unrolled encoder.  A fix of the reference
    fails the first comparison (ROADMAP Queue 3)."""
    from repro.models import layers as JL
    jcfg = smoke_config(all_configs()["seamless-m4t-medium"])
    tcfg = t_smoke(get_config("seamless-m4t-medium"))
    jparams = JM.Model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    rng = np.random.default_rng(9)
    frames = (rng.standard_normal((B, jcfg.frontend_tokens, jcfg.d_model))
              * 0.02).astype(np.float32)
    jf = jnp.asarray(frames).astype(jnp.bfloat16)
    tf = tensor_from_numpy(np.asarray(jf), "cpu")

    def unrolled(tree, n):                      # the stack as a layer list
        return [jax.tree.map(lambda p: JL.Param(p.value[i], p.axes[1:]),
                             tree, is_leaf=JL.is_param) for i in range(n)]

    n = jcfg.encoder_layers
    jparams_u = dict(jparams, encoder=dict(
        jparams["encoder"], blocks=unrolled(jparams["encoder"]["blocks"], n)))
    jcfg_u = dataclasses.replace(jcfg, scan_layers=False)
    tparams_u = dict(tparams, encoder=dict(tparams["encoder"], blocks=[
        {k: (v[i] if torch.is_tensor(v) else
             {kk: vv[i] for kk, vv in v.items()})
         for k, v in tparams["encoder"]["blocks"].items()}
        for i in range(n)]))

    run_j = jax.jit(lambda p, f, c: JM._encoder_forward(p, c, f),
                    static_argnums=2)
    scanned, bidir = _np(run_j(jparams, jf, jcfg)), \
        _np(run_j(jparams_u, jf, jcfg_u))
    with torch.no_grad():
        t_scanned = TM._encoder_forward(tparams, tcfg, tf, train=False)
        t_bidir = TM._encoder_forward(tparams_u, tcfg, tf, train=False)
    # within two bf16 ulps of values up to ~3.6 (measured 0 and 0.03125)
    np.testing.assert_allclose(t_scanned.float().numpy(), scanned, atol=6e-2)
    np.testing.assert_allclose(t_bidir.float().numpy(), bidir, atol=6e-2)
    # the fault: the scanned encoder is not the bidirectional one
    # (measured 3.54 apart)
    assert np.abs(scanned - bidir).max() > 0.5
