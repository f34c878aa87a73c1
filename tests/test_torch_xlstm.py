"""The port's xLSTM stack against the reference, with shared weights.

The smoke config keeps ``slstm_every=8`` with 2 layers, so it has no
sLSTM block; both sides take ``slstm_every=2`` here, so layer 0 is mLSTM
and layer 1 sLSTM.  Weights come from the reference's ``init`` (a jax PRNG
key) and cross through ``convert.params_from_numpy``; inputs come from
``numpy.random.default_rng``.  Outputs are held to the reference's within
the bf16 tolerance 3e-2: prefill logits, then 8 greedy decode steps with
identical tokens.  Prefill logits are bit-identical at this config; the
mLSTM scan's f32 rounding (torch's product order, not XLA's) can move a
rare bf16 ulp, hence the tolerance.  States are f32 sums of products of
bf16-rounded k and v: where the f32 projection that gives k or v lands on
the other side of a bf16 rounding step, that term moves by one bf16 ulp
(2^-8 of it), and a block whose bf16 input moved by an ulp moves its whole
row of sLSTM state by ~1e-3; so states (of magnitude 1 to 10) are held
within atol 1e-2 / rtol 1e-3 elementwise and a mean error below 1e-3.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import all_configs, smoke_config
from repro.models import ssm as JS
from repro.models.model import Model as JModel
from repro_torch.configs.base import get_config, smoke_config as t_smoke
from repro_torch.convert import (cache_from_numpy, params_from_numpy,
                                 tensor_from_numpy)
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model

torch.set_num_threads(1)

BF16_TOL = 3e-2
STATE_ATOL, STATE_RTOL, STATE_MEAN = 1e-2, 1e-3, 1e-3


def _cfgs(slstm_every=2):
    jcfg = dataclasses.replace(smoke_config(all_configs()["xlstm-1.3b"]),
                               slstm_every=slstm_every)
    tcfg = dataclasses.replace(t_smoke(get_config("xlstm-1.3b")),
                               slstm_every=slstm_every)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax params, port cfg, port model) sharing one weight set."""
    jcfg, tcfg = _cfgs()
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jparams, tcfg, Model(tcfg, params=tparams, device="cpu")


def close(jax_out, torch_out, atol=BF16_TOL):
    np.testing.assert_allclose(
        torch_out.float().numpy(),
        np.asarray(jnp.asarray(jax_out).astype(jnp.float32)), atol=atol)


def states_close(jstate, tstate):
    assert set(jstate) == set(tstate)
    for name, t in tstate.items():
        assert t.dtype == torch.float32
        want = np.asarray(jstate[name])
        np.testing.assert_allclose(t.numpy(), want, rtol=STATE_RTOL,
                                   atol=STATE_ATOL)
        assert float(np.mean(np.abs(t.numpy() - want))) < STATE_MEAN, name


def _bf16(rng, *shape):
    return jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(
        jnp.bfloat16)


def T(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _mix(jparams, i):
    return jparams["blocks"][i]["mix"]


# ---------------------------------------------------------------------------------
# config, parameter tree, convert.py
# ---------------------------------------------------------------------------------

def test_config_copies_reference_and_layout(pair):
    jcfg, jparams, tcfg, model = pair
    full_j, full_t = all_configs()["xlstm-1.3b"], get_config("xlstm-1.3b")
    for f in ("n_layers", "d_model", "n_heads", "vocab_size", "ssm_kind",
              "slstm_every", "ssm_expand", "head_dim", "rope",
              "scan_layers"):
        assert getattr(full_t, f) == getattr(full_j, f), f
    assert [TT.block_kind(full_t, i) for i in range(full_t.n_layers)].count(
        "slstm") == 6
    assert [TT.block_kind(tcfg, i) for i in range(2)] == ["mlstm", "slstm"]
    blocks = model.params["blocks"]
    assert isinstance(blocks, list) and len(blocks) == tcfg.n_layers
    for i, name in ((0, "wq"), (0, "wf"), (1, "w_in"), (1, "r")):
        j = np.asarray(_mix(jparams, i)[name].value)
        t = blocks[i]["mix"][name]
        assert tuple(t.shape) == j.shape
        bits = (t.view(torch.int16).numpy(), j.view(np.int16)) \
            if t.dtype == torch.bfloat16 else (t.numpy(), j)
        np.testing.assert_array_equal(*bits)


def test_params_from_numpy_checks_layer_count(pair):
    jcfg, jparams, tcfg, _ = pair
    tree = jax.tree.map(np.asarray, jparams)
    tree["blocks"] = tree["blocks"][:1]
    with pytest.raises(ValueError, match="layers"):
        params_from_numpy(tree, tcfg, "cpu")


def test_cache_from_numpy_keeps_state_lists(pair):
    """The reference's empty cache crosses as per-layer state trees, equal
    to the port's own ``init_cache``."""
    jcfg, _, _, model = pair
    jc = JModel(jcfg).init_cache(3, 16)
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    assert isinstance(tc["blocks"], list)
    assert set(tc["blocks"][0]["ssm"]) == {"C", "n", "m"}
    assert set(tc["blocks"][1]["ssm"]) == {"c", "n", "h", "m"}
    assert tc["blocks"][0]["ssm"]["C"].shape == (3, 4, 32, 64)
    ours = model.init_cache(3, 16)
    for tlayer, olayer in zip(tc["blocks"], ours["blocks"]):
        for name, t in tlayer["ssm"].items():
            assert olayer["ssm"][name].dtype == t.dtype
            assert torch.equal(olayer["ssm"][name], t)


# ---------------------------------------------------------------------------------
# ssm.py: the blocks
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [9, 300], ids=["one-chunk", "two-chunks"])
def test_mlstm_chunked(pair, seq):
    jcfg, jparams, tcfg, model = pair
    x = _bf16(np.random.default_rng(1), 2, seq, jcfg.d_model)
    jy, jst = JS.mlstm_chunked(_mix(jparams, 0), x, jcfg)
    ty, tst = TS.mlstm_chunked(model.params["blocks"][0]["mix"], T(x), tcfg)
    assert ty.dtype == torch.bfloat16
    close(jy, ty)
    states_close(jst, tst)


def test_mlstm_step(pair):
    jcfg, jparams, tcfg, model = pair
    rng = np.random.default_rng(2)
    x = _bf16(rng, 3, 1, jcfg.d_model)
    _, jstate = JS.mlstm_chunked(_mix(jparams, 0),
                                 _bf16(rng, 3, 7, jcfg.d_model), jcfg)
    tstate = {k: T(v) for k, v in jstate.items()}
    jy, jnew = jax.jit(lambda p, x, s: JS.mlstm_step(p, x, jcfg, s))(
        _mix(jparams, 0), x, jstate)
    ty, tnew = TS.mlstm_step(model.params["blocks"][0]["mix"], T(x), tcfg,
                             tstate)
    close(jy, ty)
    states_close(jnew, tnew)


def test_slstm_forward_and_step(pair):
    jcfg, jparams, tcfg, model = pair
    rng = np.random.default_rng(3)
    x = _bf16(rng, 2, 12, jcfg.d_model)
    jy, jst = JS.slstm_forward(_mix(jparams, 1), x, jcfg)
    ty, tst = TS.slstm_forward(model.params["blocks"][1]["mix"], T(x), tcfg)
    close(jy, ty)
    states_close(jst, tst)
    x1 = _bf16(rng, 2, 1, jcfg.d_model)
    jy, jnew = JS.slstm_step(_mix(jparams, 1), x1, jcfg, jst)
    ty, tnew = TS.slstm_step(model.params["blocks"][1]["mix"], T(x1), tcfg,
                             {k: T(v) for k, v in jst.items()})
    close(jy, ty)
    states_close(jnew, tnew)


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
    for jlayer, tlayer in zip(jc["blocks"], tc["blocks"]):
        states_close(jlayer["ssm"], tlayer["ssm"])
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
    for jlayer, tlayer in zip(jc["blocks"], tc["blocks"]):
        states_close(jlayer["ssm"], tlayer["ssm"])


def test_decode_steps_packed_rows_in_place(pair):
    """Decode over a subset of slots, in any order, updates exactly those
    rows of the resident state, as the reference's gather / decode /
    scatter does, and leaves the others untouched."""
    jcfg, jparams, tcfg, model = pair
    jm = JModel(jcfg)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, jcfg.vocab_size, (1, n)).astype(np.int32)
               for n in (3, 8, 5, 6)]
    layers = [jm.prefill(jparams, {"tokens": jnp.asarray(p)}, max_len=16)[1]
              for p in prompts]
    resident = jax.tree.map(lambda *xs: jnp.concatenate(xs), *layers)
    slots = np.asarray([2, 0], np.int32)
    tokens = np.asarray([[7], [9]], np.int32)
    index = np.asarray([5, 3], np.int32)
    packed = jax.tree.map(lambda t: t[slots], resident)
    jl, jnew = jax.jit(jm.decode_step)(jparams, packed, jnp.asarray(tokens),
                                       jnp.asarray(index))
    tres = cache_from_numpy(jax.tree.map(np.asarray, resident), "cpu")
    before = jax.tree.map(lambda t: t.clone(), tres)
    tl, tres = model.decode_step(tres, torch.from_numpy(tokens),
                                 torch.from_numpy(index),
                                 torch.from_numpy(slots))
    close(jl, tl)
    rows = torch.from_numpy(slots).long()
    for i, (jlayer, tlayer) in enumerate(zip(jnew["blocks"], tres["blocks"])):
        states_close(jlayer["ssm"],
                     {k: t[rows] for k, t in tlayer["ssm"].items()})
        for name, t in tlayer["ssm"].items():
            for other in (1, 3):
                assert torch.equal(t[other],
                                   before["blocks"][i]["ssm"][name][other])


def test_other_families_still_raise():
    from repro_torch.configs.base import ModelConfig
    mamba = dataclasses.replace(t_smoke(get_config("xlstm-1.3b")),
                                ssm_kind="mamba")
    with pytest.raises(NotImplementedError, match="ssm_kind"):
        Model(mamba, device="cpu")
    stacked = dataclasses.replace(t_smoke(get_config("xlstm-1.3b")),
                                  scan_layers=True)
    with pytest.raises(NotImplementedError, match="scan_layers"):
        Model(stacked, device="cpu")
    assert isinstance(stacked, ModelConfig)
