"""The port's training stack against the reference, with shared weights.

Weights come from the reference's ``init`` (a jax PRNG key) and cross
through ``convert.params_from_numpy``; batches are numpy arrays from
``numpy.random.default_rng`` (or the data pipeline) fed to both packages.
The reference runs jitted, as its train step does.

Tolerances, each measured on this suite's inputs first (the value in
brackets):
- ``loss_fn`` (B2 S10): the loss within ``LOSS_TOL`` (relative) of the
  reference's per family.  Dense, encdec and vlm stacks compute the
  forward op for op [0 to 2.8e-7]; MoE and MLA, hybrid and xLSTM sit
  further from XLA's fused f32 sums and softmax [6.2e-5 and 2.0e-4;
  1.1e-4; 2.5e-5], which a router's top-k or a capacity drop can turn
  into a discrete change.  The train step's batch (B4 S16) lands more
  bf16 roundings on the other side: ``STEP_LOSS_TOL`` [olmo 0, seamless
  3.3e-5, deepseek-moe 6.8e-4].
- gradients after one ``make_train_step``: per-leaf rel L2 within
  ``GRAD_REL_L2`` for olmo-1b and seamless [8.6e-3, 1.15e-2: bf16
  gradients whose backward rounds in another order than XLA's fusions,
  ~2 bf16 ulps]; deepseek-moe-16b leaf by leaf no further from the
  jitted reference than the reference's own eager run lands from it on
  that leaf: its routing flips with the last bit of the router logits,
  and the flipped tokens reach every leaf through the loss [port / eager:
  embed 0.086 / 0.146, unembed 0.033 / 0.040, final norm 0.024 / 0.034,
  block0 attention and MLP 0.072-0.097 / 0.118-0.154, scanned attention
  0.063-0.078 / 0.088-0.147, router 0.112 / 0.318, routed experts
  0.099-0.113 / 0.116-0.159, shared expert 0.032-0.054 / 0.056-0.062;
  the port's largest share of the eager distance 0.94, shared ``wi``].
- parameters after the step: ``PARAM_ABS`` (a sign flip of a near-zero
  gradient moves a parameter by 2 lr, plus one bf16 ulp), on a share of
  elements below ``PARAM_SHARE`` [0.14%, 0.26%; MoE 1.6%].
- ``adamw_update`` fed the reference's gradients: rel 1e-6 on the
  parameters and the gradient norm [params 3.7e-9 abs; norm 9.5e-7:
  XLA's f32 sum lands 9.5e-7 from the exact (f64) norm of
  deepseek-moe-16b's gradients, the port's 2.6e-8], so mu within 2e-6
  [1.0e-6] and nu within 4e-6 [2.0e-6: the squared gradient doubles the
  norm's error], over two steps.
"""

import dataclasses
import io
import re
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs.base import ARCH_IDS, all_configs, smoke_config
from repro.data import pipeline as JP
from repro.models.model import Model as JModel
from repro.models.model import loss_fn as j_loss_fn
from repro.training import optimizer as JO
from repro.training import train_loop as JTL
from repro_torch.configs.base import get_config, smoke_config as t_smoke
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.data import pipeline as TP
from repro_torch.kernels.dequant import ops as dq
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.mlstm_scan import ops as ml
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.models.model import Model, loss_fn as t_loss_fn
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TTL

torch.set_num_threads(1)

LOSS_TOL = {"dense": 2e-6, "encdec": 2e-6, "vlm": 2e-6, "moe": 5e-4,
            "ssm": 1e-4, "hybrid": 3e-4}
STEP_LOSS_TOL = {"dense": 1e-6, "encdec": 1e-4, "moe": 2e-3}
GRAD_REL_L2 = 2e-2
PARAM_ABS = 5e-3
PARAM_SHARE = {"olmo-1b": 5e-3, "seamless-m4t-medium": 5e-3,
               "deepseek-moe-16b": 5e-2}


def _pair(arch, **over):
    jcfg = dataclasses.replace(smoke_config(all_configs()[arch]), **over)
    tcfg = dataclasses.replace(t_smoke(get_config(arch)), **over)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _batch(cfg, b=2, s=10, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "loss_mask": (rng.random((b, s)) > 0.2).astype(np.float32)}
    if cfg.frontend:
        emb = (rng.standard_normal((b, cfg.frontend_tokens, cfg.d_model))
               * 0.02).astype(np.float32)
        batch["frames" if cfg.encoder_layers else "patch_embeds"] = emb
    return batch


def _trainable(tparams):
    for t in TO.leaves(tparams):
        t.requires_grad_(True)
    return tparams


def _family(cfg):
    return "moe" if cfg.n_routed_experts else cfg.family


def _jleaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


# ---------------------------------------------------------------------------------
# The kernel wrappers refuse autograd
# ---------------------------------------------------------------------------------

def _kernel_calls():
    """(name, call(requires_grad)) for each wrapper on small CPU inputs."""
    g = torch.Generator().manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=g)

    def flash(rg):
        q, k, v = (rn(1, 8, 2, 32).bfloat16().requires_grad_(rg)
                   for _ in range(3))
        return fa.flash_attention(q, k, v, causal=True)

    def paged(rg):
        q = rn(2, 2, 32).bfloat16().requires_grad_(rg)
        kp, vp = (rn(4, 16, 2, 32).bfloat16() for _ in range(2))
        tables = torch.arange(4, dtype=torch.int32).view(2, 2)
        return pa.paged_attention(q, kp, vp, tables,
                                  torch.tensor([5, 20], dtype=torch.int32))

    def mlstm(rg):
        q, k = (rn(1, 8, 2, 8).requires_grad_(rg) for _ in range(2))
        v = rn(1, 8, 2, 8)
        li, lf = rn(1, 8, 2), torch.nn.functional.logsigmoid(rn(1, 8, 2))
        return ml.mlstm_scan(q, k, v, li, lf, chunk=4)[0]

    def dequant(rg):
        codes = torch.randint(0, 255, (2, 128), dtype=torch.uint8,
                              generator=g)
        return dq.dequant(codes, rn(2).abs().requires_grad_(rg), codec="int8")

    return [("flash_attention", flash), ("paged_attention", paged),
            ("mlstm_scan", mlstm), ("dequant", dequant)]


@pytest.mark.parametrize("name,call", _kernel_calls(),
                         ids=[n for n, _ in _kernel_calls()])
class TestKernelsRefuseAutograd:
    def test_raises_on_an_input_that_requires_grad(self, name, call):
        with pytest.raises(RuntimeError, match=f"{name}.*no backward.*JAX"):
            call(True)

    def test_no_grad_serving_is_unaffected(self, name, call):
        with torch.no_grad():
            out = call(True)
        assert torch.isfinite(out.float()).all()

    def test_inputs_without_grad_are_unaffected(self, name, call):
        out = call(False)
        assert not out.requires_grad and torch.isfinite(out.float()).all()


ALL_ARCHS = list(ARCH_IDS) + ["xlstm-1.3b+slstm"]


def _arch_over(arch):
    if arch == "xlstm-1.3b+slstm":            # layer 1 an sLSTM block
        return "xlstm-1.3b", {"slstm_every": 2}
    return arch, {}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_train_step_passes_the_guard(arch):
    """A full train step of every family (the port's own weights) runs
    without reaching a kernel wrapper and reaches every leaf."""
    arch, over = _arch_over(arch)
    cfg = dataclasses.replace(t_smoke(get_config(arch)), **over)
    model = Model(cfg, device="cpu").train()
    opt = TO.AdamWConfig(lr=1e-3, warmup_steps=1)
    counts = {f: f.launches for f in (fa.flash_attention, pa.paged_attention,
                                       ml.mlstm_scan, dq.dequant)}
    params, state, metrics = TTL.make_train_step(cfg, opt)(
        model.params, TTL.init_train_state(model.params, opt), _batch(cfg))
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    assert int(state["step"]) == 1
    # the first moment is the clipped gradient's tenth: nonzero where a
    # gradient arrived
    assert all(bool((m != 0).any()) for m in TO.leaves(state["mu"])), \
        "a parameter got no gradient"
    assert all(t.grad is None for t in TO.leaves(params))
    assert {f: f.launches for f in counts} == counts


# ---------------------------------------------------------------------------------
# loss_fn
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_fn_matches_reference(arch):
    name, over = _arch_over(arch)
    jcfg, jparams, tcfg, tparams = _pair(name, **over)
    batch = _batch(jcfg)
    jt, jm = jax.jit(lambda p, b: j_loss_fn(p, jcfg, b))(jparams, batch)
    with torch.no_grad():
        tt, tm = t_loss_fn(tparams, tcfg, TTL.batch_to_device(batch, "cpu"))
    tol = LOSS_TOL[_family(tcfg)]
    for key in ("loss", "z_loss", "moe_aux"):
        assert abs(float(jm[key]) - float(tm[key])) <= tol * max(
            1.0, abs(float(jm[key]))), (key, float(jm[key]), float(tm[key]))
    assert float(tm["tokens"]) == float(jm["tokens"])
    assert abs(float(jt) - float(tt)) <= tol * abs(float(jt))
    assert (float(tm["moe_aux"]) > 0) == bool(tcfg.n_routed_experts)


def test_train_attention_follows_attn_impl():
    from repro_torch.models.layers import train_attention
    cfg = t_smoke(get_config("olmo-1b"))
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 40, 4, 32, generator=g) for _ in range(3))
    dense = train_attention(q, k, v, cfg, causal=True)
    blockwise = train_attention(q, k, v, dataclasses.replace(
        cfg, attn_impl="blockwise", attn_block_kv=16), causal=True)
    torch.testing.assert_close(blockwise, dense, atol=1e-5, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="no backward"):
        train_attention(q, k, v, dataclasses.replace(cfg, attn_impl="pallas"),
                        causal=True)


def test_moe_aux_is_the_switch_loss():
    """moe_block's aux against the reference's on the same input."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    jcfg, jparams, tcfg, tparams = _pair("deepseek-moe-16b")
    pj = jax.tree.map(lambda p: p.value[0], jparams["blocks"]["mlp"],
                      is_leaf=JL.is_param)
    pj = jax.tree.map(lambda v: JL.Param(v, ()), pj)
    pt = {k: (v[0] if torch.is_tensor(v) else {kk: vv[0] for kk, vv in v.items()})
          for k, v in tparams["blocks"]["mlp"].items()}
    x = np.random.default_rng(3).standard_normal((2, 10, 128)).astype(np.float32)
    _, ja = JL.moe_block(pj, jnp.asarray(x).astype(jnp.bfloat16), jcfg)
    _, ta = TL.moe_block(pt, torch.from_numpy(x).bfloat16(), tcfg)
    assert abs(float(ja) - float(ta)) <= 1e-6 * float(ja)
    assert float(ta) > 0


# ---------------------------------------------------------------------------------
# One train step
# ---------------------------------------------------------------------------------

def _reference_grads(jcfg, jparams, batch, jit=True):
    fn = jax.value_and_grad(lambda p, b: j_loss_fn(p, jcfg, b), has_aux=True)
    _, grads = (jax.jit(fn) if jit else fn)(jparams, batch)
    return _jleaves(JO.param_values(grads))


@pytest.mark.parametrize("arch", ["olmo-1b", "seamless-m4t-medium",
                                  "deepseek-moe-16b"])
def test_train_step_matches_reference(arch):
    jcfg, jparams, tcfg, tparams = _pair(arch)
    _trainable(tparams)
    batch = _batch(jcfg, b=4, s=16)
    want = _reference_grads(jcfg, jparams, batch)
    # the port's gradients, from the same loss the step differentiates
    total, _ = t_loss_fn(tparams, tcfg, TTL.batch_to_device(batch, "cpu"))
    total.backward()
    got = [t.grad.float().numpy() for t in TO.leaves(tparams)]
    rels = [_rel(a, b) for a, b in zip(want, got)]
    limits = [GRAD_REL_L2] * len(rels)
    if tcfg.n_routed_experts:
        eager = _reference_grads(jcfg, jparams, batch, jit=False)
        limits = [max(GRAD_REL_L2, _rel(a, b)) for a, b in zip(want, eager)]
    for i, (rel, limit) in enumerate(zip(rels, limits)):
        assert rel <= limit, (i, rel, limit)
    for t in TO.leaves(tparams):
        t.grad = None

    jopt, topt = JO.AdamWConfig(lr=1e-3, warmup_steps=1), \
        TO.AdamWConfig(lr=1e-3, warmup_steps=1)
    jp2, js2, jm = jax.jit(JTL.make_train_step(jcfg, jopt))(
        jparams, JTL.init_train_state(jparams, jopt), batch)
    tp2, ts2, tm = TTL.make_train_step(tcfg, topt)(
        tparams, TTL.init_train_state(tparams, topt), batch)
    diffs = [np.abs(a - b.detach().float().numpy())
             for a, b in zip(_jleaves(JO.param_values(jp2)), TO.leaves(tp2))]
    share = sum((d > 0).sum() for d in diffs) / sum(d.size for d in diffs)
    assert max(d.max() for d in diffs) <= PARAM_ABS
    assert share <= PARAM_SHARE[arch], share
    assert int(ts2["step"]) == int(js2["step"]) == 1
    assert float(tm["lr"]) == float(jm["lr"])
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= STEP_LOSS_TOL[
        _family(tcfg)] * abs(float(jm["loss"]))


# ---------------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------------

def _grads_tree(tparams, leaves):
    it = iter(leaves)

    def fill(tree):                    # jax's leaf order: dict keys sorted
        if isinstance(tree, dict):
            return {k: fill(tree[k]) for k in sorted(tree)}
        if isinstance(tree, list):
            return [fill(v) for v in tree]
        return tensor_from_numpy(next(it), "cpu")
    return fill(tparams)


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-moe-16b"])
def test_adamw_update_matches_on_reference_grads(arch):
    jcfg, jparams, tcfg, tparams = _pair(arch)
    batch = _batch(jcfg, b=4, s=16)
    fn = jax.value_and_grad(lambda p, b: j_loss_fn(p, jcfg, b), has_aux=True)
    _, g = jax.jit(fn)(jparams, batch)
    gvals = JO.param_values(g)
    opt = dict(lr=1e-3, warmup_steps=1)
    jopt, topt = JO.AdamWConfig(**opt), TO.AdamWConfig(**opt)
    update = jax.jit(lambda p, gg, s: JO.adamw_update(jopt, p, gg, s))
    jp, js = jparams, JO.init_opt_state(jparams)
    ts = TO.init_opt_state(tparams)
    grads = _grads_tree(tparams, [np.asarray(x) for x in jax.tree.leaves(gvals)])
    for _ in range(2):
        jp, js, jm = update(jp, gvals, js)
        tparams, ts, tm = TO.adamw_update(topt, tparams, grads, ts)
        assert abs(float(tm["grad_norm"]) / float(jm["grad_norm"]) - 1) <= 1e-6
        assert float(tm["lr"]) == float(jm["lr"])
    for a, b in zip(_jleaves(JO.param_values(jp)), TO.leaves(tparams)):
        np.testing.assert_allclose(b.float().numpy(), a, rtol=1e-6, atol=1e-8)
    for key, tol in (("mu", 2e-6), ("nu", 4e-6)):
        for a, b in zip(_jleaves(js[key]), TO.leaves(ts[key])):
            assert _rel(a, b.numpy()) <= tol, key
    assert int(ts["step"]) == int(js["step"]) == 2
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 37, 99, 100, 150])
def test_lr_schedule_matches(step):
    jo = JO.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100,
                        min_lr_frac=0.1)
    to = TO.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100,
                        min_lr_frac=0.1)
    want = np.float32(JO.lr_schedule(jo, jnp.int32(step)))
    got = TO.lr_schedule(to, step)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-9 * max(float(want), 1e-30) \
        + np.spacing(np.float32(want))


def test_lr_schedule_shape():
    oc = TO.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                        min_lr_frac=0.1)
    assert float(TO.lr_schedule(oc, 0)) == pytest.approx(0.0)
    assert float(TO.lr_schedule(oc, 10)) == pytest.approx(1.0, rel=0.01)
    assert float(TO.lr_schedule(oc, 100)) == pytest.approx(0.1, rel=0.01)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_int8_codes_bit_equal(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(4096) * 10 ** rng.uniform(-4, 1)).astype(np.float32)
    # values exactly half a step apart test round-half-to-even
    g[:8] = np.float32([1.0, -0.5, 3.0, 1e-4, 127.0, 63.5, -63.5, 0.5])
    err = (rng.standard_normal(4096) * 1e-3).astype(np.float32)
    for e in (None, err):
        jd, je = JO.compress_int8(jnp.asarray(g), None if e is None
                                  else jnp.asarray(e))
        td, te = TO.compress_int8(torch.from_numpy(g), None if e is None
                                  else torch.from_numpy(e))
        np.testing.assert_array_equal(td.numpy().view(np.int32),
                                      np.asarray(jd).view(np.int32))
        np.testing.assert_array_equal(te.numpy().view(np.int32),
                                      np.asarray(je).view(np.int32))
        np.testing.assert_allclose((td + te).numpy(), g + (0 if e is None
                                   else e), rtol=1e-6)


def test_compression_error_feedback():
    g = torch.tensor([1.0, -0.5, 3.0, 1e-4])
    deq, err = TO.compress_int8(g, None)
    np.testing.assert_allclose((deq + err).numpy(), g.numpy(), rtol=1e-6)


def test_microbatching_matches_full_batch_grads():
    """The reference's case: two microbatches against the full batch."""
    cfg = t_smoke(get_config("olmo-1b"))
    oc = TO.AdamWConfig(lr=1e-3, warmup_steps=1)
    base = Model(cfg, device="cpu").params
    batch = _batch(cfg, b=4, s=16)
    out = []
    for n in (1, 2):
        params = _trainable({k: v for k, v in TO.tree_map(
            lambda t: t.detach().clone(), base).items()})
        p, s, m = TTL.make_train_step(cfg, oc, microbatches=n)(
            params, TTL.init_train_state(params, oc), batch)
        out.append((p, m))
    diffs = [float((a.detach().float() - b.detach().float()).abs().max())
             for a, b in zip(TO.leaves(out[0][0]), TO.leaves(out[1][0]))]
    assert max(diffs) < 5e-2
    assert abs(float(out[0][1]["loss_total"])
               - float(out[1][1]["loss_total"])) < 1e-2


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_marks_its_sections(microbatches):
    """The step's forward, backward and optimizer are profiler ranges, one
    forward and backward per microbatch: the card's profile of a train
    step reads them."""
    from torch.profiler import ProfilerActivity, profile
    cfg = t_smoke(get_config("olmo-1b"))
    oc = TO.AdamWConfig(lr=1e-3, warmup_steps=1)
    params = Model(cfg, device="cpu").train().params
    step = TTL.make_train_step(cfg, oc, microbatches=microbatches)
    state = TTL.init_train_state(params, oc)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, state, _batch(cfg, b=4, s=16))
    names = [e.name for e in prof.events() if e.name.startswith("train/")]
    assert sorted(names) == sorted(
        ["train/forward", "train/backward"] * microbatches
        + ["train/optimizer"])


def test_microbatching_matches_the_reference():
    jcfg, jparams, tcfg, tparams = _pair("olmo-1b")
    _trainable(tparams)
    batch = _batch(jcfg, b=4, s=16)
    opt = dict(lr=1e-3, warmup_steps=1)
    _, _, jm = jax.jit(JTL.make_train_step(
        jcfg, JO.AdamWConfig(**opt), microbatches=2))(
        jparams, JTL.init_train_state(jparams, JO.AdamWConfig(**opt)), batch)
    _, _, tm = TTL.make_train_step(tcfg, TO.AdamWConfig(**opt),
                                   microbatches=2)(
        tparams, TTL.init_train_state(tparams, TO.AdamWConfig(**opt)), batch)
    # the mean loss and the last microbatch's metrics
    for key in ("loss_total", "loss", "z_loss", "tokens"):
        assert abs(float(tm[key]) - float(jm[key])) <= 2e-6 * max(
            1.0, abs(float(jm[key]))), key
    assert abs(float(tm["grad_norm"]) / float(jm["grad_norm"]) - 1) < 2e-2


def test_compressed_training_still_converges():
    cfg = t_smoke(get_config("olmo-1b"))
    oc = TO.AdamWConfig(lr=3e-3, warmup_steps=2, compress_grads=True)
    params = Model(cfg, device="cpu").train().params
    state = TTL.init_train_state(params, oc)
    assert set(state) == {"mu", "nu", "step", "compress_err"}
    step = TTL.make_train_step(cfg, oc)
    batch = _batch(cfg, b=4, s=16)
    losses = []
    for _ in range(15):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.4


# ---------------------------------------------------------------------------------
# Data pipeline and the launcher
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("seed,rank,size,start,arch", [
    (0, 0, 1, 0, "olmo-1b"), (3, 1, 2, 5, "olmo-1b"),
    (7, 3, 4, 2, "seamless-m4t-medium"), (11, 0, 2, 9, "internvl2-76b")])
def test_pipeline_batches_equal_reference(seed, rank, size, start, arch):
    jcfg = smoke_config(all_configs()[arch])
    tcfg = t_smoke(get_config(arch))
    kw = dict(vocab_size=512, seq_len=32, global_batch=8, seed=seed)
    ja = JP.batches(JP.DataConfig(**kw), dp_rank=rank, dp_size=size,
                    start_step=start, model_cfg=jcfg)
    ta = TP.batches(TP.DataConfig(**kw), dp_rank=rank, dp_size=size,
                    start_step=start, model_cfg=tcfg)
    for _ in range(3):
        a, b = next(ja), next(ta)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_launcher_losses_match_reference_cli(monkeypatch):
    """``launch/train.py --smoke --steps 10`` with the reference's weights:
    the per-step losses it prints against the reference CLI's."""
    from repro.launch import train as JL
    from repro_torch.launch import train as TL
    argv = ["--arch", "olmo-1b", "--smoke", "--steps", "10"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    out = io.StringIO()
    with redirect_stdout(out):
        JL.main()
    want = [float(x) for x in re.findall(r"loss=([0-9.]+)", out.getvalue())]
    jparams = JModel(smoke_config(all_configs()["olmo-1b"])).init(
        jax.random.PRNGKey(0))

    def with_reference_weights(cfg, *, seed, device):
        return Model(cfg, params=params_from_numpy(
            jax.tree.map(np.asarray, jparams), cfg, device), device=device)

    monkeypatch.setattr(TL, "Model", with_reference_weights)
    out = io.StringIO()
    with redirect_stdout(out):
        result = TL.main(argv + ["--device", "cpu"])
    got = [float(x) for x in re.findall(r"loss=([0-9.]+)", out.getvalue())]
    assert len(want) == len(got) == 10
    # printed to 4 decimals; the trajectories part by bf16 roundings
    # (measured: at most 1.0e-3 over the 10 steps)
    np.testing.assert_allclose(got, want, atol=5e-3)
    assert "done:" in out.getvalue() and "stragglers=" in out.getvalue()
    assert result["losses"][9] == pytest.approx(got[-1], abs=1e-4)


@pytest.mark.parametrize("remat,policy", [(True, "nothing"), (True, "dots"),
                                          (True, "full"), (False, "nothing")])
def test_remat_policies_give_the_same_gradients(remat, policy):
    """Remat recomputes, it does not change the arithmetic: the gradients
    of every policy equal the no-remat ones bit for bit (seamless: the
    scanned decoder and encoder both run under ``remat``)."""
    base = t_smoke(get_config("seamless-m4t-medium"))
    cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
    params = Model(base, device="cpu").params
    batch = TTL.batch_to_device(_batch(base, b=2, s=8), "cpu")

    def grads(c):
        p = _trainable(TO.tree_map(lambda t: t.detach().clone(), params))
        total, _ = t_loss_fn(p, c, batch)
        total.backward()
        return [t.grad for t in TO.leaves(p)]

    want = grads(dataclasses.replace(base, remat=False))
    for a, b in zip(grads(cfg), want):
        assert torch.equal(a, b)
