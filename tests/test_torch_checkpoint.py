"""The port's checkpoints against the reference's: the same files.

A checkpoint the port writes restores in the reference
(``repro.training.checkpoint.restore``) and one the reference writes
restores in the port, parameters and optimizer state bit for bit, bf16
included (stored as uint16 bits and named "bfloat16" on both sides), the
0-d ``step`` keeping shape ``[]``.  Manifests carry the same leaf keys,
shapes, dtypes and file names, and the files the same bytes.  Then the
reference's own checkpoint cases on the port: a crash mid-save is never
resumed from, async commit, ``TrainLoop`` resuming after a restart, and a
snapshot taken before an async save returns.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.configs.base import all_configs, smoke_config
from repro.models.model import Model as JModel
from repro.training import checkpoint as JC
from repro.training import optimizer as JO
from repro.training import train_loop as JTL
from repro_torch.configs.base import get_config, smoke_config as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.training import checkpoint as TC
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TTL

torch.set_num_threads(1)

#: olmo-1b (stacked blocks, tied embedding, non-parametric norms: empty
#: subtrees), hymba-1.5b (per-layer lists: index keys) and
#: seamless-m4t-medium (the encoder subtree, cross attention)
ARCHS = ["olmo-1b", "hymba-1.5b", "seamless-m4t-medium"]


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    batch = {"tokens": toks, "targets": toks,
             "loss_mask": np.ones((2, 8), np.float32)}
    if cfg.encoder_layers:
        batch["frames"] = (rng.standard_normal(
            (2, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=ARCHS)
def trained(request):
    """The reference's params and optimizer state after one jitted train
    step with gradient compression (so mu, nu, the compression error and
    the step are all nonzero), and the same state in the port."""
    arch = request.param
    jcfg = smoke_config(all_configs()[arch])
    tcfg = t_smoke(get_config(arch))
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    opt = JO.AdamWConfig(lr=1e-3, warmup_steps=1, compress_grads=True)
    jp, js, _ = jax.jit(JTL.make_train_step(jcfg, opt))(
        jparams, JTL.init_train_state(jparams, opt), _batch(jcfg))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    tstate = TTL.init_train_state(
        tparams, TO.AdamWConfig(compress_grads=True))
    _fill_like(tstate, js)
    return jcfg, jp, js, tcfg, tparams, tstate


def _fill_like(tstate, jstate):
    """Copy the reference's optimizer state into the port's tree (jax's
    leaf order is the port's ``leaves`` order: dict keys sorted)."""
    for key in ("mu", "nu", "compress_err"):
        for t, a in zip(TO.leaves(tstate[key]), jax.tree.leaves(jstate[key])):
            t.copy_(torch.from_numpy(np.array(a)))
    tstate["step"] = torch.tensor(int(jstate["step"]), dtype=torch.int32)


def _same_bits(jax_leaf, tensor):
    a = np.asarray(jax_leaf)
    t = tensor.detach()
    if t.dtype == torch.bfloat16:
        b = t.view(torch.int16).numpy().view(np.uint16)
        a = a.view(np.uint16)
    else:
        b = t.numpy()
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a, b)


def _check_state(jp, js, tp, ts):
    jleaves = jax.tree.leaves(JO.param_values(jp))
    assert len(jleaves) == len(TO.leaves(tp))
    for a, b in zip(jleaves, TO.leaves(tp)):
        assert _same_bits(a, b)
    for key in ("mu", "nu", "compress_err"):
        for a, b in zip(jax.tree.leaves(js[key]), TO.leaves(ts[key])):
            assert _same_bits(a, b), key
    assert ts["step"].dim() == 0 and ts["step"].dtype == torch.int32
    assert int(ts["step"]) == int(js["step"])


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step}", "manifest.json")) as f:
        m = json.load(f)
    m.pop("time")
    return m


def test_port_checkpoint_restores_in_reference(trained, tmp_path):
    jcfg, jp, js, tcfg, tp, ts = trained
    d = str(tmp_path / "port")
    TC.save(d, tp, ts, step=7)
    assert JC.committed_steps(d) == [7]
    rp, rs, step = JC.restore_latest(d, jp, js)
    assert step == 7
    for a, b in zip(jax.tree.leaves(JO.param_values(jp)),
                    jax.tree.leaves(JO.param_values(rp))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(rs)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # without a template the reference rebuilds the state from the manifest
    _, free, _ = JC.restore(d, 7, jp)
    assert free["step"].shape == () and int(free["step"]) == int(js["step"])


def test_reference_checkpoint_restores_in_port(trained, tmp_path):
    jcfg, jp, js, tcfg, tp, ts = trained
    d = str(tmp_path / "ref")
    JC.save(d, jp, js, step=4)
    template = TO.tree_map(torch.zeros_like, tp)
    opt_template = TTL.init_train_state(template,
                                        TO.AdamWConfig(compress_grads=True))
    rp, rs, step = TC.restore_latest(d, template, opt_template)
    assert step == 4
    _check_state(jp, js, rp, rs)
    _, free, _ = TC.restore(d, 4, template)
    assert free["step"].shape == () and int(free["step"]) == int(js["step"])


def test_manifests_and_files_are_the_reference_s(trained, tmp_path):
    jcfg, jp, js, tcfg, tp, ts = trained
    JC.save(str(tmp_path / "ref"), jp, js, step=2)
    TC.save(str(tmp_path / "port"), tp, ts, step=2)
    want, got = _manifest(str(tmp_path / "ref"), 2), \
        _manifest(str(tmp_path / "port"), 2)
    assert got == want
    assert want["leaves"]["opt/step"]["shape"] == []
    assert any(m["dtype"] == "bfloat16" for m in want["leaves"].values())
    for meta in want["leaves"].values():
        a = (tmp_path / "ref" / "step_2" / meta["file"]).read_bytes()
        b = (tmp_path / "port" / "step_2" / meta["file"]).read_bytes()
        assert a == b, meta["file"]


@pytest.fixture()
def small():
    cfg = t_smoke(get_config("olmo-1b"))
    model = Model(cfg, device="cpu").train()
    return cfg, model.params


def test_roundtrip(small, tmp_path):
    cfg, params = small
    state = TTL.init_train_state(params, TO.AdamWConfig())
    d = str(tmp_path / "ck")
    TC.save(d, params, state, step=7)
    restored, opt, step = TC.restore_latest(d, params, state)
    assert step == 7
    for a, b in zip(TO.leaves(params), TO.leaves(restored)):
        assert torch.equal(a, b) and b.requires_grad == a.requires_grad
        assert b is not a


def test_crash_mid_save_is_ignored(small, tmp_path):
    cfg, params = small
    d = str(tmp_path / "ck")
    state = TTL.init_train_state(params, TO.AdamWConfig())
    TC.save(d, params, state, step=5)
    # fake an uncommitted later step (crash before COMMITTED)
    os.makedirs(os.path.join(d, "step_9"), exist_ok=True)
    with open(os.path.join(d, "step_9", "manifest.json"), "w") as f:
        f.write("{}")
    os.makedirs(os.path.join(d, "step_11.tmp"), exist_ok=True)
    assert TC.committed_steps(d) == [5]
    _, _, step = TC.restore_latest(d, params, state)
    assert step == 5


def test_async_commit_snapshots_before_returning(small, tmp_path):
    cfg, params = small
    d = str(tmp_path / "ck")
    state = TTL.init_train_state(params, TO.AdamWConfig())
    saved = [t.detach().clone() for t in TO.leaves(params)]
    TC.save(d, params, state, step=3, async_commit=True)
    with torch.no_grad():                 # the next step's in-place update
        for t in TO.leaves(params):
            t.add_(1.0)
    TC.wait_for_pending()
    assert TC.committed_steps(d) == [3]
    restored, _, _ = TC.restore_latest(d, params, state)
    for a, b in zip(saved, TO.leaves(restored)):
        assert torch.equal(a, b)


def test_async_save_error_surfaces(small, tmp_path):
    cfg, params = small
    state = TTL.init_train_state(params, TO.AdamWConfig())
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    TC.save(str(blocker), params, state, step=1, async_commit=True)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        TC.wait_for_pending()


def test_train_loop_resumes_after_restart(small, tmp_path):
    cfg, params = small
    oc = TO.AdamWConfig(lr=1e-3, warmup_steps=1)
    data = iter([_batch(cfg, seed=i) for i in range(100)])
    loop = TTL.TrainLoop(cfg, oc, ckpt_dir=str(tmp_path / "ck"), ckpt_every=5)
    seen = []
    p1, s1, info = loop.run(params, data, steps=6,
                            on_metrics=lambda step, m, dt: seen.append(step))
    TC.wait_for_pending()
    assert seen == list(range(6)) and info["stragglers"] >= 0
    assert TC.committed_steps(str(tmp_path / "ck")) == [5, 6]
    # restart: resumes from step 6's checkpoint, runs 4 more
    fresh = Model(cfg, seed=1, device="cpu").train().params
    loop2 = TTL.TrainLoop(cfg, oc, ckpt_dir=str(tmp_path / "ck"),
                          ckpt_every=5)
    seen.clear()
    data2 = iter([_batch(cfg, seed=i) for i in range(100)])
    p2, s2, _ = loop2.run(fresh, data2, steps=10,
                          on_metrics=lambda step, m, dt: seen.append(step))
    assert int(s2["step"]) == 10 and seen == [6, 7, 8, 9]
    assert TC.committed_steps(str(tmp_path / "ck")) == [5, 6, 10]
    assert all(t.requires_grad for t in TO.leaves(p2))


def test_train_loop_matches_reference_resume(tmp_path):
    """The reference's loop writes every 5 steps; the port resumes from
    its step-5 checkpoint and both run to step 8 on the same batches:
    losses within the train-step tolerance, the step counts equal."""
    jcfg = smoke_config(all_configs()["olmo-1b"])
    tcfg = t_smoke(get_config("olmo-1b"))
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    batches = [_batch(jcfg, seed=i) for i in range(20)]
    opt = dict(lr=1e-3, warmup_steps=1)
    jl, tl = [], []
    JTL.TrainLoop(jcfg, JO.AdamWConfig(**opt), ckpt_dir=str(tmp_path / "j"),
                  ckpt_every=5).run(
        jparams, iter(batches), steps=5,
        on_metrics=lambda s, m, dt: jl.append(m["loss"]))
    JC.wait_for_pending()
    template = Model(tcfg, device="cpu").train().params
    _, state, _ = TTL.TrainLoop(tcfg, TO.AdamWConfig(**opt),
                                ckpt_dir=str(tmp_path / "j"),
                                ckpt_every=5).run(
        template, iter(batches[5:]), steps=8,
        on_metrics=lambda s, m, dt: tl.append(m["loss"]))
    # the reference's loop donates its parameters: draw them again
    _, jstate, _ = JTL.TrainLoop(jcfg, JO.AdamWConfig(**opt),
                                 ckpt_dir=str(tmp_path / "j2"),
                                 ckpt_every=100).run(
        JModel(jcfg).init(jax.random.PRNGKey(0)), iter(batches), steps=8,
        on_metrics=lambda s, m, dt: jl.append(m["loss"]))
    assert int(state["step"]) == int(jstate["step"]) == 8
    np.testing.assert_allclose(tl, jl[-3:], rtol=1e-3)
