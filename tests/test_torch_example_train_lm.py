"""The port's ``train_lm`` example against the reference's
``examples/train_lm.py``: the example's olmo-100m (12 layers x 768,
119.5 M parameters) at ``--steps 3 --batch 2 --seq 32``.

The reference runs in a subprocess; the port runs with the reference's
weights patched in (``PRNGKey(0)`` through numpy, as
``test_torch_train.py::test_launcher_losses_match_reference_cli`` does).
Its printed lines equal the reference's but for the per-step ``ms`` (host
wall time) and the losses, which agree within 5e-3: the two trajectories
part by bf16 roundings (measured: 3e-4 at step 0, 2.5e-3 at step 2:
9.3058 / 9.4794 against the reference's 9.3061 / 9.4819).  A second call with
more ``--steps`` into the same directory resumes from the committed step:
it prints no step below it.
"""

import dataclasses
import io
import re
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from test_torch_examples import reference_stdout  # noqa: E402

from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.examples import train_lm as E  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.training.checkpoint import committed_steps  # noqa: E402

ARGS = ["--steps", "3", "--batch", "2", "--seq", "32"]
LOSS = re.compile(r"loss=([0-9.]+)")
STEP = re.compile(r"^step +(\d+) ", re.M)


def _masked(text: str) -> list[str]:
    """The lines with the losses, the per-step host ms and the checkpoint
    directory blanked."""
    text = re.sub(r"checkpoints in \S+$", "checkpoints in *",
                  LOSS.sub("loss=*", text), flags=re.M)
    return [re.sub(r"  \d+ms$", "  *ms", ln) for ln in text.splitlines()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's 3-step runs, then the port's resume
    to 5 steps in the same directory (checkpoints removed after)."""
    ref_dir = tmp_path_factory.mktemp("train_lm_ref")
    port_dir = tmp_path_factory.mktemp("train_lm_port")
    want = reference_stdout("train_lm", ARGS + ["--ckpt-dir", str(ref_dir)])
    jcfg = dataclasses.replace(
        j_get_config("olmo-1b"), name="olmo-100m", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072, vocab_size=8192,
        attn_impl="dense")
    jparams = jax.tree.map(np.asarray,
                           JModel(jcfg).init(jax.random.PRNGKey(0)))

    def with_reference_weights(cfg, *, seed, device):
        return Model(cfg, params=params_from_numpy(jparams, cfg, device),
                     device=device)

    mp = pytest.MonkeyPatch()
    mp.setattr(E, "Model", with_reference_weights)
    out = {"reference": want, "reference_n_params": sum(
        v.value.size for v in jax.tree.leaves(
            jparams, is_leaf=lambda x: hasattr(x, "axes")))}
    try:
        for key, steps in (("port", "3"), ("resume", "5")):
            buf = io.StringIO()
            argv = ["--steps", steps, "--batch", "2", "--seq", "32",
                    "--ckpt-dir", str(port_dir), "--device", "cpu"]
            with redirect_stdout(buf):
                out[f"{key}_result"] = E.main(argv)
            out[key] = buf.getvalue()
            out[f"{key}_committed"] = committed_steps(str(port_dir))
    finally:
        mp.undo()
    yield out
    for d in (ref_dir, port_dir):
        for path in sorted(d.rglob("*"), reverse=True):
            path.unlink() if path.is_file() else path.rmdir()


def test_lines_equal_reference(runs):
    assert _masked(runs["port"]) == _masked(runs["reference"])
    assert runs["port"].splitlines()[0] == (
        "model: olmo-100m 119.5M params; 3 steps of 2x32")


def test_losses_match_reference(runs):
    got = [float(x) for x in LOSS.findall(runs["port"])]
    want = [float(x) for x in LOSS.findall(runs["reference"])]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, atol=5e-3)
    assert runs["port_result"]["losses"][2] == pytest.approx(got[-1],
                                                             abs=1e-4)


def test_parameter_count_is_the_reference_s(runs):
    assert runs["port_result"]["n_params"] == runs["reference_n_params"]


def test_resumes_from_the_committed_step(runs):
    """The first call commits step 3; the second starts there (prints no
    step below 3, trains steps 3 and 4 only) and commits step 5."""
    assert runs["port_committed"] == [3]
    steps = [int(s) for s in STEP.findall(runs["resume"])]
    assert steps == [4]
    assert sorted(runs["resume_result"]["losses"]) == [3, 4]
    assert runs["resume_committed"] == [3, 5]
