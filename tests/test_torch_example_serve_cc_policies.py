"""The port's ``serve_cc_policies`` example against the reference's
``examples/serve_cc_policies.py``: the §5.4 table over three policies x
CC on the smoke olmo-1b, every printed number equal.

The reference draws its prompts with ``jax.random``, the port from a
seeded ``torch.Generator``; the table depends on the prompts' lengths, not
their tokens, so the port's cells with the reference's own prompts equal
its cells with its own.
"""

import io
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_examples import (check_same_output,  # noqa: E402
                                 reference_stdout)

from repro_torch.configs.base import get_config, smoke_config  # noqa: E402
from repro_torch.core.policy import SchedulingPolicy as SP  # noqa: E402
from repro_torch.examples import serve_cc_policies as E  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402


def test_output_equals_reference():
    want = reference_stdout("serve_cc_policies", [])
    out = io.StringIO()
    with redirect_stdout(out):
        results = E.main(["--device", "cpu"])
    check_same_output(out.getvalue(), want)
    assert len(results) == 6


def _reference_prompts(vocab_size: int, n: int) -> list:
    """``examples/serve_cc_policies.py``'s prompts (its jax.random draw)."""
    import jax
    key = jax.random.PRNGKey(1)
    prompts = []
    for _ in range(n):
        key, k = jax.random.split(key)
        prompts.append(list(map(int, jax.random.randint(
            k, (E.PROMPT_LEN,), 1, vocab_size))))
    return prompts


@pytest.mark.parametrize("policy,cc_on", [(SP.ASYNC_OVERLAP, True),
                                          (SP.SYNC_DRAIN, False)])
def test_cells_do_not_depend_on_prompt_tokens(policy, cc_on, monkeypatch):
    model = Model(smoke_config(get_config("olmo-1b")), device="cpu")
    ours = E.draw_prompts(model.cfg.vocab_size, 10)
    theirs = _reference_prompts(model.cfg.vocab_size, 10)
    assert ours != theirs
    keys = ("bridge_time_s", "crossings", "total_tokens", "mean_ttft_s")
    a = E.run_cell(model, policy, cc_on)
    monkeypatch.setattr(E, "draw_prompts", lambda vocab, n: theirs)
    b = E.run_cell(model, policy, cc_on)
    assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
