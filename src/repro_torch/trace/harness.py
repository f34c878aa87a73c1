"""Record tapes from real engine runs (golden-tape + benchmark harness).

Kept out of ``trace/__init__`` so importing the trace package never pulls in
the serving stack; the engine imports are lazy for the same reason.  The
GOLDEN workload constants are shared by tests/golden/regen.py and the golden
regression tests so both sides record the identical run.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.policy import SchedulingPolicy

from .recorder import TraceRecorder
from .tape import BridgeTape

#: the fixed workload golden tapes are recorded from (byte-stable: fixed
#: seed, fixed prompt, max_new_tokens always reached before any stop token)
GOLDEN = dict(seed=0, n_requests=4, prompt=(1, 2, 3), max_new_tokens=6,
              max_batch=4, max_len=64)

#: checked-in tape file per engine policy (tests/golden/)
GOLDEN_TAPE_FILES = {
    SchedulingPolicy.SYNC_DRAIN: "tape_sync.json",
    SchedulingPolicy.ASYNC_OVERLAP: "tape_async.json",
    SchedulingPolicy.WORKER_DRAIN: "tape_worker.json",
}


def smoke_model(*, device=None, seed: int = 0):
    """The tiny deterministic model every golden tape is recorded with.

    Its weights come from ``seed`` through a ``torch.Generator``; a tape
    depends on shapes and policy only, never on the weights' values."""
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.models.model import Model
    return Model(smoke_config(get_config("olmo-1b")), seed=seed, device=device)


def record_policy_tape(policy: SchedulingPolicy, *, model=None,
                       cc_on: bool = True, seed: int = 0, n_requests: int = 4,
                       prompt: tuple = (1, 2, 3), max_new_tokens: int = 6,
                       max_batch: int = 4, max_len: int = 64,
                       label: str = "", device=None) -> BridgeTape:
    """Run a real ServingEngine under `policy` and return its crossing tape."""
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.sampler import SamplingParams

    if model is None:
        model = smoke_model(device=device, seed=seed)
    engine = ServingEngine(model, max_batch=max_batch, max_len=max_len,
                           policy=policy, cc_on=cc_on, seed=seed,
                           device=model.device)
    recorder = TraceRecorder(
        engine.gateway, policy=policy.value,
        label=label or f"{policy.value}-cc{'on' if cc_on else 'off'}",
        extra={"seed": seed, "n_requests": n_requests,
               "prompt": list(prompt), "max_new_tokens": max_new_tokens})
    try:
        with recorder:
            for i in range(n_requests):
                engine.submit(Request(
                    f"r{i}", prompt=list(prompt),
                    sampling=SamplingParams(max_new_tokens=max_new_tokens)))
            engine.run()
    finally:
        engine.close()
    return recorder.tape()


def record_golden_tape(policy: SchedulingPolicy, *, model=None,
                       cc_on: bool = True, device=None) -> BridgeTape:
    """Record the exact workload the checked-in golden tapes pin."""
    return record_policy_tape(policy, model=model, cc_on=cc_on,
                              device=device, **GOLDEN)
