"""Serve a small model with batched requests under every scheduling policy x
CC mode, reproducing the §5.4 decision table with the real engine.

    PYTHONPATH=src python -m repro_torch.examples.serve_cc_policies \\
        [--arch hymba-1.5b] [--device cpu]

This is the end-to-end serving driver for the paper's kind of system:
continuous batching, prefill+decode, bridge-costed crossings, CC-aware
policy selection.  The port's counterpart of
``examples/serve_cc_policies.py``: the same table, on the card unless
``--device cpu``.  Prompts are drawn from a ``torch.Generator`` seeded
with 1 (the reference draws from ``jax.random``); the table depends on
their lengths, not their tokens.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import ARCH_IDS, get_config, smoke_config
from repro_torch.core.policy import SchedulingPolicy as SP
from repro_torch.models.model import Model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.scheduler import Scheduler

#: each request's prompt length and new tokens
PROMPT_LEN = 6
MAX_NEW_TOKENS = 10


def draw_prompts(vocab_size: int, n_requests: int) -> list[list[int]]:
    """``n_requests`` prompts of ``PROMPT_LEN`` tokens in [1, vocab)."""
    gen = torch.Generator().manual_seed(1)
    return torch.randint(1, vocab_size, (n_requests, PROMPT_LEN),
                         generator=gen).tolist()


def run_cell(model, policy, cc_on, n_requests=10):
    eng = ServingEngine(model, max_batch=4, max_len=96, policy=policy,
                        cc_on=cc_on, seed=42, device=model.device)
    sched = Scheduler(eng)
    for i, prompt in enumerate(draw_prompts(model.cfg.vocab_size,
                                            n_requests)):
        sched.submit(Request(f"r{i}", prompt=list(prompt),
                             sampling=SamplingParams(
                                 max_new_tokens=MAX_NEW_TOKENS)))
    stats = sched.run()
    eng.close()
    return stats


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="olmo-1b")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    model = Model(smoke_config(get_config(args.arch)), seed=0,
                  device=args.device)

    print(f"{'policy':9s} {'cc':4s} {'bridge_ms':>10s} {'crossings':>10s} "
          f"{'tokens':>7s} {'ttft_ms':>8s}")
    results = {}
    for cc in (False, True):
        for policy in (SP.ASYNC_OVERLAP, SP.SYNC_DRAIN, SP.WORKER_DRAIN):
            st = run_cell(model, policy, cc)
            results[(policy, cc)] = st
            print(f"{policy.value:9s} {'on' if cc else 'off':4s} "
                  f"{st['bridge_time_s']*1e3:10.2f} {st['crossings']:10d} "
                  f"{st['total_tokens']:7d} {st['mean_ttft_s']*1e3:8.2f}")

    on_async = results[(SP.ASYNC_OVERLAP, True)]["bridge_time_s"]
    on_sync = results[(SP.SYNC_DRAIN, True)]["bridge_time_s"]
    print(f"\nCC-on: the sync flag removes "
          f"{100*(1-on_sync/on_async):.0f}% of bridge time — the engine-level "
          f"form of the paper's one-flag recovery.")
    return results


if __name__ == "__main__":
    main()
