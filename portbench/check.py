"""Whether what the window served is right.

A sample of the finished requests, drawn from the seed and always holding
the one with the most served tokens, goes through the plain float32
reference (``reference/<family>.py``) once, each request's prompt with
its served tokens.  At every position whose next token was served, the
gap by which the served token's reference logit lies below the reference's
best is read: ``logit_gap`` is the widest, ``mean_gap`` the mean over all
positions.  A cell's limits file says which of them it compares.  The
control reads the same gaps for the tokens that the reference computed
in float8 puts first (``lowp``).
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from .reference import common


def sample(finished: list, seed: int, n: int) -> list:
    """``n`` of the finished requests: the one with the most served
    tokens, then others drawn from ``seed``."""
    if not finished:
        return []
    longest = max(range(len(finished)),
                  key=lambda i: len(finished[i].output_tokens))
    rest = [i for i in range(len(finished)) if i != longest]
    rng = np.random.Generator(np.random.PCG64(seed))
    picked = rng.permutation(len(rest))[:max(0, n - 1)]
    return [finished[longest]] + [finished[rest[i]] for i in sorted(picked)]


def _gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return ref.max(-1).values - ref.gather(1, tokens[:, None])[:, 0]


def gaps(weights: dict, spec: dict, seqs: list[dict], *,
         control: bool = False) -> dict:
    """The reference's widest and mean gap under the served tokens
    (``logit_gap``, ``mean_gap``), the share of served tokens that are its
    first choice and the positions read; with ``control`` the same of the
    float8 reference's first choices (``control_*``)."""
    ref_mod = importlib.import_module(f"portbench.reference.{spec['family']}")
    common.no_tf32()
    device = weights["embed"].device
    served = torch.tensor([t for s in seqs for t in s["served"]],
                          dtype=torch.int64, device=device)
    with torch.no_grad():
        h = ref_mod.hidden(weights, spec, seqs, False)
        ref = ref_mod.logits(weights, spec, h, False)
        del h
        g = _gaps(ref, served)
        out = dict(logit_gap=float(g.max()), positions=int(g.numel()),
                   first_choice=float((g == 0).float().mean()),
                   mean_gap=float(g.mean()))
        if control:
            h = ref_mod.hidden(weights, spec, seqs, True)
            low = ref_mod.logits(weights, spec, h, True)
            del h
            c = _gaps(ref, low.argmax(-1))
            out.update(control_logit_gap=float(c.max()),
                       control_first_choice=float((c == 0).float().mean()),
                       control_mean_gap=float(c.mean()))
    return out
