"""The one traffic generator: a mix file's parameters and a seed -> the
requests its clients send.

Every seed sends the same set of sizes and only their order and the
tokens move with it: each block of ``mix["block"]`` requests holds the
prompt lengths at the mid-quantiles ``(i + 0.5) / n`` of the prompt
distribution, paired with the output lengths at those of the output
distribution by one permutation that no seed moves, in an order the
seed draws anew for every block.

The window opens in the loop's steady state: the request each client has
in flight then is one of the block's, in proportion to its output length
(a longer request is more often the one in flight), at a point spread
evenly over its answer, so completions, and the admissions that follow
them, come at the steady rate from the first step.  Its cache holds what
it would hold there: the prompt and the answer so far, sent as one
prompt of ``prompt + (output - remaining)`` tokens with ``remaining``
tokens still to make.  The seed draws every token, uniformly over
``[1, vocab)``.
"""

from __future__ import annotations

import math
import statistics

import numpy as np


def quantile_lengths(dist: dict, n: int) -> list[int]:
    """``n`` lengths at the mid-quantiles of ``dist``, rounded and clipped
    to ``[min, max]``: "lognormal" (``median``, ``sigma``) or "uniform"
    (``min`` equal to ``max`` gives one fixed length)."""
    lo, hi = dist["min"], dist["max"]
    if dist["dist"] == "lognormal":
        normal = statistics.NormalDist()
        mu = math.log(dist["median"])
        vals = [math.exp(mu + dist["sigma"] * normal.inv_cdf((i + 0.5) / n))
                for i in range(n)]
    elif dist["dist"] == "uniform":
        vals = [lo + (hi - lo) * (i + 0.5) / n for i in range(n)]
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return [int(min(max(round(v), lo), hi)) for v in vals]


def in_flight(block: list[tuple], n: int) -> list[tuple]:
    """``n`` requests at the mid-quantiles of a closed loop's steady state
    over ``block``'s (prompt, output) requests, as (tokens already in the
    cache, tokens still to make).  Request j is in flight in proportion to
    its output L_j and equally likely at each of its remaining counts
    1..L_j; the (j, remaining) pairs, ordered by remaining, are taken at
    ``(i + 0.5) / n``.  At least 2 remain, so each makes a decode step."""
    pairs = sorted((r, j) for j, (_, out) in enumerate(block)
                   for r in range(1, out + 1))
    picked = []
    for i in range(n):
        # the first pair whose share of all pairs reaches (i + 0.5) / n
        r, j = pairs[-(-(2 * i + 1) * len(pairs) // (2 * n)) - 1]
        prompt, out = block[j]
        r = min(max(2, r), out)
        picked.append((prompt + out - r, r))
    return picked


class Traffic:
    """The request stream of one run: ``initial()`` the requests in flight
    when the window opens, then ``next()`` for each further request."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        if mix["loop"] != "closed":
            raise ValueError(f"unknown loop {mix['loop']!r}")
        self.vocab = vocab
        self.rng = np.random.Generator(np.random.PCG64(seed))
        #: the order of the blocks: drawn from the seed, apart from tokens
        self.order = np.random.Generator(np.random.PCG64([seed, 1]))
        n = mix["block"]
        prompts = quantile_lengths(mix["prompt"], n)
        outputs = quantile_lengths(mix["output"], n)
        pair = np.random.Generator(np.random.PCG64(0)).permutation(n)
        self.block = [(prompts[i], outputs[pair[i]]) for i in range(n)]
        first = in_flight(self.block, mix["clients"])
        self.first = [first[i] for i in
                      self.order.permutation(len(first))]
        self._queue: list = []

    def _request(self, prompt_len: int, new_tokens: int) -> tuple:
        tokens = self.rng.integers(1, self.vocab, prompt_len).tolist()
        return tokens, new_tokens

    def initial(self) -> list[tuple]:
        """One (prompt tokens, new tokens) per client."""
        return [self._request(*req) for req in self.first]

    def next(self) -> tuple:
        if not self._queue:
            self._queue = [self.block[i] for i in
                           self.order.permutation(len(self.block))]
        return self._request(*self._queue.pop(0))
