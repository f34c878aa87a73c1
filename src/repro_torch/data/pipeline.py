"""Data pipeline: deterministic synthetic token streams with packing,
sharded per data-parallel rank, plus the frontend-embedding stubs the
multimodal archs consume.

Offline container => synthetic corpus (a mixture of Zipfian token draws and
repeated n-gram "documents" so the LM has learnable structure); the pipeline
shape/packing/sharding logic is the production part.

A copy of ``repro.data.pipeline`` (numpy only, no framework), so the port
draws the reference's batches array for array without importing it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    #: fraction of each sequence drawn from repeated n-grams (learnable signal)
    structure_frac: float = 0.5
    pad_id: int = 0


class SyntheticCorpus:
    """Deterministic, seekable synthetic corpus (restart == same stream)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # a small bank of n-grams that recur -> predictable structure
        self._ngrams = rng.integers(
            1, cfg.vocab_size, size=(256, 8), dtype=np.int32)
        zipf_w = 1.0 / np.arange(1, cfg.vocab_size + 1) ** 1.1
        self._zipf = zipf_w / zipf_w.sum()

    def sequence(self, index: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, index))
        out = np.empty(cfg.seq_len + 1, np.int32)
        i = 0
        while i < len(out):
            if rng.random() < cfg.structure_frac:
                gram = self._ngrams[rng.integers(len(self._ngrams))]
                n = min(len(gram), len(out) - i)
                out[i:i + n] = gram[:n]
                i += n
            else:
                n = min(int(rng.integers(4, 16)), len(out) - i)
                out[i:i + n] = rng.choice(cfg.vocab_size, size=n, p=self._zipf)
                i += n
        return out


def batches(cfg: DataConfig, *, dp_rank: int = 0, dp_size: int = 1,
            start_step: int = 0, model_cfg=None) -> Iterator[dict]:
    """Yield training batches, sharded by data-parallel rank.

    Deterministic in (seed, step, rank): a restarted job resumes the exact
    stream (fault-tolerance requirement — no data skew after recovery).
    """
    corpus = SyntheticCorpus(cfg)
    per_rank = cfg.global_batch // dp_size
    step = start_step
    while True:
        seqs = np.stack([
            corpus.sequence(step * cfg.global_batch + dp_rank * per_rank + i)
            for i in range(per_rank)])
        batch = {
            "tokens": seqs[:, :-1],
            "targets": seqs[:, 1:],
            "loss_mask": np.ones((per_rank, cfg.seq_len), np.float32),
        }
        if model_cfg is not None and getattr(model_cfg, "frontend", ""):
            rng = np.random.default_rng((cfg.seed, step, dp_rank, 7))
            emb = rng.standard_normal(
                (per_rank, model_cfg.frontend_tokens, model_cfg.d_model)).astype(np.float32) * 0.02
            if model_cfg.family == "vlm":
                batch["patch_embeds"] = emb
            else:
                batch["frames"] = emb
        yield batch
        step += 1
