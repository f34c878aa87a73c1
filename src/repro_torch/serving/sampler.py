"""Token sampling: greedy / temperature / top-k.

Greedy is an argmax over the model's (bf16) logits cast to f32, as in the
reference, so greedy tokens are identical to the reference's.  Temperature
sampling draws from a ``torch.Generator``; it gives other tokens than the
reference's ``jax.random`` from the same seed, so token identity with the
reference is a greedy-only contract.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0        # 0 => greedy
    top_k: int = 0                  # 0 => full distribution
    max_new_tokens: int = 32
    stop_token: int = -1            # -1 => length-only stopping


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           params: SamplingParams) -> torch.Tensor:
    """logits: (B, 1, V) or (B, V) -> (B,) int32 next tokens."""
    if logits.dim() == 3:
        logits = logits[:, -1]
    logits = logits.float()
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / params.temperature
    if params.top_k:
        cutoff = torch.topk(logits, params.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= cutoff, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
