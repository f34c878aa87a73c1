"""Modality frontends: stubs, as in the reference.

PyTorch counterpart of ``repro.models.frontends``.  The audio (seamless)
and vision (internvl) entries specify the transformer backbone only; the
modality frontend is a stub whose output, precomputed frame or patch
embeddings, arrives as an input.  These helpers define that contract, the
shape of the embeddings each frontend would deliver, and a deterministic
synthetic generator for smoke runs, drawn from a ``torch.Generator`` on
its device.
"""

from __future__ import annotations

import torch


def frontend_embedding_shape(cfg, batch: int) -> tuple[int, int, int]:
    """(batch, tokens, d_model) of the precomputed frontend embeddings."""
    if not cfg.frontend:
        raise ValueError(f"{cfg.name} has no modality frontend")
    return (batch, cfg.frontend_tokens, cfg.d_model)


def synthetic_frontend_embeddings(generator: torch.Generator, cfg, batch: int,
                                  dtype=torch.bfloat16) -> torch.Tensor:
    """Deterministic stand-in for InternViT patch / w2v-BERT frame outputs:
    normal draws times 0.02 in f32, cast to ``dtype``, on the generator's
    device."""
    shape = frontend_embedding_shape(cfg, batch)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * 0.02).to(dtype)
