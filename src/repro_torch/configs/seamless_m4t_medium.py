"""seamless-m4t-medium [audio]: 12L d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=256206 — enc-dec, multimodal [arXiv:2308.11596].

The speech frontend is a STUB per the assignment: ``input_specs()`` supplies
precomputed frame embeddings (batch, frames, d_model); the measured system is
the 12L encoder + 12L decoder transformer backbone with cross-attention.

``Model`` runs it (the encoder over the stub frames, cross attention in
every decoder block); the serving engine feeds tokens only, so it is served
model-level (``Model.prefill(tokens, max_len, frames=...)``).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,                # decoder layers
    encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    norm_kind="layernorm",
    mlp_kind="gelu",
    frontend="audio",
    frontend_tokens=512,        # precomputed speech frames per example
))
