"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternViT + InternLM2 backbone [arXiv:2404.16821].

The InternViT frontend is a STUB per the assignment: ``input_specs()``
supplies precomputed patch embeddings (batch, patches, d_model) that the
backbone consumes alongside token embeddings.

``Model`` runs it, the stub patch embeddings before the tokens
(``Model.prefill(tokens, max_len, patch_embeds=...)``); 141 GB of weights
at full depth fit no single card.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    rope_theta=5e5,
    frontend="vision",
    frontend_tokens=256,        # patch embeddings per image
    fsdp=True,
    seq_shard_activations=True,
))
