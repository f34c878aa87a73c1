"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6 — 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066].  Layer 0 is a dense MLP per the published model.

``Model`` runs it: MoE blocks after a dense layer 0 (``models.layers``).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                  # fine-grained expert width (assigned d_ff)
    vocab_size=102400,
    n_routed_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    d_expert=1408,
    first_layer_dense=True,
))
