"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff=1408 vocab=102400,
MoE 64e top-6 — MLA kv_lora=512, shared+routed fine-grained MoE
[arXiv:2405.04434].

Assignment-line discrepancy (recorded in DESIGN.md §4): the inline spec says
"MoE 64e top-6" while the prose says "2 shared+160 routed"; the published
V2-Lite has 64 routed experts — we follow the bracketed spec (64 routed).

``Model`` runs it: MLA (absorbed decode over the latent cache) on MoE
blocks (``models.layers``).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,              # unused under MLA (latent cache)
    d_ff=1408,
    vocab_size=102400,
    n_routed_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    d_expert=1408,
    first_layer_dense=True,
    use_mla=True,
    kv_lora_rank=512,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
))
