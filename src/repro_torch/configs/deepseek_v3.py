"""deepseek-v3 [moe]: 61L d_model=7168 128H, MLA (q_lora 1536, kv_lora 512,
nope 128, rope 64, v 128) with YaRN rope (factor 40 over 4096 positions),
then MoE layers of 256 routed experts of 2048 and 1 shared, top 8, scored
by a sigmoid with ``noaux_tc`` (a per-expert correction bias picks the
experts inside the best 4 of 8 groups; the unbiased scores gate them,
renormalised and scaled by 2.5); vocab 129,280, not tied [arXiv:2412.19437;
https://huggingface.co/deepseek-ai/DeepSeek-V3/blob/main/config.json].

Registered at its published sizes with every expert held
(``experts_held`` 0).  The port carries one leading dense layer (of
18432) where the published model has three (``first_k_dense_replace``),
and no multi-token-prediction module (``num_nextn_predict_layers`` 1,
for speculative decoding, which the engine does not do).  ``head_dim`` is
the width at which MLA's prefill runs the flash kernel, nope + rope.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v3",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,             # unused under MLA (latent cache)
    head_dim=192,
    d_ff=18432,                 # the leading dense layer
    vocab_size=129280,
    n_routed_experts=256,
    n_shared_experts=1,
    moe_top_k=8,
    d_expert=2048,
    first_layer_dense=True,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    yarn=(40.0, 4096, 32.0, 1.0, 1.0, 1.0),
    router_scoring="sigmoid_noaux_tc",
    router_groups=8,
    router_topk_groups=4,
    router_scale=2.5,
))
