"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attn + mamba heads [arXiv:2411.13676].

Hybrid-head blocks: attention and SSM heads run in parallel on the same
input and their normalized outputs are averaged.  Sliding-window attention
everywhere except three global full-attention layers (first/middle/last),
so the long_500k shape runs with bounded KV + SSM state.

``Model`` runs it: Mamba-2 heads beside attention, sliding-window ring
caches (``models.ssm``, ``models.transformer``).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    hybrid=True,
    ssm_kind="mamba",
    ssm_state=16,
    ssm_expand=2,
    sliding_window=1024,
    global_layers=(0, 15, 31),
    scan_layers=False,          # heterogeneous (global vs sliding) layers
))
