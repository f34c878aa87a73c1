"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B].

``fsdp`` and ``seq_shard_activations`` are sharding hints for a device mesh,
read by ``models/shardings.py`` in the dry run (``launch/dryrun.py``).  On
one card no resolver is installed and they change nothing: the model holds
every layer whole.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    head_dim=128,
    rope_theta=1e6,
    fsdp=True,
    seq_shard_activations=True,
))
