"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000 — GQA, squared-ReLU [arXiv:2402.16819].

The largest assigned cell: FSDP + sequence-sharded activations are required
for the train_4k shape to approach fitting (see EXPERIMENTS.md §Dry-run for
the measured per-device bytes).

``fsdp``, ``seq_shard_activations`` and ``remat_policy`` are sharding and
training hints for a device mesh (ROADMAP.md, Queue 1 item 6).  On one card
they are carried as data and ignored.  At full width the weights (682 GB in
bf16) fit no card, and its head_dim of 192 is one neither attention kernel
is built for; the model runs at smoke width on the CPU, and the config
prices full width.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    mlp_kind="squared_relu",
    rope=True,
    fsdp=True,
    seq_shard_activations=True,
    remat_policy="nothing",
))
