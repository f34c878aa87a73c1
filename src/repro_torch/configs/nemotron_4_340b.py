"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000 — GQA, squared-ReLU [arXiv:2402.16819].

The largest assigned cell: FSDP + sequence-sharded activations are required
for the train_4k shape to approach fitting (see EXPERIMENTS.md §Dry-run for
the measured per-device bytes).

``fsdp`` and ``seq_shard_activations`` are sharding hints for a device
mesh: ``models/shardings.py`` reads them in the dry run
(``launch/dryrun.py``: FSDP gather-on-use, Megatron-style sequence
sharding of the activations); ``remat_policy`` is the training step's.
On one card no resolver is installed and they change nothing.  At full
width the weights (682 GB in bf16) fit no card; cut to 4 of its 96
layers (every width kept, 46.51 GB) it serves on one H100, head_dim 192
on the flash kernel and on the paged kernel's D = 192 instantiation
(``chip_smoke.py``).
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
