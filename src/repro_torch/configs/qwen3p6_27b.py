"""qwen3p6-27b — the paper's own dense serving workload (§5.2 profiling
configuration: Qwen3.6-27B-FP8 on one B300).  Dense 27B-class decoder used
by the serving benchmarks and the policy-inversion reproduction."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3p6-27b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=151936,
    qk_norm=True,
    head_dim=128,
    rope_theta=1e6,
))
