"""The CC-aware serving engine, its sampler, batch and overlap helpers."""
