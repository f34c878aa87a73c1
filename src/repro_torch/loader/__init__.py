"""CC-aware model loading: sharded weight files and the context-pooled
loader (paper §6.1).  PyTorch counterpart of ``repro.loader``."""

from .pooled_loader import LoaderRates, LoaderVariant, PooledLoader
from .sharded_weights import ShardedCheckpoint, save_sharded

__all__ = ["save_sharded", "ShardedCheckpoint", "PooledLoader",
           "LoaderVariant", "LoaderRates"]
