"""Paged-attention (decode) kernel: CUDA source, wrapper, plain version."""
