"""Flash-attention (prefill) kernel: CUDA source, wrapper, plain version."""
