"""Block-scale dequant kernel: CUDA source, wrapper, plain version."""
