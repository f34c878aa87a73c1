"""Chunked mLSTM scan kernel: CUDA source, wrapper, plain versions."""
