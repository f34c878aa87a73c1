"""Training data: the synthetic, seekable token pipeline."""
