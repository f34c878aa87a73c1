"""Model configurations the port runs (dense decoders)."""
