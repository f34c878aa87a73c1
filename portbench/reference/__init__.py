"""Plain float32 references, one module per family (``dense``, ``moe``).
Each gives ``hidden(weights, spec, seqs, lowp)`` and shares ``logits``;
none imports anything of ``repro_torch``."""
