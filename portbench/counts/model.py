"""A whole step's operations, for ``model.mfu``: 2 per parameter a token
passes through (attention projections, the MLP, a MoE layer's router, its
top-k routed and its shared experts, never the experts it skips, and the
output head for each position whose logits are computed), plus the
attention products over the keys each position attends to.  The
embedding is a gather: no operations."""

from . import attention


def proj_flops(dm: dict) -> float:
    """A token's attention projections in one layer (q, k, v, out)."""
    d, h, kv, hd = dm["d"], dm["heads"], dm["kv"], dm["head_dim"]
    return 2.0 * (d * (h + 2 * kv) * hd + h * hd * d)


def mlp_flops(dm: dict, f: int) -> float:
    """A token's pass through an MLP of width ``f``."""
    mats = 3 if dm["mlp"] == "swiglu" else 2
    return 2.0 * mats * dm["d"] * f


def per_token(dm: dict) -> float:
    """Operations one token needs in the layers, without attention
    products and without the head (``families/<family>.py``)."""
    from portbench import families
    return families.get(dm["family"]).per_token(dm)


def head(dm: dict) -> float:
    return 2.0 * dm["d"] * dm["vocab"]


def prefill_flops(dm: dict, p: int) -> float:
    """A prefill of a ``p``-token prompt (logits at its last position)."""
    attn = dm["layers"] * attention.flash_flops(p, dm["heads"],
                                                dm["head_dim"])
    return p * per_token(dm) + attn + head(dm)


def decode_flops(dm: dict, lengths) -> float:
    """A decode step of the stepping rows, row i attending to
    ``lengths[i]`` keys."""
    attn = dm["layers"] * attention.paged_flops(lengths, dm["heads"],
                                                dm["head_dim"])
    return len(lengths) * (per_token(dm) + head(dm)) + attn
