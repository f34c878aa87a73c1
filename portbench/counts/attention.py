"""The two attention kernels' work per call.

flash (prefill): one causal call over a (1, P) prompt, H query heads, KV
key/value heads of width D; every query row attends to the keys at or
before it, so QK^T and PV cover P (P + 1) / 2 pairs, two products of
2 D operations each.  Bytes: q and the output (P H D), k and v (P KV D),
bf16.

paged (decode): one call over the stepping rows, row i attending to its
n_i keys (its own new key included): 4 H D n_i operations; bytes: the
row's K and V (n_i KV D each), its query and output (H D each), bf16,
and the int32 length and block-table entries of its ceil(n_i / page)
pages.
"""

BF16 = 2
INT32 = 4


def flash_flops(p: int, h: int, d: int) -> float:
    return 4.0 * h * d * p * (p + 1) / 2


def flash_bytes(p: int, h: int, kv: int, d: int) -> float:
    return BF16 * (2 * p * h * d + 2 * p * kv * d)


def paged_flops(lengths, h: int, d: int) -> float:
    return 4.0 * h * d * sum(lengths)


def paged_bytes(lengths, h: int, kv: int, d: int, page: int) -> float:
    total = 0.0
    for n in lengths:
        total += BF16 * (2 * n * kv * d + 2 * h * d)
        total += INT32 * (1 + -(-n // page))
    return total
