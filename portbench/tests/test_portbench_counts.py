import itertools
import math

import pytest

pytest.importorskip("torch")

from portbench import spec, weights  # noqa: E402
from portbench.counts import attention, model  # noqa: E402


def _flash_by_hand(p, h, d):
    """Operations of causal attention, pair by pair: q.k and p.v each
    d multiplies and d adds."""
    pairs = sum(1 for i, j in itertools.product(range(p), repeat=2) if j <= i)
    return h * pairs * 2 * (2 * d)


@pytest.mark.parametrize("p,h,d", [(1, 1, 2), (3, 2, 4), (17, 3, 8)])
def test_flash_operations(p, h, d):
    assert attention.flash_flops(p, h, d) == _flash_by_hand(p, h, d)


def test_flash_bytes_count_each_input_once():
    # q and out (P, H, D), k and v (P, KV, D), bf16
    assert attention.flash_bytes(5, 4, 2, 8) == 2 * (2 * 5 * 4 * 8
                                                    + 2 * 5 * 2 * 8)


def test_paged_counts_stepping_rows_only():
    lengths, h, kv, d, page = [3, 16, 17], 4, 2, 8, 16
    assert attention.paged_flops(lengths, h, d) == sum(
        h * n * 2 * (2 * d) for n in lengths)
    kv_bytes = sum(2 * n * kv * d * 2 for n in lengths)
    qo_bytes = len(lengths) * 2 * h * d * 2
    table = sum(4 * (1 + math.ceil(n / page)) for n in lengths)
    assert attention.paged_bytes(lengths, h, kv, d, page) == \
        kv_bytes + qo_bytes + table
    # a pad row copies a stepping row: it is not counted again
    assert attention.paged_bytes(lengths, h, kv, d, page) < \
        attention.paged_bytes(lengths + [3], h, kv, d, page)


def _matrix_params(tree):
    """Parameters of the layers' matrices: every leaf of rank >= 2 under
    the blocks (norm scales and biases are rank 1 per layer)."""
    n = 0
    for key, val in tree.items():
        if isinstance(val, dict):
            n += _matrix_params(val)
        else:
            shape, _, _ = val
            if key not in ("scale", "bias"):
                n += math.prod(shape)
    return n


@pytest.mark.parametrize("name", ["nemotron-4-340b-l4", "deepseek-moe-16b"])
def test_model_operations_against_the_weights(name):
    dm = weights.dims(spec.config(spec.load_benchmark(), name))
    tree = weights.layout(dm)
    blocks = _matrix_params(tree["blocks"]) + (
        _matrix_params(tree["block0"]) if "block0" in tree else 0)
    if dm["family"] == "moe":
        # a token passes through its top-k routed experts, not all of them
        per_expert = 3 * dm["d"] * dm["d_expert"]
        n_moe = dm["layers"] - dm["dense_layers"]
        blocks -= n_moe * (dm["experts"] - dm["top_k"]) * per_expert
    assert model.per_token(dm) == 2 * blocks
    assert model.head(dm) == 2 * dm["d"] * dm["vocab"]
    p = 100
    assert model.prefill_flops(dm, p) == pytest.approx(
        p * 2 * blocks + model.head(dm)
        + dm["layers"] * _flash_by_hand(p, dm["heads"], dm["head_dim"]))
    assert model.decode_flops(dm, [10, 20]) == pytest.approx(
        2 * (2 * blocks + model.head(dm))
        + dm["layers"] * attention.paged_flops([10, 20], dm["heads"],
                                               dm["head_dim"]))


def test_bound_takes_the_larger_term():
    from portbench.counts import PEAKS, bound_s
    assert bound_s(PEAKS["bf16_flops"], 0) == pytest.approx(1.0)
    assert bound_s(0, PEAKS["hbm_bytes_per_s"] * 2) == pytest.approx(2.0)
