"""The port's ``RaggedBatch`` and ``ragged_block_tables`` against the
reference's.

The cases of ``tests/test_packed_decode.py::TestRaggedBatch`` and the
``RaggedBatch`` property of ``tests/test_packed_properties.py`` run on
``repro_torch.serving.kv_cache``, and on any (slot, kv_len) list the
port's size, ``total_kv_tokens``, ``offsets()`` (an ``np.int64`` CSR
cumsum) and ``slot_array()`` equal the reference's, dtypes included.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="property tests need hypothesis")
import hypothesis.strategies as st
from hypothesis import given, settings

from repro.serving.kv_cache import RaggedBatch as JRaggedBatch

from repro_torch.serving.kv_cache import RaggedBatch, ragged_block_tables

PAIRS = st.lists(st.tuples(st.integers(min_value=0, max_value=511),
                           st.integers(min_value=0, max_value=65536)),
                 min_size=0, max_size=64)


class TestRaggedBatch:
    def test_from_slots_preserves_order_and_lengths(self):
        b = RaggedBatch.from_slots([(3, 7), (0, 5), (2, 9)])
        assert b.slots == (3, 0, 2) and b.kv_lens == (7, 5, 9)
        assert b.size == 3 and b.total_kv_tokens == 21
        assert list(b.offsets()) == [0, 7, 12, 21]
        assert b.slot_array().dtype == np.int32

    def test_mismatched_lengths_rejected(self):
        with pytest.raises(ValueError, match="one kv_len per slot"):
            RaggedBatch(slots=(0, 1), kv_lens=(4,))

    def test_ragged_block_tables_csr(self):
        flat, offs = ragged_block_tables(
            {"a": [10, 11], "b": [20], "c": [30, 31, 32]}, ["a", "b", "c"])
        assert list(flat) == [10, 11, 20, 30, 31, 32]
        assert list(offs) == [0, 2, 3, 6]
        assert flat.size == 6 < 3 * 3

    def test_empty_batch(self):
        b = RaggedBatch.from_slots([])
        assert b.size == 0 and b.total_kv_tokens == 0
        assert b.offsets().tolist() == [0]


@settings(max_examples=100, deadline=None)
@given(pairs=PAIRS)
def test_ragged_batch_invariants(pairs):
    batch = RaggedBatch.from_slots(pairs)
    assert batch.size == len(pairs)
    assert batch.total_kv_tokens == sum(k for _, k in pairs)
    offs = batch.offsets()
    assert offs[0] == 0 and offs[-1] == batch.total_kv_tokens
    assert all(offs[i] <= offs[i + 1] for i in range(batch.size))
    assert list(batch.slot_array()) == [s for s, _ in pairs]


@settings(max_examples=100, deadline=None)
@given(pairs=PAIRS)
def test_ragged_batch_is_the_references(pairs):
    ours, ref = RaggedBatch.from_slots(pairs), JRaggedBatch.from_slots(pairs)
    assert (ours.slots, ours.kv_lens, ours.size) == \
        (ref.slots, ref.kv_lens, ref.size)
    assert type(ours.total_kv_tokens) is int
    assert ours.total_kv_tokens == ref.total_kv_tokens
    for got, want in ((ours.offsets(), ref.offsets()),
                      (ours.slot_array(), ref.slot_array())):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)
    assert ours.offsets().dtype == np.int64
