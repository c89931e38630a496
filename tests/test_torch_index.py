"""Bitmap index: wah_tpu_torch.index.BitmapIndex against
wah_tpu.index.BitmapIndex and numpy (mirrors tests/test_index.py).

The same values build both indexes, wah_tpu's on WahCodec(kernel="xla")
and the port's on WahCodec("cpu"). Every query stream must be equal word
for word, and rows and count equal to each other and to numpy's answer.
10,000 rows is not a multiple of 32, so the last int of every column has
padding bits.
"""
import numpy as np
import pytest
import torch

import wah_tpu
import wah_tpu_torch
from wah_tpu.index import BitmapIndex as JaxBitmapIndex
from wah_tpu_torch.index import BitmapIndex

N_ROWS = 10_000


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(42)
    values = rng.integers(0, 8, size=N_ROWS)
    values[2_000:4_500] = 3  # long constant stretches give fills
    values[6_000:6_100] = 7
    jidx = JaxBitmapIndex.build(values, cardinality=8, codec=wah_tpu.WahCodec(kernel="xla"))
    idx = BitmapIndex.build(values, cardinality=8, codec=wah_tpu_torch.WahCodec("cpu"))
    return values, jidx, idx


QUERIES = {
    "eq_0": (lambda i: i.query_eq(0), lambda v: v == 0),
    "eq_3": (lambda i: i.query_eq(3), lambda v: v == 3),
    "in_1_4_6": (lambda i: i.query_in([1, 4, 6]), lambda v: np.isin(v, [1, 4, 6])),
    "in_one": (lambda i: i.query_in([5]), lambda v: v == 5),
    "range_2_5": (lambda i: i.query_range(2, 5), lambda v: (v >= 2) & (v <= 5)),
    "range_all": (lambda i: i.query_range(0, 7), lambda v: v >= 0),
    "not_3": (lambda i: i.query_not(3), lambda v: v != 3),
    "not_7": (lambda i: i.query_not(7), lambda v: v != 7),
}


@pytest.mark.parametrize("name", QUERIES)
def test_query_matches_jax_index_and_numpy(indexes, name):
    values, jidx, idx = indexes
    query, mask = QUERIES[name]
    stream = query(idx)
    np.testing.assert_array_equal(stream, query(jidx))
    want = np.flatnonzero(mask(values))
    np.testing.assert_array_equal(idx.rows(stream), want)
    np.testing.assert_array_equal(idx.rows(stream), jidx.rows(stream))
    assert idx.count(stream) == jidx.count(stream) == len(want)


def test_columns_and_sizes_match_jax_index(indexes):
    values, jidx, idx = indexes
    assert idx.cardinality == jidx.cardinality == 8
    assert idx.n_ints == jidx.n_ints and idx.n_rows == N_ROWS
    for v in range(8):
        np.testing.assert_array_equal(idx.column(v), jidx.column(v))
    assert idx.compressed_bytes() == jidx.compressed_bytes()
    assert idx.uncompressed_bytes() == jidx.uncompressed_bytes()
    assert sum(idx.count(idx.query_eq(v)) for v in range(8)) == N_ROWS


def test_non_multiple_of_32_rows_default_cardinality():
    rng = np.random.default_rng(1)
    values = rng.integers(0, 3, size=1000 * 32 + 17)
    idx = BitmapIndex.build(values, codec=wah_tpu_torch.WahCodec("cpu"))
    jidx = JaxBitmapIndex.build(values, codec=wah_tpu.WahCodec(kernel="xla"))
    assert idx.cardinality == 3
    for v in range(3):
        np.testing.assert_array_equal(idx.query_eq(v), jidx.query_eq(v))
        np.testing.assert_array_equal(idx.rows(idx.query_eq(v)), np.flatnonzero(values == v))


def test_build_needs_a_codec_and_values(monkeypatch):
    # the default codec is WahCodec() on the card: without one it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        BitmapIndex.build(np.arange(4), 4)
    with pytest.raises(ValueError):
        BitmapIndex.build(np.zeros(0, np.int64), 1, codec=wah_tpu_torch.WahCodec("cpu"))
    idx = BitmapIndex.build(np.arange(4), 4, codec=wah_tpu_torch.WahCodec("cpu"))
    with pytest.raises(ValueError, match="empty"):
        idx.query_in([])
