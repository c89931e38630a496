"""The port's segment functions against wah_tpu's and the golden model.

The same numpy bitmaps go through wah_tpu.WahCodec(kernel="xla") and
wah_tpu_torch.WahCodec("cpu"): compress_segments / decompress_segments and
their _batch_ forms at small segment sizes, with a partial last segment.
Tolerance zero.
"""
import inspect

import numpy as np
import pytest

import wah_tpu
import wah_tpu_torch
from conftest import clustered_bitmap, random_bitmap
from wah_tpu import golden
from wah_tpu.constants import BLOCK_INTS
from wah_tpu_torch import api as tapi

JAX = wah_tpu.WahCodec(kernel="xla")
PORT = wah_tpu_torch.WahCodec("cpu")

SINGLE = [
    # name, bitmap, segment_ints
    ("sparse_partial_last", lambda: random_bitmap(5 * BLOCK_INTS + 345, 1 / 64, seed=1), 2 * BLOCK_INTS),
    ("dense_one_block_segments", lambda: random_bitmap(4 * BLOCK_INTS, 0.5, seed=2), BLOCK_INTS),
    ("clustered", lambda: clustered_bitmap(7 * BLOCK_INTS + 1, seed=3), 3 * BLOCK_INTS),
    ("all_zeros_max_fills", lambda: np.zeros(6 * BLOCK_INTS, np.uint32), 2 * BLOCK_INTS),
    ("all_ones", lambda: np.full(3 * BLOCK_INTS + 31, 0xFFFFFFFF, np.uint32), BLOCK_INTS),
    ("one_segment_holds_all", lambda: random_bitmap(2 * BLOCK_INTS + 5, 0.1, seed=4), 4 * BLOCK_INTS),
    ("exact_segments", lambda: random_bitmap(6 * BLOCK_INTS, 0.02, seed=5), 3 * BLOCK_INTS),
]


@pytest.mark.parametrize("name,gen,seg", SINGLE, ids=[c[0] for c in SINGLE])
def test_segments_match_jax_and_golden(name, gen, seg):
    data = gen()
    stream = PORT.compress_segments(data, segment_ints=seg)
    np.testing.assert_array_equal(stream, JAX.compress_segments(data, segment_ints=seg))
    np.testing.assert_array_equal(stream, golden.encode(data))
    out = PORT.decompress_segments(stream, len(data), segment_ints=seg)
    np.testing.assert_array_equal(out, JAX.decompress_segments(stream, len(data), segment_ints=seg))
    np.testing.assert_array_equal(out, data)


MULTI = [c for c in SINGLE if c[0] != "one_segment_holds_all"]  # those with edges to find


@pytest.mark.parametrize("piece", [1 << 24, 1000, 7])
@pytest.mark.parametrize("name,gen,seg", MULTI, ids=[c[0] for c in MULTI])
def test_segment_edges_match_jax(name, gen, seg, piece, monkeypatch):
    """The port walks the stream in pieces with a carry; wah_tpu takes one
    cumsum over the whole stream. The edges are the same at any piece size."""
    monkeypatch.setattr(tapi, "_EDGE_PIECE", piece)
    data = gen()
    stream = golden.encode(data)
    want = wah_tpu.WahCodec._segment_edges(stream, len(data), seg)
    assert wah_tpu_torch.WahCodec._segment_edges(stream, len(data), seg) == want


def _columns(n: int) -> np.ndarray:
    return np.stack([
        random_bitmap(n, 2.0**-6, seed=50),
        random_bitmap(n, 0.5, seed=51),
        np.zeros(n, np.uint32),
        clustered_bitmap(n, seed=52, a=1.3),
        np.full(n, 0xFFFFFFFF, np.uint32),
    ])


@pytest.mark.parametrize("n,seg", [
    (3 * BLOCK_INTS + 77, BLOCK_INTS),
    (4 * BLOCK_INTS, 2 * BLOCK_INTS),
    (2 * BLOCK_INTS + 9, 4 * BLOCK_INTS),
    (5 * BLOCK_INTS + 1, 2 * BLOCK_INTS),
], ids=["partial_last", "exact", "one_segment", "one_int_tail"])
def test_batch_segments_match_jax_and_golden(n, seg):
    cols = _columns(n)
    streams = PORT.compress_batch_segments(cols, segment_ints=seg)
    jstreams = JAX.compress_batch_segments(cols, segment_ints=seg)
    assert len(streams) == len(jstreams) == cols.shape[0]
    for c in range(cols.shape[0]):
        np.testing.assert_array_equal(streams[c], jstreams[c])
        np.testing.assert_array_equal(streams[c], golden.encode(cols[c]))
    out = PORT.decompress_batch_segments(streams, n, segment_ints=seg)
    np.testing.assert_array_equal(out, JAX.decompress_batch_segments(jstreams, n, segment_ints=seg))
    np.testing.assert_array_equal(out, cols)


def test_wrong_segment_ints_raises_value_error():
    data = np.zeros(6 * BLOCK_INTS, np.uint32)  # six fills of 1024 chunks
    stream = PORT.compress_segments(data, segment_ints=2 * BLOCK_INTS)
    # seven more chunks in front: no word ends at a segment edge any more,
    # and both packages say so
    shifted = np.concatenate([[np.uint32(0x80000000 | 7)], stream])
    for codec in (JAX, PORT):
        with pytest.raises(ValueError, match="does not split"):
            codec.decompress_segments(shifted, len(data), segment_ints=2 * BLOCK_INTS)
    with pytest.raises(ValueError, match="does not split"):  # a stream that ends early
        PORT.decompress_segments(stream[: len(stream) // 2], len(data), segment_ints=2 * BLOCK_INTS)
    with pytest.raises(ValueError, match="multiple of 992"):
        PORT.compress_segments(data, segment_ints=1000)
    with pytest.raises(ValueError, match="multiple of 992"):
        PORT.decompress_batch_segments([stream], len(data), segment_ints=0)


def test_defaults_and_size_cap():
    for name, want in (("compress_segments", BLOCK_INTS << 18), ("decompress_segments", BLOCK_INTS << 18),
                       ("compress_batch_segments", BLOCK_INTS << 13),
                       ("decompress_batch_segments", BLOCK_INTS << 13)):
        for cls in (wah_tpu.WahCodec, wah_tpu_torch.WahCodec):
            assert inspect.signature(getattr(cls, name)).parameters["segment_ints"].default == want
    # a segment size past the cap of one call is refused before any work
    with pytest.raises(ValueError, match="int32 position limit"):
        PORT.compress_segments(np.zeros(4, np.uint32), segment_ints=BLOCK_INTS << 22)
    assert (BLOCK_INTS << 18) <= tapi.MAX_INTS_PER_BITMAP < (BLOCK_INTS << 22)
