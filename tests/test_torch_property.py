"""Property-based tests of the port (hypothesis), the counterpart of
tests/test_property.py: for any bitmap from its `bitmaps()` strategy
(runs, sparse, constant and random words at every size up to 3 blocks +
40 ints, around every 31/32/992 edge), every entry point of
wah_tpu_torch on the CPU gives the golden stream and inverts it exactly.
Tolerance zero."""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import wah_tpu_torch
from test_property import bitmaps
from wah_tpu import golden
from wah_tpu_torch import native
from wah_tpu_torch.ops.cuda import decode_kernel as dk
from wah_tpu_torch.parallel import ShardedCodec

SETTINGS = dict(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
CODEC = wah_tpu_torch.WahCodec("cpu")


def _columns(draw_data, max_cols: int = 4) -> np.ndarray:
    """1..max_cols bitmaps drawn independently, cut or zero-padded to one
    drawn length (tests/test_property.py:120-126)."""
    C = draw_data.draw(st.integers(min_value=1, max_value=max_cols))
    n = draw_data.draw(st.integers(min_value=0, max_value=2 * 992 + 40))
    cols = np.zeros((C, n), np.uint32)
    for i in range(C):
        r = draw_data.draw(bitmaps())
        cols[i, : min(n, len(r))] = r[:n]
    return cols


@given(bitmaps())
@settings(**SETTINGS)
def test_codec_matches_golden(data):
    stream, _ = CODEC.compress(data)
    np.testing.assert_array_equal(stream, golden.encode(data))
    back, _ = CODEC.decompress(stream, out_ints=len(data))
    np.testing.assert_array_equal(back, data)


@given(st.data())
@settings(**SETTINGS)
def test_batch_in_column_groups_matches_golden(draw_data):
    """compress_batch / decompress_batch, the decode split into groups of
    one column (the position limit lowered to one column's capacity)."""
    cols = _columns(draw_data)
    words, totals = CODEC.compress_batch(cols)
    for c in range(cols.shape[0]):
        np.testing.assert_array_equal(words[c, : totals[c]], golden.encode(cols[c]))
    if cols.shape[1] == 0:
        return
    cap = 1 << max(10, (golden.chunk_count(cols.shape[1]) - 1).bit_length())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dk, "INT32_CHUNKS", cap)
        back = CODEC.decompress_batch(words, totals, out_ints=cols.shape[1])
    np.testing.assert_array_equal(back, cols)


@pytest.mark.parametrize("segment_ints", [992, 1984])
@given(data=st.data())
@settings(**SETTINGS)
def test_segments_match_golden(segment_ints, data):
    bitmap = data.draw(bitmaps())
    stream = CODEC.compress_segments(bitmap, segment_ints=segment_ints)
    np.testing.assert_array_equal(stream, golden.encode(bitmap))
    np.testing.assert_array_equal(
        CODEC.decompress_segments(stream, len(bitmap), segment_ints=segment_ints), bitmap)
    cols = _columns(data, max_cols=3)
    streams = CODEC.compress_batch_segments(cols, segment_ints=segment_ints)
    for c, s in enumerate(streams):
        np.testing.assert_array_equal(s, golden.encode(cols[c]))
    np.testing.assert_array_equal(
        CODEC.decompress_batch_segments(streams, cols.shape[1], segment_ints=segment_ints), cols)


OPS = {"and": np.bitwise_and, "or": np.bitwise_or, "xor": np.bitwise_xor,
       "andnot": lambda a, b: a & ~b}


@given(st.data())
@settings(**SETTINGS)
def test_logical_matches_golden(draw_data):
    cols = _columns(draw_data, max_cols=5)
    n = cols.shape[1]
    streams = [golden.encode(c) for c in cols]
    if len(streams) >= 2:
        op = draw_data.draw(st.sampled_from(sorted(OPS)))
        got = CODEC.logical(streams[0], streams[1], op, n)
        np.testing.assert_array_equal(got, golden.encode(OPS[op](cols[0], cols[1]).astype(np.uint32)))
    op = draw_data.draw(st.sampled_from(["and", "or", "xor"]))
    got = CODEC.logical_many(streams, op, n)
    np.testing.assert_array_equal(got, golden.encode(OPS[op].reduce(cols, axis=0).astype(np.uint32)))


@given(bitmaps())
@settings(**SETTINGS)
def test_native_matches_golden(data):
    if not native.available():
        pytest.skip("no native toolchain")
    stream = golden.encode(data)
    np.testing.assert_array_equal(native.encode(data), stream)
    np.testing.assert_array_equal(native.decode(stream, out_ints=len(data)), data)
    native.validate(stream)
    assert native.decoded_chunks(stream) == (golden.chunk_count(len(data)) if len(data) else 0)


@given(bitmaps())
@settings(**SETTINGS)
def test_sharded_codec_world_of_one_matches_golden(data):
    codec = ShardedCodec("cpu")
    stream = codec.compress(data)
    np.testing.assert_array_equal(stream, golden.encode(data))
    np.testing.assert_array_equal(codec.decompress(stream, out_ints=len(data)), data)
