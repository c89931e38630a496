"""Batched columns (the bitmap-index build path): the port against wah_tpu.

The same numpy columns go through wah_tpu's batched Pallas pipelines, run
in interpret mode on the CPU as tests/test_batch.py runs them, and through
wah_tpu_torch's plain twins; through wah_tpu's plain batched ops and the
port's; and through wah_tpu.WahCodec(kernel="xla") and
wah_tpu_torch.WahCodec("cpu"). Tolerance is zero: totals, each column's
stream prefix and the decoded bitmaps agree bit for bit. The port pads
columns to its own power-of-two capacity, so its output width may differ
from wah_tpu's; only prefixes and decoded bitmaps are compared.
"""
from functools import partial

import jax
import numpy as np
import pytest
import torch

import wah_tpu
import wah_tpu_torch
from conftest import clustered_bitmap, random_bitmap
from wah_tpu import golden
from wah_tpu.constants import BLOCK_CHUNKS, BLOCK_INTS
from wah_tpu.ops import decode as jdec
from wah_tpu.ops import encode as jenc
from wah_tpu.ops.pallas import decode_kernel as jdk
from wah_tpu.ops.pallas import encode_kernel as jek
from wah_tpu_torch.convert import tensor_to_words, words_to_tensor
from wah_tpu_torch.ops import decode as tdec
from wah_tpu_torch.ops import encode as tenc
from wah_tpu_torch.ops.cuda import decode_kernel as dk
from wah_tpu_torch.ops.cuda import encode_kernel as ek

NB = 8  # blocks per column: a power of two and the CPU TILE_BLOCKS of wah_tpu


def _uniform_words(n: int, seed: int) -> np.ndarray:
    """No zero or all-one words: a column whose stream fills its capacity."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def _full_capacity_columns() -> np.ndarray:
    """tests/test_batch.py:80-89: capacity-filling, all-zero and all-one
    columns among sparse and dense ones, block-aligned."""
    n = NB * BLOCK_INTS
    return np.stack([
        random_bitmap(n, 1 / 64, seed=11),
        _uniform_words(n, 42),
        np.zeros(n, np.uint32),
        random_bitmap(n, 0.5, seed=12),
        np.full(n, 0xFFFFFFFF, np.uint32),
    ])


def _tail_columns() -> np.ndarray:
    """tests/test_batch.py:107-112: the last valid block is partial."""
    n = (NB - 2) * BLOCK_INTS + 123
    return np.stack([random_bitmap(n, d, seed=20 + i)
                     for i, d in enumerate([1 / 512, 0.3, 0.0, 1.0, 1 / 16])])


COLUMN_SETS = {"full_capacity": _full_capacity_columns, "tail": _tail_columns}


@pytest.mark.parametrize("group_rows", [2 * NB, 1 << 19], ids=["groups", "one_group"])
@pytest.mark.parametrize("cols_name", COLUMN_SETS)
def test_encode_rows_batch_plain_matches_pallas(cols_name, group_rows):
    cols = COLUMN_SETS[cols_name]()
    C, n = cols.shape
    padded = np.zeros((C, NB * BLOCK_INTS), np.uint32)
    padded[:, :n] = cols
    nv = golden.chunk_count(n)
    rows = padded.reshape(C * NB, BLOCK_INTS)
    jwords, jtotals = jax.jit(
        partial(jek.encode_rows_batch, C=C, group_rows=group_rows)
    )(rows, n_valid_chunks=np.int32(nv))
    jwords, jtotals = np.asarray(jwords).reshape(C, -1), np.asarray(jtotals)
    trows = words_to_tensor(rows.reshape(-1), "cpu").view(C * NB, BLOCK_INTS)
    before = ek.encode_tiles.launches
    for fn in (ek.encode_rows_batch_plain, ek.encode_rows_batch):
        words, totals = fn(trows, C, nv, group_rows=group_rows)
        assert words.shape == (C * NB * BLOCK_CHUNKS,)
        np.testing.assert_array_equal(totals.numpy(), jtotals)
        words = tensor_to_words(words).reshape(C, -1)
        for c in range(C):
            np.testing.assert_array_equal(words[c, : jtotals[c]], jwords[c, : jtotals[c]])
            np.testing.assert_array_equal(words[c, : jtotals[c]], golden.encode(cols[c]))
    assert ek.encode_tiles.launches == before
    if cols_name == "full_capacity":
        assert jtotals[1] == NB * BLOCK_CHUNKS
    # the (C, nb*992) columns form is a view of the same rows
    cw, ct = ek.encode_padded_batch(trows.view(C, -1), nv, group_rows=group_rows)
    assert torch.equal(ct, totals)
    np.testing.assert_array_equal(tensor_to_words(cw).reshape(C, -1)[0, : jtotals[0]],
                                  jwords[0, : jtotals[0]])


def test_decode_rows_batch_plain_matches_pallas():
    """tests/test_batch.py:131-167's columns behind tails of random words
    (fill words among them), as an unspecified stitch tail leaves them."""
    n = (NB - 1) * BLOCK_INTS + 200
    cols = np.stack([
        np.zeros(n, np.uint32),
        _uniform_words(n, 77),
        random_bitmap(n, 0.5, seed=31),
        random_bitmap(n, 1 / 512, seed=32),
        np.full(n, 0xFFFFFFFF, np.uint32),
        clustered_bitmap(n, seed=33),
    ])
    streams = [golden.encode(c) for c in cols]
    ms = np.array([len(s) for s in streams], np.int32)
    Mcap = -(-int(ms.max()) // BLOCK_CHUNKS) * BLOCK_CHUNKS + BLOCK_CHUNKS
    rng = np.random.default_rng(5)
    w2 = rng.integers(0, 2**32, size=(len(streams), Mcap), dtype=np.uint64).astype(np.uint32)
    for i, s in enumerate(streams):
        w2[i, : len(s)] = s
    cap = NB * BLOCK_CHUNKS
    C = len(streams)
    jflat = np.asarray(jax.jit(partial(jdk.decode_rows_batch, C=C, col_chunk_capacity=cap))(
        w2.reshape(-1), ms=ms))
    before = dk.decode_blocks.launches
    for fn in (dk.decode_rows_batch_plain, dk.decode_rows_batch):
        flat = fn(words_to_tensor(w2.reshape(-1), "cpu"), C, torch.from_numpy(ms), cap)
        np.testing.assert_array_equal(tensor_to_words(flat), jflat)
    assert dk.decode_blocks.launches == before
    # the (C, Mcap) form is a view of the same words
    flat2 = dk.decode_batch(words_to_tensor(w2.reshape(-1), "cpu").view(C, -1),
                            torch.from_numpy(ms), cap)
    np.testing.assert_array_equal(tensor_to_words(flat2), jflat)
    out = jflat.reshape(C, -1)
    for c in range(C):
        np.testing.assert_array_equal(out[c, :n], cols[c])


@pytest.mark.parametrize("order", ["as_built", "reversed"])
def test_decode_rows_batch_full_capacity_matches_pallas(order):
    """A column that fills its capacity exactly (the tie of K4's granule
    search: the next column's first block must go to that column) beside an
    all-zero one, block-aligned, behind tails of random words."""
    cols = _full_capacity_columns()
    if order == "reversed":
        cols = cols[::-1].copy()
    C, n = cols.shape
    streams = [golden.encode(c) for c in cols]
    ms = np.array([len(s) for s in streams], np.int32)
    cap = NB * BLOCK_CHUNKS
    assert cap in ms.tolist() and NB in ms.tolist()
    Mcap = cap + BLOCK_CHUNKS
    rng = np.random.default_rng(6)
    w2 = rng.integers(0, 2**32, size=(C, Mcap), dtype=np.uint64).astype(np.uint32)
    for i, s in enumerate(streams):
        w2[i, : len(s)] = s
    jflat = np.asarray(jax.jit(partial(jdk.decode_rows_batch, C=C, col_chunk_capacity=cap))(
        w2.reshape(-1), ms=ms))
    for fn in (dk.decode_rows_batch_plain, dk.decode_rows_batch):
        flat = fn(words_to_tensor(w2.reshape(-1), "cpu"), C, torch.from_numpy(ms), cap)
        np.testing.assert_array_equal(tensor_to_words(flat), jflat)
    np.testing.assert_array_equal(jflat.reshape(C, -1), cols)


def test_decode_rows_batch_refuses_int32_overflow():
    """Only one column past the int32 positions is refused (columns that
    pass them together go in groups)."""
    words = torch.zeros(4 * BLOCK_CHUNKS, dtype=torch.int32)
    ms = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        dk.decode_rows_batch(words, 4, ms, 1 << 31)
    with pytest.MonkeyPatch.context() as mp, pytest.raises(ValueError, match="int32"):
        mp.setattr(dk, "INT32_CHUNKS", 2 * BLOCK_CHUNKS)
        dk.decode_rows_batch_plain(words, 4, ms, 4 * BLOCK_CHUNKS)
    with pytest.raises(ValueError, match="power of two"):
        dk.decode_rows_batch(words, 4, ms, 3 * BLOCK_CHUNKS)
    with pytest.raises(ValueError, match="power of two"):
        ek.encode_rows_batch(torch.zeros((3 * 2, BLOCK_INTS), dtype=torch.int32), 2, 10)


def test_plain_batch_ops_match_jax_ops():
    """ops.encode.encode_batch / ops.decode.decode_batch against wah_tpu's
    vmapped XLA ops."""
    cols = _tail_columns()
    C, n = cols.shape
    padded = np.zeros((C, NB * BLOCK_INTS), np.uint32)
    padded[:, :n] = cols
    nv = golden.chunk_count(n)
    jwords, jtotals = jax.jit(jenc.encode_batch, static_argnums=(1,))(padded, nv)
    words, totals = tenc.encode_batch(words_to_tensor(padded.reshape(-1), "cpu").view(C, -1), nv)
    np.testing.assert_array_equal(totals.numpy(), np.asarray(jtotals))
    np.testing.assert_array_equal(tensor_to_words(words), np.asarray(jwords))  # zero tails
    jints, jn = jax.jit(partial(jdec.decode_batch, chunk_capacity=NB * BLOCK_CHUNKS))(
        np.asarray(jwords), np.asarray(jtotals))
    ints, n_ints = tdec.decode_batch(words, totals, NB * BLOCK_CHUNKS)
    np.testing.assert_array_equal(n_ints.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tensor_to_words(ints), np.asarray(jints))


@pytest.fixture(scope="module")
def codecs():
    return wah_tpu.WahCodec(kernel="xla"), wah_tpu_torch.WahCodec("cpu")


def _columns(n_ints, densities, seed0=100):
    return np.stack([random_bitmap(n_ints, d, seed=seed0 + i) for i, d in enumerate(densities)])


CODEC_SETS = {
    "non_block_multiple": lambda: _columns(2 * BLOCK_INTS + 100, [1 / 64, 1 / 8, 0.5, 0.0]),
    "whole_blocks": lambda: _columns(3 * BLOCK_INTS, [1 / 32, 0.2, 1 / 1024]),
    "mixed_extremes": lambda: np.stack([
        np.zeros(BLOCK_INTS, np.uint32), np.full(BLOCK_INTS, 0xFFFFFFFF, np.uint32),
        clustered_bitmap(BLOCK_INTS, seed=9)]),
    "full_capacity": _full_capacity_columns,
}


@pytest.mark.parametrize("name", CODEC_SETS)
def test_codec_batch_matches_jax_codec(codecs, name):
    jcodec, tcodec = codecs
    data = CODEC_SETS[name]()
    jwords, jtotals = jcodec.compress_batch(data)
    words, totals = tcodec.compress_batch(data)
    assert words.dtype == np.uint32 and words.shape[0] == data.shape[0]
    np.testing.assert_array_equal(totals, jtotals)
    for c in range(data.shape[0]):
        np.testing.assert_array_equal(words[c, : totals[c]], jwords[c, : jtotals[c]])
        np.testing.assert_array_equal(words[c, : totals[c]], golden.encode(data[c]))
    out = tcodec.decompress_batch(words, totals, out_ints=data.shape[1])
    np.testing.assert_array_equal(out, data)
    # untrimmed: the capacity's ints, as wah_tpu's XLA route returns them
    np.testing.assert_array_equal(
        tcodec.decompress_batch(words, totals), jcodec.decompress_batch(jwords, jtotals))


def test_codec_decompress_batch_uneven_columns(codecs):
    """Streams of unequal logical length expand unequally: the port decodes
    each through the single-stream pipeline, wah_tpu through its XLA route."""
    jcodec, tcodec = codecs
    bitmaps = [random_bitmap(BLOCK_INTS + 5, 0.1, seed=61), np.zeros(3 * BLOCK_INTS, np.uint32),
               random_bitmap(4 * BLOCK_INTS + 77, 1 / 64, seed=62)]
    streams = [golden.encode(b) for b in bitmaps]
    words = np.zeros((3, max(map(len, streams)) + 3), np.uint32)
    for i, s in enumerate(streams):
        words[i, : len(s)] = s
    totals = np.array([len(s) for s in streams])
    out = tcodec.decompress_batch(words, totals)
    np.testing.assert_array_equal(out, jcodec.decompress_batch(words, totals))
    for i, b in enumerate(bitmaps):
        np.testing.assert_array_equal(out[i, : len(b)], b)


def test_codec_batch_empty_and_invalid(codecs):
    _, tcodec = codecs
    words, totals = tcodec.compress_batch(np.zeros((3, 0), np.uint32))
    assert words.shape == (3, 0) and totals.tolist() == [0, 0, 0]
    with pytest.raises(ValueError, match="literal-fill"):
        tcodec.decompress_batch(np.array([[0x80000001, 0]], np.uint32), np.array([2]))


# -- the batched decode goes in groups of columns whose positions fit
# the limit (INT32_CHUNKS, lowered here), as the batched encode does

GROUP_NB = 4  # blocks a column: a capacity of 4,096 chunks


def _group_columns() -> np.ndarray:
    """Five columns of mixed content, the last block partial."""
    n = GROUP_NB * BLOCK_INTS - 50
    return np.stack([
        random_bitmap(n, 1 / 64, seed=71), np.zeros(n, np.uint32), _uniform_words(n, 72)[:n],
        clustered_bitmap(n, seed=73), np.full(n, 0xFFFFFFFF, np.uint32),
    ])


def _count_groups(monkeypatch) -> list:
    calls = []
    group = dk._decode_column_group

    def counted(words_flat, C, *args):
        calls.append(C)
        return group(words_flat, C, *args)

    monkeypatch.setattr(dk, "_decode_column_group", counted)
    return calls


@pytest.mark.parametrize("columns_a_group", [1, 2, 3])
@pytest.mark.parametrize("fn", [dk.decode_rows_batch_plain, dk.decode_rows_batch],
                         ids=["plain", "wrapper"])
def test_decode_rows_batch_in_groups_matches_one_group_and_golden(monkeypatch, fn, columns_a_group):
    cols = _group_columns()
    C, n = cols.shape
    streams = [golden.encode(c) for c in cols]
    ms = np.array([len(s) for s in streams], np.int32)
    Mcap = -(-int(ms.max()) // BLOCK_CHUNKS) * BLOCK_CHUNKS
    rng = np.random.default_rng(8)  # garbage past each stream, as a stitch tail leaves
    w2 = rng.integers(0, 2**32, size=(C, Mcap), dtype=np.uint64).astype(np.uint32)
    for i, s in enumerate(streams):
        w2[i, : len(s)] = s
    cap = GROUP_NB * BLOCK_CHUNKS
    words, tms = words_to_tensor(w2.reshape(-1), "cpu"), torch.from_numpy(ms)
    one = fn(words, C, tms, cap)
    calls = _count_groups(monkeypatch)
    monkeypatch.setattr(dk, "INT32_CHUNKS", columns_a_group * cap + cap // 2)
    grouped = fn(words, C, tms, cap)
    assert calls == [columns_a_group] * (C // columns_a_group) + ([C % columns_a_group] if C % columns_a_group else [])
    assert torch.equal(grouped, one)
    out = tensor_to_words(grouped).reshape(C, -1)
    for c in range(C):
        np.testing.assert_array_equal(out[c, :n], cols[c])


@pytest.mark.parametrize("path", ["decompress_batch", "logical_many"])
def test_codec_across_a_lowered_position_limit(monkeypatch, path):
    """The API used to raise once C * cap passed the limit; with the
    limit lowered to two columns the batched decode runs in groups and
    the API returns what golden gives."""
    codec = wah_tpu_torch.WahCodec("cpu")
    cols = _group_columns()
    C, n = cols.shape
    words, totals = codec.compress_batch(cols)
    cap = GROUP_NB * BLOCK_CHUNKS
    monkeypatch.setattr(dk, "INT32_CHUNKS", 2 * cap)
    calls = _count_groups(monkeypatch)
    if path == "decompress_batch":
        np.testing.assert_array_equal(codec.decompress_batch(words, totals, out_ints=n), cols)
        assert calls == [2, 2, 1]
    else:
        streams = [words[c, : totals[c]] for c in range(C)]
        got = codec.logical_many(streams, "or", n)
        np.testing.assert_array_equal(got, golden.encode(np.bitwise_or.reduce(cols)))
        assert calls == [2, 2, 2, 2]  # 5 streams padded to 8 with identity streams
