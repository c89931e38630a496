"""Bitmap index over compressed WAH columns — port of wah_tpu.index, the
workload the WAH format exists for.

One column per distinct value of a low-cardinality attribute: bit r of
column v is set iff row r has value v. Columns are built in one batched
encode (WahCodec.compress_batch) and stored compressed, as numpy arrays
on the host; equality, membership and range queries combine them with
the compressed-domain logical ops on the codec's device.

    idx = BitmapIndex.build(values, cardinality=8)  # WahCodec() on the card
    hit_stream = idx.query_eq(3)              # compressed row bitmap
    rows = idx.rows(hit_stream)               # row ids (np.ndarray)
    s = idx.query_range(2, 5)                 # 2 <= v <= 5
    s = idx.query_in([1, 4, 7])               # membership

The codec defaults to WahCodec(), on the card, as wah_tpu's defaults to
its accelerator; without a CUDA device that default raises, and
codec=WahCodec("cpu") runs the plain versions.
"""
from __future__ import annotations

import numpy as np

from .api import WahCodec
from .convert import tensor_to_words, words_to_tensor
from .ops.logical import complement_stream

__all__ = ["BitmapIndex"]


def _bitmap_from_mask(mask: np.ndarray) -> np.ndarray:
    """(32k,) bool row mask -> (k,) uint32 bitmap, bit r of the result = row r.
    The same bitmap as wah_tpu.index's, packed in one flat pass (its
    per-byte-row packbits took 0.23 s a column at 60 M rows)."""
    return np.packbits(mask, bitorder="little").view(np.uint32)


class BitmapIndex:
    """Equality-encoded bitmap index with WAH-compressed columns."""

    def __init__(self, streams: list[np.ndarray], n_rows: int, codec: WahCodec | None = None):
        self.streams = streams
        self.n_rows = n_rows
        self.n_ints = -(-n_rows // 32)
        self.codec = codec or WahCodec()
        self._universe_stream = None

    @classmethod
    def build(
        cls, values: np.ndarray, cardinality: int | None = None, codec: WahCodec | None = None
    ) -> "BitmapIndex":
        """values: (n_rows,) small non-negative ints -> one compressed
        column per value in [0, cardinality) (default: max + 1)."""
        values = np.asarray(values)
        if values.ndim != 1 or values.size == 0:
            raise ValueError(f"values: expected a non-empty 1-D array, got {values.shape}")
        codec = codec or WahCodec()  # before the masks: no card, no work
        C = int(cardinality if cardinality is not None else int(values.max()) + 1)
        n_rows = values.shape[0]
        vpad = np.full(-(-n_rows // 32) * 32, -1, dtype=np.int64)
        vpad[:n_rows] = values
        columns = np.stack([_bitmap_from_mask(vpad == v) for v in range(C)])
        words, totals = codec.compress_batch(columns)
        return cls([words[c, : totals[c]].copy() for c in range(C)], n_rows, codec)

    @property
    def cardinality(self) -> int:
        return len(self.streams)

    def column(self, v: int) -> np.ndarray:
        return self.streams[v]

    def query_eq(self, v: int) -> np.ndarray:
        """Compressed bitmap of rows where value == v."""
        return self.streams[v]

    def query_in(self, vs) -> np.ndarray:
        """Compressed bitmap of rows where value in vs (one k-way OR in the
        compressed domain)."""
        vs = list(vs)
        if not vs:
            raise ValueError("empty membership set")
        if len(vs) == 1:
            return self.streams[vs[0]]
        return self.codec.logical_many([self.streams[v] for v in vs], "or", self.n_ints)

    def query_range(self, lo: int, hi: int) -> np.ndarray:
        """Compressed bitmap of rows where lo <= value <= hi."""
        return self.query_in(range(lo, hi + 1))

    def _universe(self) -> np.ndarray:
        """Compressed all-rows bitmap (bits [0, n_rows) set), cached: the
        tail mask that keeps complement results zero-padded."""
        if self._universe_stream is None:
            bits = np.zeros(self.n_ints * 32, np.uint8)
            bits[: self.n_rows] = 1
            bitmap = np.packbits(bits, bitorder="little").view(np.uint32)
            self._universe_stream, _ = self.codec.compress(bitmap)
        return self._universe_stream

    def query_not(self, v: int) -> np.ndarray:
        """Rows where value != v: one compressed-domain complement (a
        rewrite of the stream's words, on the codec's device) ANDed with
        the row universe to clear padding bits."""
        s = self.streams[v]
        comp = tensor_to_words(complement_stream(words_to_tensor(s, self.codec.device), len(s)))
        return self.codec.logical(comp, self._universe(), "and", self.n_ints)

    def rows(self, stream: np.ndarray) -> np.ndarray:
        """Materialize a compressed row bitmap into row ids."""
        bitmap, _ = self.codec.decompress(stream, out_ints=self.n_ints)
        bits = np.unpackbits(bitmap.view(np.uint8), bitorder="little")[: self.n_rows]
        return np.flatnonzero(bits)

    def count(self, stream: np.ndarray) -> int:
        """Cardinality of a compressed row bitmap, in the compressed domain:
        literal payload popcounts + 31 per one-fill chunk, no decompression.
        Exact because every index stream keeps its padding bits zero."""
        w = np.ascontiguousarray(stream, dtype=np.uint32)
        is_fill = (w & np.uint32(0x80000000)) != 0
        is_ones = (w & np.uint32(0xC0000000)) == np.uint32(0xC0000000)
        lens = (w & np.uint32(0x3FFFFFFF)).astype(np.int64)
        lits = w[~is_fill]
        if hasattr(np, "bitwise_count"):
            lit_pop = int(np.bitwise_count(lits).sum())
        else:  # numpy < 2
            lit_pop = int(np.unpackbits(lits.view(np.uint8), bitorder="little").sum())
        return lit_pop + 31 * int(lens[is_ones].sum())

    # -- size accounting ---------------------------------------------------
    def compressed_bytes(self) -> int:
        return sum(s.nbytes for s in self.streams)

    def uncompressed_bytes(self) -> int:
        return self.cardinality * self.n_ints * 4
