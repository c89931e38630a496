"""Plain NumPy WAH codec: the benchmark's own statement of the format.

Imports nothing of the program. The stream (SURVEY.md section 0.1, after
GPU-WAH's kernels.cu:51-262) is a sequence of uint32 words:

  literal    bit 31 clear, bits 30..0 one 31-bit chunk of the bitmap
  zero fill  bits 31..30 = 10, bits 29..0 a run length N of all-zero chunks
  one fill   bits 31..30 = 11, bits 29..0 a run length N of all-one chunks

Bit i of the bitmap is bit i % 32 of uint32 word i // 32. The bitmap is
zero-padded to a multiple of 31 words; chunk k holds bits [31k, 31k + 31).
Runs of equal fill chunks coalesce completely within each block of 1024
chunks and never across a block edge; every literal chunk is its own word.
"""
from __future__ import annotations

import numpy as np

BLOCK_CHUNKS = 1024
WARP_INTS = 31
BLOCK_INTS = BLOCK_CHUNKS // 32 * WARP_INTS  # 992
PIECE_BLOCKS = 256  # 1 MB of bitmap a piece
BIT31 = 0x80000000
ONE_FILL = 0xC0000000
LEN_MASK = 0x3FFFFFFF
ONES31 = 0x7FFFFFFF


def chunks_of(ints: np.ndarray) -> np.ndarray:
    """(n,) uint32 bitmap -> its 31-bit chunks, ceil(n / 31) * 32 of them."""
    ints = np.ascontiguousarray(ints, dtype=np.uint32)
    groups = -(-ints.shape[0] // WARP_INTS)
    padded = np.zeros(groups * WARP_INTS, np.uint32)
    padded[: ints.shape[0]] = ints
    # columns: word -1 (zero), the group's 31 words, word 31 (zero)
    w = np.zeros((groups, 33), np.uint64)
    w[:, 1:32] = padded.reshape(groups, WARP_INTS)
    # chunk x of a group of 31 words holds bits [31x, 31x + 31) of it: the
    # bits of word x - 1 from bit 32 - x up, then word x's low bits
    x = np.arange(32, dtype=np.uint64)
    chunks = ((w[:, :32] >> (np.uint64(32) - x)) | (w[:, 1:] << x)) & np.uint64(ONES31)
    return chunks.astype(np.uint32).reshape(-1)


def encode(ints: np.ndarray, run_chunks: int = BLOCK_CHUNKS) -> np.ndarray:
    """(n,) uint32 bitmap -> WAH stream. Fill runs coalesce within each
    group of `run_chunks` chunks (1024, a block: the format; any other
    divisor of 1024 gives a stream that decodes to the same bitmap in other
    words). No run crosses a block's edge, so the bitmap is encoded in
    pieces of PIECE_BLOCKS whole blocks, which keeps the temporaries
    small, and the pieces' streams are joined."""
    assert BLOCK_CHUNKS % run_chunks == 0, run_chunks
    ints = np.ascontiguousarray(ints, dtype=np.uint32)
    step = PIECE_BLOCKS * BLOCK_INTS
    if ints.shape[0] <= step:
        return _encode_piece(ints, run_chunks)
    return np.concatenate([_encode_piece(ints[i:i + step], run_chunks)
                           for i in range(0, ints.shape[0], step)])


def _encode_piece(ints: np.ndarray, run_chunks: int) -> np.ndarray:
    chunks = chunks_of(ints)
    if chunks.size == 0:
        return np.zeros(0, np.uint32)
    kind = np.full(chunks.shape, 2, np.int8)  # 0 zero fill, 1 one fill, 2 literal
    kind[chunks == 0] = 0
    kind[chunks == ONES31] = 1
    start = np.empty(chunks.shape, bool)
    start[0] = True
    np.not_equal(kind[1:], kind[:-1], out=start[1:])
    start |= kind == 2
    start[::run_chunks] = True
    first = np.flatnonzero(start)
    runs = np.diff(first, append=chunks.shape[0]).astype(np.uint32)
    k = kind[first]
    return np.where(
        k == 2, chunks[first],
        np.where(k == 1, np.uint32(ONE_FILL), np.uint32(BIT31)) | runs,
    ).astype(np.uint32)


def decode(words: np.ndarray, out_ints: int | None = None) -> np.ndarray:
    """WAH stream -> bitmap of `out_ints` words (default: ceil(31 c / 32),
    c the chunk count)."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    fill = (words & np.uint32(BIT31)) != 0
    runs = np.where(fill, words & np.uint32(LEN_MASK), 1).astype(np.int64)
    payload = np.where(
        fill, np.where((words & np.uint32(ONE_FILL)) == ONE_FILL, np.uint32(ONES31), 0), words
    ).astype(np.uint32)
    chunks = np.repeat(payload, runs)
    n = chunks.shape[0]
    if out_ints is None:
        out_ints = -(-31 * n // 32)
    c = np.zeros(-(-n // 32) * 32, np.uint64)
    c[:n] = chunks
    c = c.reshape(-1, 32)
    # word x of a group of 32 chunks: chunk x from bit x up, then chunk x + 1
    x = np.arange(31, dtype=np.uint64)
    ints = ((c[:, :31] >> x) | (c[:, 1:] << (np.uint64(31) - x))) & np.uint64(0xFFFFFFFF)
    out = ints.astype(np.uint32).reshape(-1)
    if out.shape[0] < out_ints:
        out = np.pad(out, (0, out_ints - out.shape[0]))
    return out[:out_ints]


def words_differing(got: np.ndarray, want: np.ndarray) -> int:
    """Words that differ between two streams or bitmaps, each word past the
    shorter one counted as differing."""
    got = np.asarray(got).view(np.uint32).reshape(-1)
    want = np.asarray(want).view(np.uint32).reshape(-1)
    m = min(got.shape[0], want.shape[0])
    return int(np.count_nonzero(got[:m] != want[:m])) + abs(got.shape[0] - want.shape[0])
