"""The least time an operation could take on the card: its bytes over the
peak memory bandwidth or its operations over the peak integer rate,
whichever is larger.

Counts are of the operation, not of the kernels that implement it: an
encode reads the bitmap once and writes the stream once, a decode reads
the stream once and writes the bitmap once. Intermediate arrays (K1's
staging, K3's transposed words) are the implementation's, so a PR that
fuses kernels leaves the yardstick where it was.

Peaks: NVIDIA's data sheet for the H100 SXM5 80 GB at its 700 W limit.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_INT_OPS_PER_S = 67e12  # 32-bit, outside the tensor cores
# Operations a 31-bit chunk takes at the least: two shifts, an or and a
# mask to cut it from the bitmap, two compares to classify it, a compare
# with its neighbour for a run start, and the run-length or payload word
# it contributes to. Even so the count lies far below the byte bound: ~4
# bytes a chunk at 3.35 TB/s take ten times as long as 8 operations at
# 67 T op/s.
OPS_PER_CHUNK = 8
CHUNK_BITS = 31
WORD_BITS = 32


def chunks(n_ints: int) -> int:
    """31-bit chunks of a bitmap of n_ints words (padded to 31 words)."""
    return -(-n_ints // CHUNK_BITS) * WORD_BITS


def encode_bytes(n_ints: int, stream_words: int) -> int:
    """Bitmap read once, stream written once."""
    return 4 * n_ints + 4 * stream_words


def decode_bytes(stream_words: int, n_ints: int) -> int:
    """Stream read once, bitmap written once."""
    return 4 * stream_words + 4 * n_ints


def seconds(nbytes: int, ops: int) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_INT_OPS_PER_S)


def encode_seconds(n_ints: int, stream_words: int) -> float:
    return seconds(encode_bytes(n_ints, stream_words), OPS_PER_CHUNK * chunks(n_ints))


def decode_seconds(stream_words: int, n_ints: int) -> float:
    return seconds(decode_bytes(stream_words, n_ints), OPS_PER_CHUNK * chunks(n_ints))
