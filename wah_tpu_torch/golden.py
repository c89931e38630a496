"""Golden (NumPy) model of the WAH codec — the bit-exactness oracle.

A copy of wah_tpu.golden that imports no JAX, so the torch port can check
itself where JAX is absent; tests/test_torch_ops.py holds the two equal.

Implements exactly the semantics of the reference GPU kernel
(reference: kernels.cu:51-262 encode, kernels.cu:291-385 decode), which are:

  encode(ints):
    1. Zero-pad the input to a multiple of 31 uint32 words; the padded
       length n31 yields exactly 32*n31/31 31-bit chunks (LSB-first
       repartition, reference: kernels.cu:79).
    2. Within each block of 1024 chunks (last block may be partial),
       perform *complete* run-length coalescing: maximal runs of all-zero
       chunks -> one zero-fill word, maximal runs of all-one chunks ->
       one one-fill word, every literal chunk -> one literal word.
       Runs never cross the 1024-chunk block boundary.
    3. The stream is the concatenation of the blocks' words.

  decode(words):
    counts = fill ? len : 1; chunks = repeat of payload/filler;
    output size = ceil(31 * total_chunks / 32) uint32 words
    (reference: decompress.cu:82-92).

NOTE on reference test vectors: the expected outputs committed at
tests.cpp:66-77 (blockMergeWanderingLiterals / multiBlockTest) are stale —
a faithful lockstep simulation of compressData (see tests/ref_sim.py)
produces the complete-RLE stream on that input, not the committed 93-word
stream. All other pinned vectors (tests.cpp:146,162,169,183,197,209) agree
with complete-RLE semantics and are reproduced bit-exactly by this model.
"""
from __future__ import annotations

import numpy as np

from .constants import (
    BIT31,
    BIT3130,
    BLOCK_CHUNKS,
    LEN_MASK,
    ONES31,
    WARP_INTS,
    WORD_LITERAL,
    WORD_ONES,
    WORD_ZEROS,
)

__all__ = [
    "repartition_chunks",
    "merge_chunks",
    "encode",
    "decode",
    "chunk_count",
]


def chunk_count(n_ints: int) -> int:
    """Number of 31-bit chunks produced for n_ints input words.

    The input is zero-padded to a multiple of 31 uint32; every 31 input
    words become exactly 32 chunks (reference warp geometry,
    kernels.cu:67-79).
    """
    n31 = -(-n_ints // WARP_INTS) * WARP_INTS
    return n31 * 32 // 31


def repartition_chunks(ints: np.ndarray) -> np.ndarray:
    """32-bit LSB-first bitmap words -> 31-bit chunks (reference: kernels.cu:79).

    chunk[c] = bits [31c, 31c+31) of the logical bit stream, LSB-first.
    """
    ints = np.ascontiguousarray(ints, dtype=np.uint32)
    n = ints.shape[0]
    n31 = -(-n // WARP_INTS) * WARP_INTS
    padded = np.zeros(n31, dtype=np.uint32)
    padded[:n] = ints
    w = padded.reshape(-1, WARP_INTS)
    zcol = np.zeros((w.shape[0], 1), dtype=np.uint32)
    a = np.concatenate([w, zcol], axis=1)  # int[x]   (a[31] = 0)
    b = np.concatenate([zcol, w], axis=1)  # int[x-1] (b[0]  = 0)
    x = np.arange(32, dtype=np.uint32)
    # ((b >> (31-x)) >> 1) avoids the undefined shift-by-32 the reference
    # silently relies on PTX to clamp (kernels.cu:79, lane 0).
    chunks = (((b >> (31 - x)) >> np.uint32(1)) | (a << x)) & np.uint32(ONES31)
    return chunks.reshape(-1)


def merge_chunks(chunks: np.ndarray, out_ints: int | None = None) -> np.ndarray:
    """31-bit chunks -> 32-bit bitmap words (reference: kernels.cu:369-385).

    int[i] covers logical bits [32i, 32i+32). Default output length is
    ceil(31 * n_chunks / 32) (reference: decompress.cu:84-92).
    """
    chunks = np.ascontiguousarray(chunks, dtype=np.uint32)
    m = chunks.shape[0]
    if out_ints is None:
        out_ints = (31 * m + 31) // 32
    m32 = -(-m // 32) * 32
    padded = np.zeros(m32 + 1, dtype=np.uint32)
    padded[:m] = chunks
    c = padded[:m32].reshape(-1, 32)
    # within each warp of 32 chunks: int[x] = (c[x] >> x) | (c[x+1] << (31-x))
    nxt = np.concatenate([c[:, 1:], padded[32::32].reshape(-1, 1)], axis=1)
    x = np.arange(31, dtype=np.uint32)
    ints = (c[:, :31] >> x) | (nxt[:, :31] << (np.uint32(31) - x))
    return ints.reshape(-1)[:out_ints].astype(np.uint32)


def _classify(chunks: np.ndarray) -> np.ndarray:
    t = np.full(chunks.shape, WORD_LITERAL, dtype=np.int32)
    t[chunks == 0] = WORD_ZEROS
    t[chunks == ONES31] = WORD_ONES
    return t


def encode(ints: np.ndarray) -> np.ndarray:
    """Compress a bitmap (uint32 array) into a WAH word stream (uint32 array)."""
    chunks = repartition_chunks(ints)
    nc = chunks.shape[0]
    if nc == 0:
        return np.zeros(0, dtype=np.uint32)
    t = _classify(chunks)
    pos = np.arange(nc, dtype=np.int64)
    prev_t = np.empty_like(t)
    prev_t[0] = -1
    prev_t[1:] = t[:-1]
    # run starts: block boundary, type change, or literal (literals are
    # always their own word; reference: kernels.cu:126-141)
    start = (pos % BLOCK_CHUNKS == 0) | (t != prev_t) | (t == WORD_LITERAL)
    sidx = np.flatnonzero(start)
    lengths = np.diff(np.append(sidx, nc))
    st = t[sidx]
    words = np.empty(sidx.shape[0], dtype=np.uint32)
    lit = st == WORD_LITERAL
    words[lit] = chunks[sidx[lit]]
    zf = st == WORD_ZEROS
    words[zf] = np.uint32(BIT31) | lengths[zf].astype(np.uint32)
    of = st == WORD_ONES
    words[of] = np.uint32(BIT3130) | lengths[of].astype(np.uint32)
    return words


def decode(words: np.ndarray, out_ints: int | None = None) -> np.ndarray:
    """Decompress a WAH word stream back into a bitmap (uint32 array)."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    is_fill = (words & np.uint32(BIT31)) != 0
    counts = np.where(is_fill, words & np.uint32(LEN_MASK), 1).astype(np.int64)
    is_ones = (words & np.uint32(BIT3130)) == np.uint32(BIT3130)
    payload = np.where(
        is_fill, np.where(is_ones, np.uint32(ONES31), np.uint32(0)), words
    ).astype(np.uint32)
    chunks = np.repeat(payload, counts)
    return merge_chunks(chunks, out_ints=out_ints)
