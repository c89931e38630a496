"""Plain torch WAH encoder — port of wah_tpu.ops.encode (the XLA path).

The same pipeline over a (num_blocks, 1024) chunk array:

  repartition -> classify -> run-start mask -> cumsum word slot ->
  cummax covering start -> run lengths -> word values ->
  scatter to per-block slots -> count scan -> scatter into the stream.

wah_tpu routes words with log-shift compactions because a TPU cannot
scatter; here both compactions are index scatters. Semantics are the
reference kernel's exactly (golden.py): complete run-length coalescing
of fill chunks within each 1024-chunk block, never across blocks;
literals always emitted verbatim. Words are int32 bit patterns.
"""
from __future__ import annotations

import torch

from ..constants import (
    BIT31,
    BIT3130,
    BLOCK_CHUNKS,
    BLOCK_INTS,
    ONES31,
    WORD_LITERAL,
    WORD_ONES,
    WORD_ZEROS,
)
from ..convert import to_i32
from ..golden import chunk_count
from . import bits

__all__ = [
    "classify", "encode_blocks", "place_rows", "stitch", "encode_padded", "encode_batch", "encode",
]

_I64 = torch.int64


def classify(chunks: torch.Tensor) -> torch.Tensor:
    """Chunk type: WORD_ZEROS / WORD_ONES / WORD_LITERAL, int32
    (reference: kernels.cu:93-112)."""
    t = torch.where(chunks == ONES31, WORD_ONES, WORD_LITERAL)
    return torch.where(chunks == 0, WORD_ZEROS, t).to(torch.int32)


def encode_blocks(
    chunks: torch.Tensor, n_valid_chunks=None, chunk_base=0,
    pos_mask: int = 0x7FFFFFFF,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode (nb, 1024) chunks -> (staging (nb, 1024) int32, counts (nb,) int32).

    Each staging row holds that block's words as a dense prefix of
    `counts[b]` words, zero elsewhere (zero is never a valid word).
    A chunk is valid when ((chunk_base + position) & pos_mask) <
    n_valid_chunks: trailing padding emits no words. chunk_base is the
    global index of chunks[0, 0]; pos_mask is the identity 0x7FFFFFFF
    for one stream (the kernels' nv[2] carries a per-column wrap for
    batched columns).
    """
    nb, C = chunks.shape
    if C != BLOCK_CHUNKS:
        raise ValueError(f"expected (nb, {BLOCK_CHUNKS}) chunks, got {chunks.shape}")
    dev = chunks.device
    if n_valid_chunks is None:
        n_valid_chunks = nb * C
    t = classify(chunks)
    col = torch.arange(C, dtype=_I64, device=dev)
    gpos = (
        torch.as_tensor(chunk_base, dtype=_I64, device=dev)
        + torch.arange(nb, dtype=_I64, device=dev)[:, None] * C
        + col
    )
    v = (gpos & pos_mask) < torch.as_tensor(n_valid_chunks, dtype=_I64, device=dev)

    # run starts: block start, type change, or literal (literals are always
    # their own word; reference: kernels.cu:126-141)
    prev_t = torch.cat([torch.full_like(t[:, :1], -1), t[:, :-1]], dim=1)
    start = v & ((t != prev_t) | (t == WORD_LITERAL))
    widx = torch.cumsum(start, dim=1) - 1  # word slot of the covering run
    counts = start.sum(dim=1, dtype=torch.int32)

    # run ends: the next chunk starts a run, or is invalid / past the block
    falses = torch.zeros_like(v[:, :1])
    nv_next = torch.cat([v[:, 1:], falses], dim=1)
    start_next = torch.cat([start[:, 1:], ~falses], dim=1)
    end = v & (start_next | ~nv_next)

    run_start = torch.cummax(torch.where(start, col, -1), dim=1).values
    run_len = col - run_start + 1
    value = torch.where(
        t == WORD_LITERAL,
        chunks.to(_I64),
        torch.where(t == WORD_ONES, BIT3130 | run_len, BIT31 | run_len),
    )
    rows, cols = end.nonzero(as_tuple=True)
    staging = torch.zeros((nb, C), dtype=torch.int32, device=dev)
    staging[rows, widx[rows, cols]] = to_i32(value[rows, cols])
    return staging, counts


def place_rows(
    staging: torch.Tensor, offsets: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """Lay row b's first counts[b] words at offsets[b] of a zeroed
    (nb*1024,) stream (the reference moveData, kernels.cu:273-280)."""
    nb, C = staging.shape
    col = torch.arange(C, dtype=_I64, device=staging.device)
    ok = col < counts.to(_I64)[:, None]
    dest = offsets.to(_I64)[:, None] + col
    words = torch.zeros(nb * C, dtype=torch.int32, device=staging.device)
    words[dest[ok]] = staging[ok]
    return words


def stitch(
    staging: torch.Tensor, counts: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Concatenate per-block word prefixes into one dense stream
    (reference: thrust::exclusive_scan + moveData, compress.cu:133-166).
    Returns (words (nb*1024,) zero past total, total int32)."""
    incl = torch.cumsum(counts.to(_I64), dim=0)
    words = place_rows(staging, incl - counts, counts)
    return words, incl[-1].to(torch.int32)


def encode_padded(
    ints: torch.Tensor, n_valid_chunks
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compress a block-aligned (nb*992,) int32 bitmap whose first
    `n_valid_chunks` chunks are live; trailing padding emits no words.
    Returns (words (nb*1024,), total)."""
    if ints.shape[0] % BLOCK_INTS:
        raise ValueError(f"length must be a multiple of {BLOCK_INTS}, got {ints.shape}")
    nb = ints.shape[0] // BLOCK_INTS
    chunks = bits.repartition_chunks(ints).reshape(nb, BLOCK_CHUNKS)
    staging, counts = encode_blocks(chunks, n_valid_chunks)
    return stitch(staging, counts)


def encode_batch(
    ints: torch.Tensor, n_valid_chunks
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compress a batch of equal-length columns (the bitmap-index
    workload: one bitmap per indexed value). ints: (C, nb*992) int32, each
    row a block-aligned column with the same n_valid_chunks. Returns
    (words (C, nb*1024) zero past each total, totals (C,) int32); the
    columns are independent, one encode_padded each."""
    if ints.shape[0] == 0:
        raise ValueError("encode_batch: need at least one column")
    words, totals = zip(*(encode_padded(col, n_valid_chunks) for col in ints))
    return torch.stack(words), torch.stack(totals)


def encode(ints: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Compress a (n,) int32 bitmap -> (words (capacity,), total int32).

    capacity = ceil(chunk_count(n) / 1024) * 1024; the stream is
    words[:total] (reference host driver compress(), compress.cu:41-209):
    pad to whole blocks, then encode_padded.
    """
    n = ints.shape[0]
    nv = chunk_count(n)
    nb = -(-nv // BLOCK_CHUNKS)
    padded = torch.zeros(nb * BLOCK_INTS, dtype=torch.int32, device=ints.device)
    padded[:n] = ints
    return encode_padded(padded, nv)
