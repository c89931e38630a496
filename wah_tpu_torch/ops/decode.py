"""Plain torch WAH decoder — port of wah_tpu.ops.decode (the XLA path).

wah_tpu expands words with a monotone log-shift routing and a cummax
forward fill, because a TPU cannot gather. Here each chunk position looks
up its covering word directly: a searchsorted over the exclusive word
offsets (the reference getCounts + scan, kernels.cu:291-309,
decompress.cu:66-93), then the word's payload or filler, then the
31->32-bit merge (reference mergeWords, kernels.cu:369-385).
"""
from __future__ import annotations

import torch

from ..constants import BIT31, BIT3130, LEN_MASK, ONES31
from . import bits

__all__ = ["word_counts", "expand_at", "decode_span", "decode_chunks", "decode", "decode_batch"]

_I64 = torch.int64


def word_counts(words: torch.Tensor, m) -> torch.Tensor:
    """Expanded chunk count per word, int32: fill -> run length,
    literal -> 1 (reference getCounts, kernels.cu:291-309); words at or
    beyond index m count 0."""
    w = words.to(_I64) & 0xFFFFFFFF
    i = torch.arange(w.shape[0], dtype=_I64, device=w.device)
    c = torch.where((w & BIT31) != 0, w & LEN_MASK, 1)
    return torch.where(i < m, c, 0).to(torch.int32)


def expand_at(
    words: torch.Tensor, offsets: torch.Tensor, pos: torch.Tensor
) -> torch.Tensor:
    """Chunk value (int32) at each chunk position `pos`, given each word's
    first chunk position `offsets` (non-decreasing): the payload of the
    last word starting at or before the position, or its filler. Only
    positions below the stream's chunk count are meaningful."""
    idx = torch.searchsorted(offsets, pos, right=True) - 1
    w = words[idx.clamp(0, words.shape[0] - 1)].to(_I64) & 0xFFFFFFFF
    filler = torch.where((w & BIT3130) == BIT3130, ONES31, 0)
    return torch.where((w & BIT31) != 0, filler, w).to(torch.int32)


def decode_span(
    words: torch.Tensor, m, base, chunk_capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand chunks [base, base + chunk_capacity) of the stream words[:m].

    Returns (chunks (chunk_capacity,) int32, n_chunks_total int32); span
    chunks at or beyond n_chunks_total - base are zero. Fills whose run
    starts before `base` cover the span head.
    """
    dev = words.device
    counts = word_counts(words, m).to(_I64)
    incl = torch.cumsum(counts, dim=0)
    n_chunks = incl[-1]
    pos = base + torch.arange(chunk_capacity, dtype=_I64, device=dev)
    chunks = expand_at(words, incl - counts, pos)
    chunks = torch.where(pos < n_chunks, chunks, 0)
    return chunks, n_chunks.to(torch.int32)


def decode_chunks(
    words: torch.Tensor, m, chunk_capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand words[:m] into 31-bit chunks -> (chunks (chunk_capacity,)
    int32, n_chunks int32): decode_span from chunk 0. Requires
    chunk_capacity >= n_chunks; chunks beyond n_chunks are zero."""
    return decode_span(words, m, 0, chunk_capacity)


def decode(
    words: torch.Tensor, m, chunk_capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decompress words[:m] -> (ints (chunk_capacity//32*31,) int32, n_ints).

    n_ints = ceil(31 * n_chunks / 32) (reference: decompress.cu:82-92),
    computed as n - n//32, which cannot wrap int32; ints beyond n_ints are
    zero. chunk_capacity must be a multiple of 32.
    """
    if chunk_capacity % 32:
        raise ValueError(f"chunk_capacity must be a multiple of 32, got {chunk_capacity}")
    chunks, n_chunks = decode_chunks(words, m, chunk_capacity)
    return bits.merge_chunks(chunks), n_chunks - n_chunks // 32


def decode_batch(
    words: torch.Tensor, ms, chunk_capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decompress a batch of streams (bitmap-index columns). words (C, M)
    int32, row c holding stream c as a prefix of ms[c] words. Returns
    (ints (C, chunk_capacity//32*31), n_ints (C,)), one decode each."""
    if words.shape[0] == 0:
        raise ValueError("decode_batch: need at least one column")
    ints, n_ints = zip(*(decode(w, int(m), chunk_capacity) for w, m in zip(words, ms)))
    return torch.stack(ints), torch.stack(n_ints)
