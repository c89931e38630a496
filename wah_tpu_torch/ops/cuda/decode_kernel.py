"""K3 and K4: decode — counterpart of wah_tpu/ops/pallas/decode_kernel.py.

`prescan_words` (K3) masks the stream words to the valid count and sums
each 128-word granule's expanded size; `decode_blocks` (K4, the
counterpart of `_run_decode`) expands and merges each 1024-chunk output
block. Both run their CUDA kernel (wah_tpu_torch/csrc/decode.cu) for a
CUDA tensor and their plain version for a CPU tensor. K4 is bound by
memory on paper and by latency in practice, so its kernel is built
around that (decode.cu's header): CTAs of 160 threads that each walk a
range of output blocks, the covering granule from a probe of the next
entries of `g_base` instead of a search, the next block's window copied
by cp.async while this one expands, one scan, no search for the
covering words, 16 B loads and stores. `decode` is the
decode pipeline, K3 -> exclusive scan of the granule sums (torch.cumsum,
outside the kernels as in wah_tpu) -> K4; `decode_rows_batch` the same
over batched columns (K3 with per-column valid counts, K4 with a
per-column position mask). Each `_plain` twin runs the same pipeline
through the plain versions.
"""
from __future__ import annotations

import torch

from ...constants import BLOCK_CHUNKS, BLOCK_INTS
from ...convert import to_i32
from ...utils.profiling import span
from .. import bits
from ..decode import expand_at, word_counts
from ._args import check, device_ints, on_cpu
from ._batch import rebase_exclusive_per_col

__all__ = [
    "prescan_words",
    "prescan_words_plain",
    "decode_blocks",
    "decode_blocks_plain",
    "decode",
    "decode_span",
    "decode_plain",
    "decode_batch",
    "decode_rows_batch",
    "decode_rows_batch_plain",
]

GRANULE = 128  # words per granule of the offset tables
_I64 = torch.int64
INT32_CHUNKS = (1 << 31) - 1  # chunk positions are int32 in K3 and K4


def _check_prescan(words, vc, out_rows):
    check(words, "words", (None,))
    check(vc, "vc", (out_rows,))
    if words.shape[0] % BLOCK_CHUNKS:
        raise ValueError(f"words: length must be a multiple of 1024, got {words.shape[0]}")
    if out_rows < words.shape[0] // GRANULE:
        raise ValueError(f"out_rows {out_rows} < {words.shape[0] // GRANULE} input rows")


def prescan_words_plain(
    words: torch.Tensor, vc: torch.Tensor, out_rows: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of prescan_words."""
    rows_in = words.shape[0] // GRANULE
    w = torch.zeros((out_rows, GRANULE), dtype=torch.int32, device=words.device)
    w[:rows_in] = words.view(rows_in, GRANULE)
    lane = torch.arange(GRANULE, device=words.device)
    keep = lane < vc[:, None]
    w = torch.where(keep, w, 0)
    cnt = word_counts(w.reshape(-1), w.numel()).view(out_rows, GRANULE).to(_I64)
    return w, to_i32(torch.where(keep, cnt, 0).sum(dim=1))


def prescan_words(
    words: torch.Tensor, vc: torch.Tensor, out_rows: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(M,) int32 words, M % 1024 == 0, + (out_rows,) int32 per-granule
    valid counts -> (words_t (out_rows, 128) int32, g_sums (out_rows,) int32).

    Lane k of granule row r is kept iff k < vc[r] and zeroed otherwise;
    rows past the input are zero. g_sums[r] is the expanded size of row
    r's kept words (fill -> run length, literal -> 1). For one stream of m
    words, vc[r] = clip(m - 128 r, 0, 128).
    """
    _check_prescan(words, vc, out_rows)
    if on_cpu(words, vc):
        return prescan_words_plain(words, vc, out_rows)
    if words.data_ptr() % 16:
        raise ValueError("words: the kernel loads 16 B vectors; pass a 16 B-aligned tensor")
    words_t = torch.empty((out_rows, GRANULE), dtype=torch.int32, device=words.device)
    g_sums = torch.empty(out_rows, dtype=torch.int32, device=words.device)
    if out_rows:
        from ._build import launch

        launch(
            "wah_prescan_words", words.device, words.data_ptr(), vc.data_ptr(),
            words_t.data_ptr(), g_sums.data_ptr(), words.shape[0] // GRANULE, out_rows,
        )
        prescan_words.launches += 1
    return words_t, g_sums


prescan_words.launches = 0


def decode_blocks_plain(
    words_t: torch.Tensor, g_base: torch.Tensor, meta: torch.Tensor, nbo: int
) -> torch.Tensor:
    """Plain torch version of decode_blocks."""
    n_chunks, m, chunk_base, pos_mask = meta.tolist()
    words = words_t.reshape(-1)
    # zero words (lanes K3 masked; never a valid word) count 0 here, which
    # keeps the offsets sorted across batched columns for the search; K4
    # counts them as literals inside its window. Either way they cover
    # only positions that the mask kills.
    cnt = torch.where(words == 0, 0, word_counts(words, m)).view(-1, GRANULE).to(_I64)
    offsets = (g_base.to(_I64)[:, None] + torch.cumsum(cnt, dim=1) - cnt).reshape(-1)
    pos = chunk_base + torch.arange(nbo * BLOCK_CHUNKS, dtype=_I64, device=words.device)
    chunks = torch.where((pos & pos_mask) < n_chunks, expand_at(words, offsets, pos), 0)
    return bits.merge_chunks(chunks.view(nbo, BLOCK_CHUNKS))


def decode_blocks(
    words_t: torch.Tensor, g_base: torch.Tensor, meta: torch.Tensor, nbo: int
) -> torch.Tensor:
    """Expand and merge nbo output blocks -> (nbo, 992) int32.

    words_t (rows, 128) int32: prescanned words (zero past the stream);
    g_base (rows,) int32: each granule's first chunk position, the
    exclusive scan of prescan_words' g_sums; meta (4,) int32:
    [n_chunks, m, chunk_base, pos_mask]. Output block bo holds chunks
    [chunk_base + 1024 bo, + 1024) merged to 32-bit ints; chunks whose
    (position & pos_mask) >= n_chunks are zero. chunk_base is a multiple
    of 1024 and pos_mask is 2^k - 1 with k >= 10 (0x7FFFFFFF for one
    stream, the column capacity - 1 for batched columns), so the valid
    chunks of a block are a prefix of it; g_base is non-decreasing.
    """
    rows = words_t.shape[0]
    check(words_t, "words_t", (None, GRANULE))
    check(g_base, "g_base", (rows,))
    check(meta, "meta", (4,))
    if rows == 0:
        raise ValueError("words_t: need at least one granule row")
    if on_cpu(words_t, g_base, meta):
        return decode_blocks_plain(words_t, g_base, meta, nbo)
    if words_t.data_ptr() % 16:
        raise ValueError("words_t: the kernel copies 16 B vectors; pass a 16 B-aligned tensor")
    out = torch.empty((nbo, BLOCK_INTS), dtype=torch.int32, device=words_t.device)
    if nbo:
        from ._build import launch

        launch(
            "wah_decode_blocks", words_t.device, words_t.data_ptr(), g_base.data_ptr(),
            meta.data_ptr(), out.data_ptr(), rows, nbo,
        )
        decode_blocks.launches += 1
    return out


decode_blocks.launches = 0


def _decode(words, m: int, chunk_capacity: int, chunk_base: int, prescan, blocks):
    """The decode pipeline -> (ints, n_chunks int32 0-dim of the whole stream)."""
    if chunk_capacity % BLOCK_CHUNKS:
        raise ValueError(f"chunk_capacity must be a multiple of 1024, got {chunk_capacity}")
    with span("wah.decode"):
        M = words.shape[0]
        Mr = -(-M // BLOCK_CHUNKS) * BLOCK_CHUNKS
        if Mr != M:
            words = torch.cat([words, words.new_zeros(Mr - M)])
        rows = Mr // GRANULE
        dev = words.device
        vc = (m - GRANULE * torch.arange(rows, dtype=_I64, device=dev)).clamp(0, GRANULE)
        words_t, g_sums = prescan(words, vc.to(torch.int32), rows)
        g_incl = torch.cumsum(g_sums, dim=0, dtype=torch.int32)
        meta = device_ints([0, m, chunk_base, 0x7FFFFFFF], dev)
        meta[:1] = g_incl[-1:]  # n_chunks
        ints = blocks(words_t, g_incl - g_sums, meta, chunk_capacity // BLOCK_CHUNKS)
        return ints.reshape(-1), g_incl[-1]


def decode_span(
    words: torch.Tensor, m: int, chunk_capacity: int, chunk_base: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """decode, returning the chunk count of the whole stream (int32 0-dim)
    in place of n_ints: the sharded decode's per-rank body, whose span
    does not tell the stream's length."""
    return _decode(words, m, chunk_capacity, chunk_base, prescan_words, decode_blocks)


def decode(
    words: torch.Tensor, m: int, chunk_capacity: int, chunk_base: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decompress words[:m] -> (ints (chunk_capacity//1024*992,) int32,
    n_ints int32 0-dim). chunk_capacity must be a multiple of 1024;
    chunk_base (block-aligned) decodes the span [chunk_base, chunk_base +
    chunk_capacity) instead. n_ints = ceil(31 n_chunks / 32) of the whole
    stream, computed as n - n//32 so that it cannot wrap int32."""
    ints, n = decode_span(words, m, chunk_capacity, chunk_base)
    return ints, n - n // 32


def decode_plain(
    words: torch.Tensor, m: int, chunk_capacity: int, chunk_base: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """decode through the plain versions, on any device."""
    ints, n = _decode(
        words, m, chunk_capacity, chunk_base, prescan_words_plain, decode_blocks_plain
    )
    return ints, n - n // 32


def _decode_rows_batch(words_flat, C: int, ms, col_chunk_capacity: int, prescan, blocks):
    cap = col_chunk_capacity
    limit = INT32_CHUNKS  # read at each call
    check(words_flat, "words_flat", (None,))
    check(ms, "ms", (C,))
    total = words_flat.shape[0]
    if C < 1 or total % C or (total // C) % BLOCK_CHUNKS:
        raise ValueError(f"{total} words do not split into {C} columns of whole 1024-word tiles")
    if cap < BLOCK_CHUNKS or cap & (cap - 1):
        raise ValueError(f"col_chunk_capacity must be a power of two >= 1024, got {cap}")
    if cap > limit:
        raise ValueError(
            f"one column of {cap} chunks exceeds the {limit} int32 chunk positions "
            "of one decode; split the columns into segments"
        )
    G = min(C, limit // cap)  # columns per group (int32 positions)
    if G == C:
        return _decode_column_group(words_flat, C, ms, cap, prescan, blocks)
    Mcap = total // C
    parts = []
    for c0 in range(0, C, G):
        c1 = min(c0 + G, C)
        parts.append(_decode_column_group(
            words_flat[c0 * Mcap : c1 * Mcap], c1 - c0, ms[c0:c1], cap, prescan, blocks))
    return torch.cat(parts)


def _decode_column_group(words_flat, C: int, ms, cap: int, prescan, blocks):
    """One batched decode of C columns whose C * cap positions fit int32."""
    total = words_flat.shape[0]
    gpc = total // C // GRANULE  # granules per column; none straddles two columns
    rel = GRANULE * torch.arange(gpc, dtype=torch.int32, device=words_flat.device)
    vc = (ms[:, None] - rel[None, :]).clamp(0, GRANULE).reshape(-1)
    words_t, g_sums = prescan(words_flat, vc, C * gpc)
    g_base, col_totals = rebase_exclusive_per_col(g_sums, C, gpc, cap)
    # every column expands to the same chunk count (equal-length columns)
    meta = device_ints([0, total, 0, cap - 1], ms.device)
    meta[:1] = col_totals[:1]
    return blocks(words_t, g_base, meta, C * cap // BLOCK_CHUNKS).reshape(-1)


def decode_rows_batch(
    words_flat: torch.Tensor, C: int, ms: torch.Tensor, col_chunk_capacity: int
) -> torch.Tensor:
    """Batched-column decode over flat words: (C*Mcap,) int32, Mcap % 1024
    == 0, column c's stream at words_flat[c*Mcap:][:ms[c]] (words past it
    may be anything), ms (C,) int32 -> (C * cap//1024 * 992,) int32;
    column c's bitmap starts at c * cap//1024 * 992, zero past its chunk
    count. cap = col_chunk_capacity, a power of two >= 1024 that every
    column fits in; every column must expand to the same chunk count
    (equal-length columns).

    K3 zeroes each column's words past ms[c] through the per-granule valid
    counts; the granule sums are rebased to the column bases c*cap; K4
    decodes all C*cap/1024 blocks with pos_mask = cap - 1, so the zeroed
    tail words (counted as literals in its window) land at positions the
    mask kills. The columns go in groups of at most INT32_CHUNKS // cap
    columns, which keeps chunk positions within int32 (as
    encode_rows_batch's group_rows does); raises ValueError when one column
    alone exceeds INT32_CHUNKS.
    """
    return _decode_rows_batch(
        words_flat, C, ms, col_chunk_capacity, prescan_words, decode_blocks
    )


def decode_rows_batch_plain(
    words_flat: torch.Tensor, C: int, ms: torch.Tensor, col_chunk_capacity: int
) -> torch.Tensor:
    """decode_rows_batch through the plain versions, on any device."""
    return _decode_rows_batch(
        words_flat, C, ms, col_chunk_capacity, prescan_words_plain, decode_blocks_plain
    )


def decode_batch(
    words2d: torch.Tensor, ms: torch.Tensor, col_chunk_capacity: int
) -> torch.Tensor:
    """decode_rows_batch of (C, Mcap) streams (a free view in torch)."""
    return decode_rows_batch(words2d.reshape(-1), words2d.shape[0], ms, col_chunk_capacity)
