"""Interop with general WAH streams (the format's full envelope).

This codec *emits* streams satisfying the block invariant: fill run
lengths in [1, 1024], runs never crossing a 1024-chunk block boundary
(the reference kernel's coalescing unit — SURVEY.md §0.1; pinned by the
reference's multiBlockTest, tests.cpp:227-239). That invariant is what
makes block-sharded decode and segment concatenation exact, so
`decompress` rejects streams outside it.

Other WAH encoders use the format's full envelope: fill lengths up to
2^30-1 (the reference decoder masks lengths with 0x3FFFFFFF,
kernels.cu:300,334), adjacent same-type fills left unmerged, and all-
zero/all-one chunks sometimes emitted as the degenerate literals
0x00000000 / 0x7FFFFFFF. `rechunk_stream` converts any such stream to
the canonical block-invariant form as a PURE STREAM REWRITE — no bitmap
materialization, O(output words) NumPy work — after which every entry
point of this codec accepts it:

    words = rechunk_stream(foreign_words)
    bitmap, _ = wah_tpu_torch.decompress(words, out_ints=n, device="cuda")

A copy of wah_tpu/interop.py (numpy only): the port imports nothing of
wah_tpu.
"""
from __future__ import annotations

import numpy as np

from .constants import BIT30, BIT31, BLOCK_CHUNKS, LEN_MASK, ONES31

__all__ = ["rechunk_stream"]

_U32 = np.uint32


def rechunk_stream(words: np.ndarray) -> np.ndarray:
    """General WAH stream -> canonical block-invariant stream.

    Accepts fill lengths in [1, 2^30-1], unmerged adjacent same-type
    fills, and degenerate 0x0/0x7FFFFFFF literals; returns the stream
    this codec's encoder would produce for the same bitmap (exact
    canonical form: degenerate literals become length-1 fills, adjacent
    same-type fills merge, and every fill is split at 1024-chunk block
    boundaries — merged-then-split runs are maximal within each block).
    Raises ValueError on zero-length fills (format-invalid).
    """
    w = np.asarray(words, dtype=_U32).reshape(-1)
    if w.size == 0:
        return w.copy()

    # normalize degenerate literals into length-1 fills (a valid
    # canonical stream never contains the words 0x0 / 0x7FFFFFFF)
    w = np.where(w == _U32(0), _U32(BIT31 | 1), w)
    w = np.where(w == _U32(ONES31), _U32(BIT31 | BIT30 | 1), w)

    is_fill = (w & _U32(BIT31)) != 0
    # int64 positions: a general stream may expand past 2^31 chunks
    cnt = np.where(is_fill, (w & _U32(LEN_MASK)).astype(np.int64), 1)
    if is_fill.any() and cnt[is_fill].min() < 1:
        raise ValueError("invalid WAH stream: zero-length fill word")
    # type code: 0 zero-fill, 1 one-fill, 2 literal
    t = np.where(
        is_fill,
        ((w & _U32(BIT30)) != 0).astype(np.int8),
        np.int8(2),
    )

    # 1) merge maximal runs (unbounded): a run ends where the type
    # changes or at a literal (literals never coalesce)
    new_run = np.empty(w.size, dtype=bool)
    new_run[0] = True
    np.not_equal(t[1:], t[:-1], out=new_run[1:])
    new_run |= t == 2
    ridx = np.flatnonzero(new_run)  # first word of each run
    run_t = t[ridx]
    run_len = np.add.reduceat(cnt, ridx)
    pos = np.cumsum(cnt) - cnt  # chunk start of each word
    run_pos = pos[ridx]

    # 2) split each run at 1024-chunk block boundaries
    first_blk = run_pos // BLOCK_CHUNKS
    last_blk = (run_pos + run_len - 1) // BLOCK_CHUNKS
    n_pieces = (last_blk - first_blk + 1).astype(np.int64)  # literals: 1
    src = np.repeat(np.arange(ridx.size, dtype=np.int64), n_pieces)
    piece_base = np.cumsum(n_pieces) - n_pieces
    k = np.arange(src.size, dtype=np.int64) - piece_base[src]
    blk_start = (first_blk[src] + k) * BLOCK_CHUNKS
    p_start = np.maximum(run_pos[src], blk_start)
    p_end = np.minimum(run_pos[src] + run_len[src], blk_start + BLOCK_CHUNKS)
    plen = (p_end - p_start).astype(_U32)

    out = np.where(
        run_t[src] == 2,
        w[ridx[src]],
        _U32(BIT31)
        | np.where(run_t[src] == 1, _U32(BIT30), _U32(0))
        | plen,
    ).astype(_U32)
    return out
