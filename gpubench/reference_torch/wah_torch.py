"""Plain PyTorch WAH codec: the benchmark's statement of the format in
torch operations, on any device, for bitmaps of gigabytes.

Independent of the code under test: it imports nothing of wah_tpu_torch
(nor JAX or wah_tpu), runs no kernel of the port, keeps no cache and
batches nothing; it is written from the format (SURVEY.md section 0.1,
after GPU-WAH's kernels.cu:51-262), as gpubench/reference/wah.py is in
NumPy. A stream is a sequence of uint32 words, held here in int32 tensors
of the same bits:

  literal    bit 31 clear, bits 30..0 one 31-bit chunk of the bitmap
  zero fill  bits 31..30 = 10, bits 29..0 a run length N of all-zero chunks
  one fill   bits 31..30 = 11, bits 29..0 a run length N of all-one chunks

Bit i of the bitmap is bit i % 32 of word i // 32. The bitmap is
zero-padded to a multiple of 31 words; chunk k holds bits [31k, 31k + 31).
Runs of equal fill chunks coalesce completely within each block of 1024
chunks (992 words) and never across a block's edge; every literal chunk
is its own word.

Why the pieces are exact. `encode` takes the bitmap in pieces of
PIECE_BLOCKS whole blocks: a piece starts on a block's edge, no run
crosses one, so each piece's stream is the whole stream's words for those
blocks, and the pieces' streams joined are the whole stream. `decode`
takes the stream in pieces of PIECE_WORDS words: each word expands to its
own chunks, whatever precedes it, so the pieces' chunks joined are the
stream's chunks; the last chunks of a piece that do not fill a group of
32 are carried into the next, and 32 chunks make 31 words. The pieces
bound the temporaries (int64, a few times the piece), so 8 GB fits.
"""
from __future__ import annotations

import torch

BLOCK_CHUNKS = 1024
GROUP_INTS = 31  # 32 chunks of 31 bits are 31 words of 32
GROUP_CHUNKS = 32
BLOCK_INTS = BLOCK_CHUNKS // GROUP_CHUNKS * GROUP_INTS  # 992
PIECE_BLOCKS = 1 << 13  # 32 MB of bitmap a piece
PIECE_WORDS = 1 << 16  # at most 2^26 chunks a piece: a fill covers <= 1024
ONES31 = 0x7FFFFFFF
ZERO_FILL = 0x80000000
ONE_FILL = 0xC0000000
LEN_MASK = 0x3FFFFFFF
_I64 = torch.int64


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors of the same 32 bits."""
    return (v - ((v >> 31) << 32)).to(torch.int32)


def _as_uint(t: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 values in [0, 2^32), the words read as uint32."""
    return t.to(_I64) & 0xFFFFFFFF


def chunks_of(ints: torch.Tensor) -> torch.Tensor:
    """(n,) int32 bitmap -> its ceil(n / 31) * 32 chunks, int64."""
    n = ints.shape[0]
    groups = -(-n // GROUP_INTS)
    # columns: word -1 (zero), the group's 31 words, word 31 (zero)
    body = torch.zeros(groups * GROUP_INTS, dtype=_I64, device=ints.device)
    body[:n] = _as_uint(ints)
    w = torch.zeros((groups, GROUP_INTS + 2), dtype=_I64, device=ints.device)
    w[:, 1 : GROUP_INTS + 1] = body.view(groups, GROUP_INTS)
    # chunk x of a group holds the group's bits [31x, 31x + 31): the high
    # x bits of word x - 1, then the low 31 - x bits of word x
    x = torch.arange(GROUP_CHUNKS, dtype=_I64, device=ints.device)
    chunks = (w[:, :GROUP_CHUNKS] >> (32 - x)) | (w[:, 1 : GROUP_CHUNKS + 1] << x)
    return (chunks & ONES31).reshape(-1)


def _encode_piece(ints: torch.Tensor) -> torch.Tensor:
    c = chunks_of(ints)
    if c.numel() == 0:
        return torch.zeros(0, dtype=torch.int32, device=ints.device)
    kind = torch.full_like(c, 2)  # 0 zero fill, 1 one fill, 2 literal
    kind[c == 0] = 0
    kind[c == ONES31] = 1
    pos = torch.arange(c.numel(), dtype=_I64, device=c.device)
    prev = torch.cat([kind.new_full((1,), -1), kind[:-1]])
    starts = (kind == 2) | (kind != prev) | (pos % BLOCK_CHUNKS == 0)
    first = torch.nonzero(starts).reshape(-1)
    ends = torch.cat([first[1:], first.new_full((1,), c.numel())])
    runs = ends - first
    k = kind[first]
    fill = torch.where(k == 1, ONE_FILL, ZERO_FILL) | runs
    return _as_int32(torch.where(k == 2, c[first], fill))


def encode_pieces(ints: torch.Tensor) -> list[torch.Tensor]:
    """(n,) int32 bitmap on any device -> its WAH stream as the streams of
    its pieces of PIECE_BLOCKS blocks, in order, int32, on the same device."""
    step = PIECE_BLOCKS * BLOCK_INTS
    return [_encode_piece(ints[i : i + step]) for i in range(0, max(1, ints.shape[0]), step)]


def encode(ints: torch.Tensor) -> torch.Tensor:
    """(n,) int32 bitmap on any device -> its WAH stream, int32, on the
    same device."""
    pieces = encode_pieces(ints)
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def _merge(chunks: torch.Tensor) -> torch.Tensor:
    """(32 g,) int64 chunks -> (31 g,) int32 words: word x of a group is
    chunk x from its bit x up, then the low x + 1 bits of chunk x + 1."""
    c = chunks.view(-1, GROUP_CHUNKS)
    x = torch.arange(GROUP_INTS, dtype=_I64, device=chunks.device)
    words = ((c[:, :GROUP_INTS] >> x) | (c[:, 1:] << (31 - x))) & 0xFFFFFFFF
    return _as_int32(words.reshape(-1))


def decode(words: torch.Tensor, n_ints: int) -> torch.Tensor:
    """WAH stream (int32 words) on any device -> the bitmap's first n_ints
    words, int32, zero past the stream's chunks."""
    dev = words.device
    out = []
    carry = torch.zeros(0, dtype=_I64, device=dev)
    for i in range(0, words.shape[0], PIECE_WORDS):
        w = _as_uint(words[i : i + PIECE_WORDS])
        fill = (w & ZERO_FILL) != 0
        runs = torch.where(fill, w & LEN_MASK, 1)
        payload = torch.where(fill, torch.where((w & ONE_FILL) == ONE_FILL, ONES31, 0), w)
        c = torch.cat([carry, torch.repeat_interleave(payload, runs)])
        whole = c.numel() // GROUP_CHUNKS * GROUP_CHUNKS
        out.append(_merge(c[:whole]))
        carry = c[whole:]
    if carry.numel():
        last = torch.zeros(GROUP_CHUNKS, dtype=_I64, device=dev)
        last[: carry.numel()] = carry
        out.append(_merge(last))
    got = torch.cat(out) if out else torch.zeros(0, dtype=torch.int32, device=dev)
    if got.shape[0] < n_ints:
        got = torch.cat([got, got.new_zeros(n_ints - got.shape[0])])
    return got[:n_ints]


COMPARE_WORDS = 1 << 26  # words compared a call: a 64 MB mask


def words_differing(got: torch.Tensor, want: torch.Tensor) -> int:
    """Words that differ between two int32 streams or bitmaps (one device),
    each word past the shorter one counted as differing."""
    m = min(got.shape[0], want.shape[0])
    wrong = 0
    for i in range(0, m, COMPARE_WORDS):
        j = min(m, i + COMPARE_WORDS)
        wrong += int((got[i:j] != want[i:j]).sum())
    return wrong + abs(got.shape[0] - want.shape[0])


def stream_differing(got: torch.Tensor, pieces: list[torch.Tensor]) -> int:
    """words_differing of `got` against the stream whose pieces (encode_pieces)
    are `pieces`, without joining them."""
    wrong, at = 0, 0
    for p in pieces:
        wrong += words_differing(got[at : at + p.shape[0]], p)
        at += p.shape[0]
    return wrong + max(0, got.shape[0] - at)
