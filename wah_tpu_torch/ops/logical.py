"""Compressed-domain logical operations on WAH streams — port of
wah_tpu.ops.logical.

Bitmap-index queries combine compressed columns with AND/OR/XOR/ANDNOT.
As in wah_tpu, a binary op decodes both operands into bitmaps, applies
the op elementwise and re-encodes, all on one device; a k-way fold
decodes its k columns in one batched decode, reduces them by a tree of
halves and encodes once. On a CUDA device the decodes and encodes run
kernels K1-K4 (ops/cuda), every encode stitched by K2; on the CPU their
plain versions. Each function takes `plain=True` to run the same
pipeline through the plain versions on any device (the reference the
kernels are held to).

NOT is complement: every literal flips, zero-fills and one-fills swap —
a rewrite of the compressed words with no decode (elementwise torch, as
wah_tpu computes it in jnp). Callers supply the bitmap's true length in
ints so that padding bits stay zero.
"""
from __future__ import annotations

import torch

from ..constants import BIT30, BIT31, BIT3130, BLOCK_CHUNKS, BLOCK_INTS, ONES31
from ..convert import to_i32
from ..golden import chunk_count
from .cuda import decode_kernel as dk
from .cuda import encode_kernel as ek

__all__ = [
    "OPS",
    "logical_op",
    "logical_reduce",
    "logical_reduce_flat",
    "complement_stream",
]

OPS = {
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b,
    "andnot": lambda a, b: a & ~b,
}
FOLD_OPS = ("or", "and", "xor")  # associative: andnot cannot be folded


def _pipeline(plain: bool):
    """(decode, decode_rows_batch, encode_padded): kernels or plain versions."""
    if plain:
        return dk.decode_plain, dk.decode_rows_batch_plain, ek.encode_padded_plain
    return dk.decode, dk.decode_rows_batch, ek.encode_padded


def logical_op(
    words_a: torch.Tensor, m_a: int, words_b: torch.Tensor, m_b: int, op: str,
    n_ints: int, plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streams A = words_a[:m_a], B = words_b[:m_b] (int32, one device,
    both of logical length n_ints > 0) -> compressed A op B as (words,
    total), the contract of encode_padded, stitched by K2 ("v3", as the
    folds): words past total are unspecified."""
    fn = OPS[op]
    decode, _, encode = _pipeline(plain)
    nv = chunk_count(n_ints)
    cap = -(-nv // BLOCK_CHUNKS) * BLOCK_CHUNKS
    a, _ = decode(words_a, m_a, cap)
    b, _ = decode(words_b, m_b, cap)
    combined = fn(a, b)
    combined[n_ints:] = 0  # ANDNOT could set padding bits; they encode as zero fills
    return encode(combined, nv, stitch="v3")


def _identity_words(op: str, nv: int, M: int, device) -> tuple[torch.Tensor, int]:
    """(M,) identity stream that pads a k-way fold to a power-of-two fan-in:
    the all-ones bitmap for AND, all-zeros for OR/XOR, as proper fill
    streams (one fill word per 1024-chunk block) so that the padding
    columns expand like the others. Returns (words, word count). Built on
    `device`: nothing crosses from the host."""
    nb = -(-nv // BLOCK_CHUNKS)
    if M < nb:
        raise ValueError(f"{M} words cannot hold the {nb}-word identity stream")
    lens = (nv - BLOCK_CHUNKS * torch.arange(nb, device=device)).clamp(max=BLOCK_CHUNKS)
    out = torch.zeros(M, dtype=torch.int32, device=device)
    out[:nb] = to_i32(lens | (BIT3130 if op == "and" else BIT31))
    return out, nb


def logical_reduce(
    words2d: torch.Tensor, ms: torch.Tensor, op: str, n_ints: int, plain: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, M) form of logical_reduce_flat (a free view in torch)."""
    return logical_reduce_flat(words2d.reshape(-1), words2d.shape[0], ms, op, n_ints, plain)


def logical_reduce_flat(
    words_flat: torch.Tensor, C: int, ms: torch.Tensor, op: str, n_ints: int,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold C streams with an associative op (or/and/xor) -> one compressed
    stream (words, total), stitched by K2 ("v3", as in wah_tpu).

    words_flat (C*M,) int32, M % 1024 == 0, stream c at words_flat[c*M:]
    [:ms[c]]; ms (C,) int32 on the same device; every stream of logical
    length n_ints. One batched decode of all C columns (padded to a
    power-of-two fan-in with identity streams), a tree fold over halves
    of the decoded buffer, and one encode.
    """
    if op not in FOLD_OPS:
        raise ValueError(f"fold op must be one of {FOLD_OPS}, got {op!r}")
    fn = OPS[op]
    _, decode_rows_batch, encode = _pipeline(plain)
    M = words_flat.shape[0] // C
    if words_flat.shape[0] != C * M:
        raise ValueError(f"{words_flat.shape[0]} words do not split into {C} columns")
    nv = chunk_count(n_ints)
    nb = -(-nv // BLOCK_CHUNKS)
    pad_ints = nb * BLOCK_INTS
    Cp = 1 << max(0, (C - 1).bit_length())
    if Cp != C:
        idw, mi = _identity_words(op, nv, M, words_flat.device)
        words_flat = torch.cat([words_flat, idw.repeat(Cp - C)])
        ms = torch.cat([ms, ms.new_full((Cp - C,), mi)])
    nbp = 1 << max(0, (nb - 1).bit_length())
    flat = decode_rows_batch(words_flat, Cp, ms, nbp * BLOCK_CHUNKS)
    collen = nbp * BLOCK_INTS
    c = Cp
    while c > 1:
        h = c // 2
        flat = fn(flat[: h * collen], flat[h * collen :])
        c = h
    acc = flat[:pad_ints]
    acc[n_ints:] = 0
    return encode(acc, nv, stitch="v3")


def complement_stream(words: torch.Tensor, m: int) -> torch.Tensor:
    """NOT in the compressed domain: among words[:m], literals flip their
    payload bits and zero-fills become one-fills and back; words past m
    are unchanged. The caller owns the padding bits (AND with the row
    universe, as BitmapIndex.query_not does)."""
    is_fill = words < 0  # bit 31 set
    out = torch.where(is_fill, words ^ BIT30, words ^ ONES31)
    i = torch.arange(words.shape[0], device=words.device)
    return torch.where(i < m, out, words)
