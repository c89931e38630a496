"""Bit-repartition primitives: 32-bit words <-> 31-bit WAH chunks.

Plain torch port of wah_tpu.ops.bits (reference: kernels.cu:72-79
encode, kernels.cu:369-385 decode). Tensors hold uint32 bit patterns as
int32; the shifts run in int64 and the results are wrapped back.

Layout contract (reference: tests.cpp:94-97): logical bit i of the bitmap
is bit (i % 32), LSB-first, of uint32 word i // 32; chunk k holds logical
bits [31k, 31k+31) LSB-first in its low 31 bits.
"""
from __future__ import annotations

import torch

from ..constants import ONES31, WARP_INTS
from ..convert import to_i32

__all__ = ["repartition_chunks", "merge_chunks"]


def repartition_chunks(ints: torch.Tensor) -> torch.Tensor:
    """(..., 31k) int32 -> (..., 32k) int32 31-bit chunks.

    Within each group of 31 input words:
      chunk[x] = ONES31 & (((int[x-1] >> (31-x)) >> 1) | (int[x] << x)),
    with int[-1] = int[31] = 0; the right shift is split so that lane 0
    never shifts by 32 (reference: kernels.cu:79 relies on PTX clamping).
    """
    if ints.shape[-1] % WARP_INTS:
        raise ValueError(f"last dim must be a multiple of 31, got {ints.shape}")
    lead = ints.shape[:-1]
    w = (ints.to(torch.int64) & 0xFFFFFFFF).reshape(*lead, -1, WARP_INTS)
    zcol = torch.zeros((*w.shape[:-1], 1), dtype=torch.int64, device=w.device)
    a = torch.cat([w, zcol], dim=-1)  # int[x], a[31] = 0
    b = torch.cat([zcol, w], dim=-1)  # int[x-1], b[0] = 0
    x = torch.arange(32, dtype=torch.int64, device=w.device)
    chunks = (((b >> (31 - x)) >> 1) | (a << x)) & ONES31
    return chunks.to(torch.int32).reshape(*lead, -1)


def merge_chunks(chunks: torch.Tensor, carry=None) -> torch.Tensor:
    """(..., 32k) int32 31-bit chunks -> (..., 31k) int32 words.

    Inverse of repartition_chunks:
      int[x] = (chunk[x] >> x) | (chunk[x+1] << (31-x)),  x in [0, 31),
    where chunk[32] is the next group's chunk[0]; `carry` is the chunk
    following the array (default 0).
    """
    if chunks.shape[-1] % 32:
        raise ValueError(f"last dim must be a multiple of 32, got {chunks.shape}")
    lead = chunks.shape[:-1]
    c = chunks.to(torch.int64) & 0xFFFFFFFF
    last = torch.zeros((*lead, 1), dtype=torch.int64, device=c.device)
    if carry is not None:
        last = last + (torch.as_tensor(carry, dtype=torch.int64) & 0xFFFFFFFF)
    nxt = torch.cat([c[..., 1:], last], dim=-1)
    cw = c.reshape(*lead, -1, 32)
    nw = nxt.reshape(*lead, -1, 32)
    x = torch.arange(31, dtype=torch.int64, device=c.device)
    ints = (cw[..., :31] >> x) | (nw[..., :31] << (31 - x))
    return to_i32(ints).reshape(*lead, -1)
