"""K1: block encoder — counterpart of wah_tpu/ops/pallas/encode_kernel.py.

`encode_tiles` encodes each 992-int block into its WAH words: CUDA
kernel wah_tpu_torch/csrc/encode.cu for a CUDA tensor,
`encode_tiles_plain` for a CPU tensor. `encode_padded` is the encode
pipeline, K1 -> exclusive scan of the counts (torch.cumsum, outside the
kernels as in wah_tpu) -> K2; `encode_padded_plain` runs the same
pipeline through the plain versions.
"""
from __future__ import annotations

import torch

from ...constants import BLOCK_CHUNKS, BLOCK_INTS
from .. import bits
from ..encode import encode_blocks
from ._args import check, on_cpu
from .stitch2 import stitch_tiles_plain, stitch_tiles_v2

__all__ = ["encode_tiles", "encode_tiles_plain", "encode_padded", "encode_padded_plain"]

_IDENTITY_MASK = 0x7FFFFFFF


def _nv3(nv: torch.Tensor) -> torch.Tensor:
    """[bound, chunk_base] or [bound, chunk_base, pos_mask] -> the 3-entry form."""
    if nv.dim() != 1 or nv.shape[0] not in (2, 3):
        raise ValueError(f"nv: expected (2,) or (3,), got {tuple(nv.shape)}")
    if nv.shape[0] == 2:
        nv = torch.cat([nv, nv.new_full((1,), _IDENTITY_MASK)])
    return nv.to(torch.int32).contiguous()


def encode_tiles_plain(
    ints2d: torch.Tensor, nv: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of encode_tiles."""
    bound, base, mask = _nv3(nv).tolist()
    chunks = bits.repartition_chunks(ints2d)
    staging, counts = encode_blocks(chunks, bound, base, mask)
    return staging, counts[:, None]


def encode_tiles(
    ints2d: torch.Tensor, nv: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(nb, 992) int32 bitmap blocks + nv = [bound, chunk_base(, pos_mask)]
    int32 -> (staging (nb, 1024) int32, counts (nb, 1) int32).

    Chunk k of block b is valid when ((chunk_base + 1024 b + k) & pos_mask)
    < bound; invalid chunks emit nothing. Row b of staging holds block b's
    words as a dense prefix of counts[b] words, zero after it.
    """
    check(ints2d, "ints2d", (None, BLOCK_INTS))
    nv = _nv3(nv)
    if on_cpu(ints2d, nv):
        return encode_tiles_plain(ints2d, nv)
    nb = ints2d.shape[0]
    staging = torch.empty((nb, BLOCK_CHUNKS), dtype=torch.int32, device=ints2d.device)
    counts = torch.empty((nb, 1), dtype=torch.int32, device=ints2d.device)
    if nb:
        from ._build import launch

        launch(
            "wah_encode_tiles", ints2d.device, ints2d.data_ptr(), nv.data_ptr(),
            staging.data_ptr(), counts.data_ptr(), nb,
        )
        encode_tiles.launches += 1
    return staging, counts


encode_tiles.launches = 0


def _encode_padded(ints, n_valid_chunks: int, chunk_base: int, tiles, stitch):
    if ints.dim() != 1 or ints.shape[0] % BLOCK_INTS:
        raise ValueError(f"expected (nb*{BLOCK_INTS},) ints, got {tuple(ints.shape)}")
    nb = ints.shape[0] // BLOCK_INTS
    # clamp the bound to this call's blocks (wah_tpu encode_kernel._clamped_nv):
    # a shard's padding rows must not count as valid
    bound = min(n_valid_chunks, chunk_base + nb * BLOCK_CHUNKS)
    nv = torch.tensor([bound, chunk_base], dtype=torch.int32, device=ints.device)
    staging, counts = tiles(ints.view(nb, BLOCK_INTS), nv)
    offsets_ext = torch.cat(
        [counts.new_zeros(1), torch.cumsum(counts[:, 0], dim=0, dtype=torch.int32)]
    )
    return stitch(staging, offsets_ext), offsets_ext[-1]


def encode_padded(
    ints: torch.Tensor, n_valid_chunks: int, chunk_base: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compress a block-aligned (nb*992,) int32 bitmap whose first
    `n_valid_chunks` chunks are live (chunk_base: global index of its
    first chunk). Returns (words (nb*1024,), total int32 0-dim); words
    past total are unspecified."""
    return _encode_padded(ints, n_valid_chunks, chunk_base, encode_tiles, stitch_tiles_v2)


def encode_padded_plain(
    ints: torch.Tensor, n_valid_chunks: int, chunk_base: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """encode_padded through the plain versions, on any device."""
    return _encode_padded(
        ints, n_valid_chunks, chunk_base, encode_tiles_plain, stitch_tiles_plain
    )
