"""K2: stitch — counterpart of wah_tpu/ops/pallas/stitch2.py.

`stitch_tiles_v2` lays each staging row's word prefix into the dense
stream at its exclusive offset: CUDA kernel wah_tpu_torch/csrc/stitch.cu
for a CUDA tensor, `stitch_tiles_plain` for a CPU tensor.
"""
from __future__ import annotations

import torch

from ...constants import BLOCK_CHUNKS
from ..encode import place_rows
from ._args import check, on_cpu

__all__ = ["stitch_tiles_v2", "stitch_tiles_plain"]


def stitch_tiles_plain(
    staging: torch.Tensor, offsets_ext: torch.Tensor, counts: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain torch version of stitch_tiles_v2 (zeros past the total)."""
    nb = staging.shape[0]
    if counts is None:
        counts = offsets_ext[1:] - offsets_ext[:-1]
    return place_rows(staging, offsets_ext[:nb], counts)


def stitch_tiles_v2(
    staging: torch.Tensor, offsets_ext: torch.Tensor, counts: torch.Tensor | None = None
) -> torch.Tensor:
    """(nb, 1024) int32 staging rows + exclusive word offsets (nb+1,) int32
    -> (nb*1024,) int32 stream; row b's first counts[b] words land at
    offsets_ext[b]. Words past offsets_ext[-1] are unspecified.

    counts: optional per-row word counts. When omitted they are the
    offset differences (one contiguous stream); batched columns pass them
    because their offsets jump at column bases.
    """
    nb = staging.shape[0]
    check(staging, "staging", (None, BLOCK_CHUNKS))
    check(offsets_ext, "offsets_ext", (nb + 1,))
    tensors = [staging, offsets_ext]
    if counts is not None:
        check(counts, "counts", (nb,))
        tensors.append(counts)
    if on_cpu(*tensors):
        return stitch_tiles_plain(staging, offsets_ext, counts)
    out = torch.empty(nb * BLOCK_CHUNKS, dtype=torch.int32, device=staging.device)
    if nb:
        from ._build import launch

        launch(
            "wah_stitch_tiles", staging.device, staging.data_ptr(), offsets_ext.data_ptr(),
            None if counts is None else counts.data_ptr(), out.data_ptr(), nb,
        )
        stitch_tiles_v2.launches += 1
    return out


stitch_tiles_v2.launches = 0
