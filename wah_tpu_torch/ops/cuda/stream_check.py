"""V1: check and count a WAH stream on the device (check_stream).

Replaces no TPU kernel: wah_tpu validates and counts a stream on the host
(api.checked_stream and stream_chunks), one thread over the whole stream
before the stream is sent. Every decompress here (WahCodec.decompress,
WahCodec.decompress_batch a column at a time, ShardedCodec.decompress on
every rank) sends the stream as it is and runs this pass over the copy:
one read of the words in device memory gives the first word that breaks
the format and the chunk count that sizes the decode. The kernel
(wah_tpu_torch/csrc/stream_check.cu) is bound by memory, 4 bytes read a
word; its header says how it keeps the loads in flight. `check_stream` runs it for a CUDA tensor and its plain twin
`check_stream_plain` for a CPU tensor.
"""
from __future__ import annotations

import torch

from ...constants import BIT31, BLOCK_CHUNKS, LEN_MASK, ONES31
from ._args import check, device_ints, on_cpu

__all__ = ["check_stream", "check_stream_plain"]

_I64 = torch.int64


def check_stream_plain(words: torch.Tensor, m: int) -> torch.Tensor:
    """Plain torch version of check_stream."""
    if m == 0:
        return torch.zeros(2, dtype=_I64, device=words.device)
    w = words[:m].to(_I64) & 0xFFFFFFFF
    fill = (w & BIT31) != 0
    length = w & LEN_MASK
    bad = (w == 0) | (w == ONES31) | (fill & ((length < 1) | (length > BLOCK_CHUNKS)))
    first_bad = torch.where(bad.any(), bad.to(torch.int32).argmax(), m)  # argmax: the first
    return torch.stack([first_bad, torch.where(fill, length, 1).sum()])


def check_stream(words: torch.Tensor, m: int) -> torch.Tensor:
    """words[:m] of an (M,) int32 stream, m <= M -> (2,) int64 on its device:
    [first_bad, n_chunks]. first_bad is the index of the first word that
    breaks the format (0x0, 0x7FFFFFFF, a fill of length outside [1, 1024]),
    or m if none does; n_chunks is the chunk count the stream expands to (a
    fill counts its length, a literal 1; meaningful only when first_bad ==
    m). Words past m are not read."""
    check(words, "words", (None,))
    if not 0 <= m <= words.shape[0]:
        raise ValueError(f"m = {m} outside the {words.shape[0]} words")
    if on_cpu(words):
        return check_stream_plain(words, m)
    if words.data_ptr() % 16:
        raise ValueError("words: the kernel loads 16 B vectors; pass a 16 B-aligned tensor")
    out = device_ints([m, 0], words.device, _I64)
    if m:
        from ._build import launch

        launch("wah_check_stream", words.device, words.data_ptr(), m, out.data_ptr())
        check_stream.launches += 1
    return out


check_stream.launches = 0
