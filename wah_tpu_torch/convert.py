"""numpy uint32 <-> torch int32 word tensors.

torch cannot shift uint32 tensors, so the port carries WAH words and
bitmap ints as int32 tensors holding the uint32 bit patterns. These two
functions are the only place the views change; the public API keeps
numpy uint32 in and out, like wah_tpu.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["words_to_tensor", "tensor_to_words", "to_i32"]


def words_to_tensor(words: np.ndarray, device, size: int | None = None) -> torch.Tensor:
    """(n,) numpy uint32 -> (n,) int32 tensor on `device`, same bits. On the
    CPU the tensor shares a writable array's memory. With `size` (>= n) the
    tensor has `size` words: the n words are copied straight into the head
    of a fresh tensor, and its tail is zeroed on `device`."""
    words = np.require(words, dtype=np.uint32, requirements=["C", "W"])
    host = torch.from_numpy(words.view(np.int32))
    if size is None:
        return host.to(device)
    out = torch.empty(size, dtype=torch.int32, device=device)
    out[host.shape[0] :].zero_()
    out[: host.shape[0]].copy_(host)
    return out


def tensor_to_words(t: torch.Tensor) -> np.ndarray:
    """int32 tensor (any device) -> numpy uint32 array, same bits."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected an int32 tensor, got {t.dtype}")
    return t.cpu().numpy().view(np.uint32)


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an integer tensor as an int32 bit pattern (wraps
    explicitly instead of relying on the cast's overflow behaviour)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)
