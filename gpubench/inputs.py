"""Inputs drawn from --seed on the device, in a few large calls: the same
seed gives the same inputs on the same kind of device.

- `bernoulli_bitmap`: the GPU-WAH harness's bitmaps (source.cpp:29-148),
  every bit set with probability 2^-i: the AND of i uniform 32-bit words.
"""
from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 64))
    return g


def random_words(n: int, g: torch.Generator) -> torch.Tensor:
    """(n,) int32 words, every bit pattern equally likely."""
    return torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int64, generator=g,
                         device=g.device).to(torch.int32)


def bernoulli_bitmap(n_ints: int, exponent: int, g: torch.Generator) -> torch.Tensor:
    """(n_ints,) int32 bitmap on g's device, each bit set with probability
    2^-exponent, independently."""
    out = random_words(n_ints, g)
    for _ in range(exponent - 1):
        out &= random_words(n_ints, g)
    return out


def to_host_words(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> numpy uint32, same bits."""
    return t.cpu().numpy().view(np.uint32)
