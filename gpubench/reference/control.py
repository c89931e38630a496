"""The control: the reference put in the program's place with one of its
configuration's guarantees broken by a shortcut a faster implementation
could take. The comparison that decides `correct` has to find it wrong
(gpubench/tests/test_gpubench_harness.py on the CPU; `python -m
gpubench.control` on the card at a cell's own size).

Protocol bitmaps, "the stream is the WAH format word for word": fill runs
coalesced only within each warp of 32 chunks (GPU-WAH's first pass,
before its block-wide merge). The stream still decodes to the input, in
more words.
"""
from __future__ import annotations

import numpy as np

from . import wah

WARP_CHUNKS = 32


def encode(ints: np.ndarray) -> np.ndarray:
    """The stream with runs coalesced within warps only."""
    return wah.encode(ints, run_chunks=WARP_CHUNKS)


def decode(words: np.ndarray, out_ints: int) -> np.ndarray:
    return wah.decode(words, out_ints)
