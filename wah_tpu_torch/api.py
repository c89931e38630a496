"""Host-facing codec API — the torch port of wah_tpu.api's single-stream
entry points compress() / decompress() (reference: compress.h:12-18,
decompress.h:11-17), with their three phase timings per direction.

numpy uint32 in, numpy uint32 out, as in wah_tpu. On a CUDA device the
kernels K1-K4 run (ops/cuda); on the CPU their plain versions.
Differences from wah_tpu by design: no power-of-two shape buckets (they
exist for jit-cache reuse, which PyTorch has no use for) and no TPU
variant hints (a kernel that writes each word to its slot has no pass
count to choose); the streams are identical either way.
"""
from __future__ import annotations

import numpy as np
import torch

from .constants import BIT31, BLOCK_CHUNKS, BLOCK_INTS, LEN_MASK, ONES31
from .convert import tensor_to_words, words_to_tensor
from .golden import chunk_count
from .ops.cuda import decode_kernel, encode_kernel
from .utils.timing import PhaseTimer, PhaseTimings

__all__ = ["WahCodec", "compress", "decompress", "validate_stream", "checked_stream"]

# Chunk positions are int32 in the kernels: one bitmap is capped at
# 2^31 - 1 chunks (~8.3 GB).
MAX_INTS_PER_BITMAP = (((1 << 31) - 1) * 31) // 32


def _check_size(n: int) -> None:
    if n > MAX_INTS_PER_BITMAP:
        raise ValueError(
            f"bitmap of {n} ints exceeds the 2^31-1 chunk (~8.3 GB) "
            "int32 position limit; split into columns or segments"
        )


def validate_stream(words: np.ndarray) -> None:
    """Check a WAH stream against the format invariants (SURVEY.md section
    0.1): no 0x0/0x7FFFFFFF words, fill lengths in [1, 1024]. The
    reference decoder checks nothing (decompress.cu:48-52); every
    decompress here validates first."""
    words = np.asarray(words, dtype=np.uint32)
    if np.any(words == 0) or np.any(words == ONES31):
        raise ValueError("invalid WAH stream: contains literal-fill word")
    fills = words[(words & np.uint32(BIT31)) != 0]
    lens = fills & np.uint32(LEN_MASK)
    if fills.size and (lens.min() < 1 or lens.max() > BLOCK_CHUNKS):
        raise ValueError("invalid WAH stream: fill length out of range")


def checked_stream(words: np.ndarray) -> np.ndarray:
    """ascontiguousarray(uint32) + validate_stream."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    validate_stream(words)
    return words


class WahCodec:
    """WAH codec on one torch device ("cuda", "cuda:1", "cpu", ...)."""

    def __init__(self, device):
        self.device = torch.device(device)

    def compress(self, data: np.ndarray) -> tuple[np.ndarray, PhaseTimings]:
        """Bitmap (uint32 array) -> (WAH stream, phase timings).

        Mirrors reference compress() (compress.cu:41-209).
        """
        data = np.ascontiguousarray(data, dtype=np.uint32)
        n = data.shape[0]
        if n == 0:
            return np.zeros(0, dtype=np.uint32), PhaseTimings()
        _check_size(n)
        nv = chunk_count(n)
        nb = -(-nv // BLOCK_CHUNKS)
        if n != nb * BLOCK_INTS:  # pad to whole blocks
            data = np.concatenate([data, np.zeros(nb * BLOCK_INTS - n, np.uint32)])

        t = PhaseTimer(self.device)
        t.start()
        dev = words_to_tensor(data, self.device)
        t.stop("to_device")

        t.start()
        words, total = encode_kernel.encode_padded(dev, nv)
        t.stop("kernel")

        t.start()
        out = tensor_to_words(words[: int(total)])
        t.stop("from_device")
        return out, t.timings

    def decompress(
        self, words: np.ndarray, out_ints: int | None = None
    ) -> tuple[np.ndarray, PhaseTimings]:
        """WAH stream -> (bitmap, phase timings).

        Default output length is ceil(31 * total_chunks / 32) words
        (reference: decompress.cu:82-92); pass `out_ints` to trim to the
        original un-padded length.
        """
        words = checked_stream(words)
        m = words.shape[0]
        if m == 0:
            return np.zeros(0, dtype=np.uint32), PhaseTimings()
        is_fill = (words & np.uint32(BIT31)) != 0
        n_chunks = int(np.where(is_fill, words & np.uint32(LEN_MASK), 1).sum())
        cap = max(1, -(-n_chunks // BLOCK_CHUNKS)) * BLOCK_CHUNKS
        M = -(-m // BLOCK_CHUNKS) * BLOCK_CHUNKS
        if M != m:
            words = np.concatenate([words, np.zeros(M - m, np.uint32)])

        t = PhaseTimer(self.device)
        t.start()
        dev = words_to_tensor(words, self.device)
        t.stop("to_device")

        t.start()
        ints, n_ints = decode_kernel.decode(dev, m, cap)
        t.stop("kernel")

        t.start()
        out = tensor_to_words(ints[: int(n_ints)])
        t.stop("from_device")
        if out_ints is not None:
            out = out[:out_ints]
        return out, t.timings


def compress(data: np.ndarray, device) -> tuple[np.ndarray, PhaseTimings]:
    return WahCodec(device).compress(data)


def decompress(
    words: np.ndarray, out_ints: int | None, device
) -> tuple[np.ndarray, PhaseTimings]:
    return WahCodec(device).decompress(words, out_ints=out_ints)
