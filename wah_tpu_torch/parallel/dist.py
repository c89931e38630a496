"""Sharded WAH codec on torch.distributed — the port of
wah_tpu/parallel/dist.py.

One rank runs per device, and the 1024-chunk block axis is split over the
ranks in rank order. Fill runs never cross a block (SURVEY.md section
0.1) and shard edges are block edges, so the concatenation of the ranks'
streams in rank order is the single-device stream, and no kernel is new:

  encode  rank r encodes its nb_l blocks from the global chunk
          r * nb_l * 1024 (K1 + K2 through encode_padded, whose bound is
          clamped to the call's own blocks); the (D,) word totals are
          gathered.
  stitch  stitch_global gathers each rank's first `eff` words and lays
          the (D, eff) payload into one dense stream with K2, row (d, j)
          of 1024 words going to rank d's offset + 1024 j; every rank
          holds the result. A word_cap bounds the payload (stitch_word_cap,
          estimate_word_cap), with the reference's overflow flag.
  decode  the stream is replicated; rank r expands chunks
          [r * chunks_l, (r + 1) * chunks_l): K3 + K4 over the whole
          blocks that cover the span, from their chunk base, cut to the
          span's ints.

encode_local and decode_local are the per-rank bodies and make no
collective call, so the bodies of D ranks can run one after another in
one process. Every other function takes a process group (None: the
default group, or a world of one when none is up); the gathers follow
_comm's rule: NCCL on the device, any other backend through host memory.
gather_stream and gather_bitmap give the exact host arrays on every rank.

Spans (utils.profiling, recorded only while a profiler records):
wah.sharded.encode, wah.sharded.word_cap, wah.sharded.stitch and
wah.sharded.decode around the calls of those names; the pipelines'
wah.encode and wah.decode and _comm's wah.gather nest inside them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..api import _check_size, _violation, checked_stream, resolve_device
from ..constants import BLOCK_CHUNKS, BLOCK_INTS
from ..convert import tensor_to_words, words_to_tensor
from ..golden import chunk_count
from ..ops.cuda import decode_kernel, encode_kernel, stitch2, stream_check
from ..utils.profiling import span
from ._comm import all_gather, rank_and_size
from .multihost import local_device

__all__ = [
    "encode_local",
    "encode_sharded",
    "stitch_global",
    "compact_payload",
    "stitch_word_cap",
    "estimate_word_cap",
    "gather_stream",
    "decode_local",
    "decode_sharded",
    "gather_bitmap",
    "ShardedCodec",
]

_I32 = torch.int32
_I64 = torch.int64


# --------------------------------------------------------------------------
# encode
# --------------------------------------------------------------------------

def encode_local(
    ints_l: torch.Tensor, n_valid_chunks: int, rank: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank `rank`'s encode of its (nb_l*992,) int32 blocks, the global
    blocks [rank*nb_l, (rank+1)*nb_l) of a bitmap whose first
    `n_valid_chunks` chunks are live -> (words_l (nb_l*1024,), total_l (1,))
    int32. words_l[:total_l] is this rank's part of the single-device
    stream; past it the words are unspecified. No collective."""
    nb_l = ints_l.shape[0] // BLOCK_INTS
    words_l, total = encode_kernel.encode_padded(
        ints_l, n_valid_chunks, rank * nb_l * BLOCK_CHUNKS, stitch="v3"
    )
    return words_l, total.reshape(1)


def encode_sharded(
    ints_l: torch.Tensor, n_valid_chunks: int, group=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Distributed encode: this rank's blocks -> (words_l (nb_l*1024,),
    totals (D,) int32), every rank holding the same block count. The pair
    is the distributed form of the stream (wah_tpu's encode_sharded);
    stitch_global or gather_stream assemble it."""
    with span("wah.sharded.encode"):
        rank, _ = rank_and_size(group)
        words_l, total_l = encode_local(ints_l, n_valid_chunks, rank)
        return words_l, all_gather(total_l, group).reshape(-1)


def stitch_global(
    words_l: torch.Tensor, totals, word_cap: int | None = None, group=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(words_l, totals) of encode_sharded -> (stream (D*eff,), total int32
    0-dim, overflow bool 0-dim), the same on every rank, with eff =
    min(word_cap, nb_l*1024) (the whole capacity without a word_cap).

    Only each rank's first eff words are gathered. overflow is True iff
    eff is below the capacity and some rank has more than eff live words;
    the stream is then truncated and the caller retries with a larger
    bound. total is always right (it comes from the totals), and the
    stream is zero past its live words. Its wah.sharded.stitch span
    counts the bytes of the gathered payload, D * eff words.
    """
    with span("wah.sharded.stitch") as s:
        dev = words_l.device
        totals = torch.as_tensor(totals).to(dev, _I32)
        D = totals.shape[0]
        if D != rank_and_size(group)[1]:
            raise ValueError(f"{D} totals for a world of {rank_and_size(group)[1]} ranks")
        cap_l = words_l.shape[0]
        eff = cap_l if word_cap is None else min(int(word_cap), cap_l)
        if eff < cap_l:
            overflow = totals.max() > eff
        else:
            overflow = torch.zeros((), dtype=torch.bool, device=dev)
        payload = all_gather(words_l[:eff], group)
        s.set(bytes=payload.numel() * payload.element_size())
        stream = compact_payload(payload, totals)
        return stream, totals.sum(dtype=_I32), overflow


def compact_payload(segs: torch.Tensor, totals: torch.Tensor) -> torch.Tensor:
    """The gathered (D, eff) payload, row d holding rank d's first eff
    words, -> the dense (D*eff,) stream of each rank's first
    min(totals[d], eff) words in rank order, zero past them: one K2
    launch. Each rank's eff words become whole 1024-word staging rows; row
    (d, j) moves its first min(live_d - 1024 j, 1024) words to
    offset_d + 1024 j."""
    D, eff = segs.shape
    rows = -(-eff // BLOCK_CHUNKS)
    staging = segs
    if rows * BLOCK_CHUNKS != eff:
        staging = segs.new_zeros((D, rows * BLOCK_CHUNKS))
        staging[:, :eff] = segs
    staging = staging.reshape(D * rows, BLOCK_CHUNKS)
    # clamped to the payload, so that an overflowed payload writes in bounds
    live = totals.to(_I64).clamp(max=eff)
    starts = torch.cumsum(live, 0) - live
    j = BLOCK_CHUNKS * torch.arange(rows, dtype=_I64, device=segs.device)
    counts = (live[:, None] - j).clamp(0, BLOCK_CHUNKS)
    end = live.sum()
    offsets = torch.minimum(starts[:, None] + j, end)  # empty rows sit at the end
    offsets_ext = torch.cat([offsets.reshape(-1), end.reshape(1)]).to(_I32)
    stream = stitch2.stitch_tiles_v2(staging, offsets_ext, counts.reshape(-1).to(_I32))
    stream = stream[: D * eff]
    stream[int(end) :] = 0  # K2 leaves the words past its total unspecified
    return stream


def stitch_word_cap(totals) -> int:
    """Exact payload bound from the per-rank totals (read on the host): the
    most live words of a rank, rounded up to a 1024-word tile."""
    with span("wah.sharded.word_cap"):
        if isinstance(totals, torch.Tensor):
            t = int(totals.max())
        else:
            t = int(np.max(np.asarray(totals)))
        return max(1024, -(-t // 1024) * 1024)


def estimate_word_cap(data: np.ndarray, nb_l: int) -> int:
    """Sample-based payload bound from the raw bitmap (host, no device
    sync), as wah_tpu's. Per 1024-chunk block, words = literals + fill
    runs and consecutive fill runs are separated by >= 1 literal, so
    words <= 2*literals + 1. The sampled nonzero-word fraction f
    approximates the non-zero-chunk fraction, giving the per-block
    estimate min(1024, 2048*f + 64) with margin for sampling noise. Not a
    hard guarantee (stitch_global's overflow flag covers the residual): a
    rank whose data is locally much denser than the global sample can
    exceed it."""
    step = max(1, data.shape[0] >> 16)
    sample = data[::step]
    f = np.count_nonzero(sample) / max(1, sample.shape[0])
    per_block = min(BLOCK_CHUNKS, int(2048 * f) + 64)
    return max(1024, -(-nb_l * per_block // 1024) * 1024)


def gather_stream(words_l: torch.Tensor, totals, group=None) -> np.ndarray:
    """The exact host stream on every rank, from the sharded (words_l,
    totals): a stitch_global bounded by stitch_word_cap, so that only the
    live words move."""
    stream, total, _ = stitch_global(words_l, totals, stitch_word_cap(totals), group)
    return tensor_to_words(stream[: int(total)])


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def decode_local(
    words: torch.Tensor, m: int, chunks_l: int, rank: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank `rank`'s decode of the chunk span [rank*chunks_l, (rank+1) *
    chunks_l) of the replicated stream words[:m] -> (ints_l
    (chunks_l//32*31,), n_chunks of the whole stream, int32 0-dim).
    chunks_l is a multiple of 32. No collective.

    K3 + K4 decode the whole blocks that cover the span, and the span's
    ints are cut out of them: a group of 32 chunks merges into 31 ints of
    its own, so a span that starts on a multiple of 32 chunks starts on
    an int of the block decode."""
    if chunks_l % 32:
        raise ValueError(f"chunks_l {chunks_l} is not a multiple of 32")
    base = rank * chunks_l
    b0 = base // BLOCK_CHUNKS * BLOCK_CHUNKS
    cap = -(-(base + chunks_l - b0) // BLOCK_CHUNKS) * BLOCK_CHUNKS
    ints, n_chunks = decode_kernel.decode_span(words, m, cap, b0)
    lo = (base - b0) // 32 * 31
    return ints[lo : lo + chunks_l // 32 * 31], n_chunks


def decode_sharded(
    words: torch.Tensor, m: int, chunk_capacity: int, group=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Distributed decode of the replicated stream words[:m]: this rank's
    span of chunk_capacity // D chunks -> (ints_l, n_chunks) as decode_local.
    chunk_capacity is a multiple of 32 * D."""
    with span("wah.sharded.decode"):
        rank, D = rank_and_size(group)
        if chunk_capacity % (32 * D):
            raise ValueError(f"chunk_capacity {chunk_capacity} is not a multiple of 32 x {D} ranks")
        return decode_local(words, m, chunk_capacity // D, rank)


def gather_bitmap(ints_l: torch.Tensor, n_ints: int, group=None) -> np.ndarray:
    """The exact host bitmap on every rank: the ranks' spans in rank order,
    cut to n_ints."""
    return tensor_to_words(all_gather(ints_l, group).reshape(-1)[:n_ints])


# --------------------------------------------------------------------------
# host-facing codec
# --------------------------------------------------------------------------

class ShardedCodec:
    """The host API over the sharded codec (wah_tpu's ShardedCodec, one
    rank a device): every rank passes the whole numpy input and gets the
    whole numpy output. `device` is this rank's device (None: this rank's
    card, multihost.local_device, as wah_tpu's mesh=None takes every
    chip); `group` the process group (None: the default one, or a world
    of one)."""

    def __init__(self, device=None, group=None):
        self.device = resolve_device("cuda" if device is None else device, "ShardedCodec")
        if device is None:
            self.device = local_device("cuda")
        self.group = group

    def compress(self, data: np.ndarray) -> np.ndarray:
        """Bitmap -> the WAH stream, equal to the single-device stream. The
        blocks are padded to a count divisible by the world size; this
        rank copies only its own blocks to its device."""
        data = np.ascontiguousarray(data, dtype=np.uint32)
        n = data.shape[0]
        if n == 0:
            return np.zeros(0, dtype=np.uint32)
        _check_size(n)  # on every rank, before any collective
        rank, D = rank_and_size(self.group)
        nv = chunk_count(n)
        nb = -(-nv // BLOCK_CHUNKS)
        nb_l = -(-nb // D)
        lo = rank * nb_l * BLOCK_INTS
        ints_l = words_to_tensor(data[lo : lo + nb_l * BLOCK_INTS], self.device,
                                 size=nb_l * BLOCK_INTS)
        words_l, totals = encode_sharded(ints_l, nv, self.group)
        del ints_l
        return gather_stream(words_l, totals, self.group)

    def decompress(self, words: np.ndarray, out_ints: int | None = None) -> np.ndarray:
        """WAH stream -> bitmap of ceil(31 n_chunks / 32) ints, or out_ints.
        Every rank copies the stream to its device and checks and counts it
        there with V1 before any collective, so a corrupt stream raises
        checked_stream's message on all of them and hangs none. The chunk
        capacity is a whole number of blocks a rank, so every rank's span
        runs K3 + K4."""
        words = np.ascontiguousarray(words, dtype=np.uint32)
        m = words.shape[0]
        if m == 0:
            return np.zeros(0, dtype=np.uint32)
        dev_words = words_to_tensor(words, self.device, size=-(-m // BLOCK_CHUNKS) * BLOCK_CHUNKS)
        first_bad, n_chunks = stream_check.check_stream(dev_words, m).tolist()
        if first_bad < m:  # the host check raises its message
            checked_stream(words)
            raise ValueError(_violation(int(words[first_bad])))
        _, D = rank_and_size(self.group)
        nb = -(-max(1, -(-n_chunks // BLOCK_CHUNKS)) // D) * D
        ints_l, _ = decode_sharded(dev_words, m, nb * BLOCK_CHUNKS, self.group)
        del dev_words
        out = gather_bitmap(ints_l, n_chunks - n_chunks // 32, self.group)
        return out if out_ints is None else out[:out_ints]
