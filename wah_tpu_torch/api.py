"""Host-facing codec API — the torch port of wah_tpu.api: the single-stream
entry points compress() / decompress() (reference: compress.h:12-18,
decompress.h:11-17) with their three phase timings per direction, the
batched columns of a bitmap index (compress_batch / decompress_batch),
bitmaps and columns of any size as block-aligned segments
(compress_segments / decompress_segments and their _batch_ forms), and
the compressed-domain logical ops (logical / logical_many).

numpy uint32 in, numpy uint32 out, as in wah_tpu. On a CUDA device the
kernels K1-K4 and V1 (the stream check) run (ops/cuda); on the CPU
their plain versions. Every entry point copies its arrays to the device
as they are, through convert.words_to_tensor, which writes the padding
on the device; every decompress checks and counts its streams there
with V1 (wah_tpu validates and counts on the host).
Like wah_tpu's, every entry point runs on the accelerator unless asked
otherwise: the device defaults to "cuda", and without a CUDA device
that default raises (resolve_device) instead of running on the CPU;
pass device="cpu" for the plain versions.
Differences from wah_tpu by design: single streams get no power-of-two
shape buckets (they exist for jit-cache reuse, which PyTorch has no use
for; batched columns keep a power-of-two width, which the kernels'
per-column position mask needs), and there are no TPU variant hints (a
kernel that writes each word to its slot has no pass count to choose);
the streams are identical either way.
"""
from __future__ import annotations

import numpy as np
import torch

from . import native
from .constants import BIT31, BLOCK_CHUNKS, BLOCK_INTS, LEN_MASK, ONES31
from .convert import staged_chunks, tensor_to_words, words_to_tensor
from .golden import chunk_count
from .ops import logical as _lops
from .ops.cuda import decode_kernel, encode_kernel, stream_check
from .utils.profiling import span
from .utils.timing import PhaseTimer, PhaseTimings

__all__ = [
    "WahCodec", "compress", "decompress", "validate_stream", "checked_stream", "stream_chunks",
    "resolve_device",
]

# Chunk positions are int32 in the kernels: one bitmap is capped at
# 2^31 - 1 chunks (~8.3 GB).
MAX_INTS_PER_BITMAP = (((1 << 31) - 1) * 31) // 32


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _check_size(n: int) -> None:
    if n > MAX_INTS_PER_BITMAP:
        raise ValueError(
            f"bitmap of {n} ints exceeds the 2^31-1 chunk (~8.3 GB) "
            "int32 position limit; split into columns or segments"
        )


# _segment_edges walks a stream in pieces of this many words (its int64
# temporaries are 8 B a word)
_EDGE_PIECE = 1 << 24


def _check_segment_ints(segment_ints: int) -> None:
    if segment_ints <= 0 or segment_ints % BLOCK_INTS:
        raise ValueError(f"segment_ints must be a positive multiple of {BLOCK_INTS}, got {segment_ints}")
    _check_size(segment_ints)


_LITERAL_FILL = "invalid WAH stream: contains literal-fill word"
_FILL_LENGTH = "invalid WAH stream: fill length out of range"


def validate_stream(words: np.ndarray) -> None:
    """Check a WAH stream against the format invariants (SURVEY.md section
    0.1): no 0x0/0x7FFFFFFF words, fill lengths in [1, 1024]. The
    reference decoder checks nothing (decompress.cu:48-52); every
    decompress here checks first, with V1 on the device copy
    (ops/cuda/stream_check). This host pass runs only where a stream
    failed that check, to raise wah_tpu's message (decompress_batch), and
    where the C++ host codec is not built (checked_stream)."""
    words = np.asarray(words, dtype=np.uint32)
    if np.any(words == 0) or np.any(words == ONES31):
        raise ValueError(_LITERAL_FILL)
    fills = words[(words & np.uint32(BIT31)) != 0]
    lens = fills & np.uint32(LEN_MASK)
    if fills.size and (lens.min() < 1 or lens.max() > BLOCK_CHUNKS):
        raise ValueError(_FILL_LENGTH)


def _violation(word: int) -> str:
    """The message checked_stream gives for a stream whose first word that
    breaks the format is `word` (native.validate reports the first)."""
    return _LITERAL_FILL if word in (0, ONES31) else _FILL_LENGTH


def checked_stream(words: np.ndarray) -> np.ndarray:
    """ascontiguousarray(uint32) + validation: the C++ host codec's check
    when it is built (native.validate, the same messages), validate_stream
    otherwise (wah_tpu.api.checked_stream). On a good stream it serves the
    CLI's `info` alone; ShardedCodec.decompress calls it only for the
    message of a stream that V1 found bad."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    if native.available():
        native.validate(words)
    else:
        validate_stream(words)
    return words


def stream_chunks(words: np.ndarray) -> int:
    """The number of chunks a validated stream expands to: fills count
    their run length, literals 1 (native.decoded_chunks when the host codec
    is built, numpy otherwise). The CLI's `info` alone uses it: the
    decoders count on the device with V1."""
    if native.available():
        return native.decoded_chunks(words)
    is_fill = (words & np.uint32(BIT31)) != 0
    return int(np.where(is_fill, words & np.uint32(LEN_MASK), 1).sum(dtype=np.int64))


def resolve_device(device, who: str) -> torch.device:
    """torch.device(device), raising RuntimeError for a CUDA device when
    there is none: the port never falls back to the CPU by itself."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f'{who}: no CUDA device (pass device="cpu" for the plain versions)')
    return device


class WahCodec:
    """WAH codec on one torch device ("cuda", the default, "cuda:1",
    "cpu", ...)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device, "WahCodec")

    def compress(self, data: np.ndarray) -> tuple[np.ndarray, PhaseTimings]:
        """Bitmap (uint32 array) -> (WAH stream, phase timings).

        Mirrors reference compress() (compress.cu:41-209).
        """
        with span("wah.compress"):
            data = np.ascontiguousarray(data, dtype=np.uint32)
            n = data.shape[0]
            if n == 0:
                return np.zeros(0, dtype=np.uint32), PhaseTimings()
            _check_size(n)
            nv = chunk_count(n)
            nb = -(-nv // BLOCK_CHUNKS)

            # the bitmap as it is, into a device buffer of whole blocks
            t = PhaseTimer(self.device, span="wah.compress")
            t.start("to_device", bytes=data.nbytes,
                    staged_chunks=staged_chunks(n, self.device, to_device=True))
            dev = words_to_tensor(data, self.device, size=nb * BLOCK_INTS)
            t.stop("to_device")

            t.start("kernel")
            words, total = encode_kernel.encode_padded(dev, nv, stitch="v3")
            t.stop("kernel")

            t.start("from_device")
            out = tensor_to_words(words[: int(total)])
            t.stop("from_device", bytes=out.nbytes,
                   staged_chunks=staged_chunks(out.size, self.device, to_device=False))
            return out, t.timings

    def decompress(
        self, words: np.ndarray, out_ints: int | None = None
    ) -> tuple[np.ndarray, PhaseTimings]:
        """WAH stream -> (bitmap, phase timings).

        Default output length is ceil(31 * total_chunks / 32) words
        (reference: decompress.cu:82-92); pass `out_ints` to trim to the
        original un-padded length.
        """
        with span("wah.decompress"):
            words = np.ascontiguousarray(words, dtype=np.uint32)
            m = words.shape[0]
            if m == 0:
                return np.zeros(0, dtype=np.uint32), PhaseTimings()

            # the stream as it is, into a device buffer of whole blocks
            t = PhaseTimer(self.device, span="wah.decompress")
            t.start("to_device", bytes=words.nbytes,
                    staged_chunks=staged_chunks(m, self.device, to_device=True))
            dev = words_to_tensor(words, self.device, size=-(-m // BLOCK_CHUNKS) * BLOCK_CHUNKS)
            t.stop("to_device")

            # checked and counted on the device, in one pass over the copy
            with span("wah.decompress.validate", bytes=words.nbytes):
                first_bad, n_chunks = stream_check.check_stream(dev, m).tolist()
            if first_bad < m:
                raise ValueError(_violation(int(words[first_bad])))
            cap = max(1, -(-n_chunks // BLOCK_CHUNKS)) * BLOCK_CHUNKS

            t.start("kernel")
            ints, n_ints = decode_kernel.decode(dev, m, cap)
            t.stop("kernel")

            t.start("from_device")
            out = tensor_to_words(ints[: int(n_ints)])
            t.stop("from_device", bytes=out.nbytes,
                   staged_chunks=staged_chunks(out.size, self.device, to_device=False))
            if out_ints is not None:
                out = out[:out_ints]
            return out, t.timings

    # -- batched columns (bitmap-index workload) ---------------------------
    def compress_batch(self, data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Compress C equal-length bitmap columns at once.

        data: (C, n) uint32. Returns (words (C, W), totals (C,)): column
        c's stream is words[c, :totals[c]], the stream compress() gives
        for that column alone; words past it are unspecified. W is the
        longest total (wah_tpu returns the whole capacity instead).
        Mirrors wah_tpu WahCodec.compress_batch (api.py:266-319): columns
        padded to a power-of-two block count, one batched encode. The
        columns cross as they are and are padded on the device.
        """
        data = np.ascontiguousarray(data, dtype=np.uint32)
        C, n = data.shape
        if n == 0:
            return np.zeros((C, 0), np.uint32), np.zeros((C,), np.int64)
        _check_size(n)
        nv = chunk_count(n)
        nb = _next_pow2(-(-nv // BLOCK_CHUNKS))
        rows = words_to_tensor(data, self.device, size=nb * BLOCK_INTS).view(C * nb, BLOCK_INTS)
        words, totals = encode_kernel.encode_rows_batch(rows, C, nv)
        totals = totals.cpu().numpy().astype(np.int64)  # the one host read
        width = int(totals.max())
        return tensor_to_words(words.view(C, -1)[:, :width]), totals

    def decompress_batch(
        self, words: np.ndarray, totals: np.ndarray, out_ints: int | None = None
    ) -> np.ndarray:
        """Inverse of compress_batch: (words (C, M), totals (C,)) ->
        bitmaps (C, out_ints), by default (C, cap//32*31) with cap the
        power-of-two chunk capacity of the longest column.

        Columns that expand equally (every compress_batch output) go
        through one batched decode; otherwise each column goes through the
        single-stream decode (wah_tpu sends those to its XLA path). The
        columns cross once, as they are, into device rows of whole blocks,
        and V1 checks and counts each row there; a bad stream raises
        wah_tpu's message (validate_stream over the live words).
        """
        words = np.ascontiguousarray(words, dtype=np.uint32)
        totals = np.asarray(totals)
        C, M = words.shape
        if M == 0:
            return np.zeros((C, 0), np.uint32)
        dev = words_to_tensor(words, self.device, size=-(-M // BLOCK_CHUNKS) * BLOCK_CHUNKS)
        checks = [stream_check.check_stream(dev[c], int(totals[c])) for c in range(C)]
        first_bad, col_chunks = torch.stack(checks).cpu().numpy().T  # the one host read
        if (first_bad < totals).any():
            validate_stream(words[np.arange(M)[None, :] < totals[:, None]])
            raise ValueError(_LITERAL_FILL)  # V1 read the zero padding: a total past the words
        n_chunks = int(col_chunks.max())
        cap = _next_pow2(max(1, -(-n_chunks // BLOCK_CHUNKS))) * BLOCK_CHUNKS
        if (col_chunks == col_chunks[0]).all():
            ms = torch.from_numpy(totals.astype(np.int32)).to(self.device)
            flat = decode_kernel.decode_rows_batch(dev.reshape(-1), C, ms, cap)
            out = tensor_to_words(flat).reshape(C, -1)
        else:
            out = np.stack([
                tensor_to_words(decode_kernel.decode(dev[c], int(totals[c]), cap)[0])
                for c in range(C)
            ])
        if out_ints is not None:
            out = out[:, :out_ints]
        return out

    # -- bitmaps of any size, as block-aligned segments ---------------------
    def compress_segments(
        self, data: np.ndarray, segment_ints: int = BLOCK_INTS << 18
    ) -> np.ndarray:
        """Compress a bitmap of any size as block-aligned segments.

        The int32 chunk positions cap one compress() call at ~8.3 GB
        (_check_size). Segments that are multiples of 992 ints start at
        1024-chunk block boundaries, and fill runs never cross those
        (SURVEY.md section 0.1), so the concatenated per-segment streams
        are the whole bitmap's stream, equal to a single golden encode.
        """
        data = np.ascontiguousarray(data, dtype=np.uint32)
        _check_segment_ints(segment_ints)
        if data.shape[0] <= segment_ints:
            return self.compress(data)[0]
        return np.concatenate([
            self.compress(data[i : i + segment_ints])[0]
            for i in range(0, data.shape[0], segment_ints)
        ])

    def decompress_segments(
        self, words: np.ndarray, out_ints: int, segment_ints: int = BLOCK_INTS << 18
    ) -> np.ndarray:
        """Inverse of compress_segments for streams of any size: split the
        stream at the words that end each segment (exact: segment edges
        are block edges, so no fill crosses them), decode each segment on
        its own, concatenate. Each segment is validated as it is decoded."""
        words = np.ascontiguousarray(words, dtype=np.uint32)
        _check_segment_ints(segment_ints)
        if out_ints <= segment_ints:
            return self.decompress(words, out_ints=out_ints)[0]
        bounds = self._segment_edges(words, out_ints, segment_ints)
        out = np.empty(out_ints, np.uint32)
        for s in range(len(bounds) - 1):
            lo = s * segment_ints
            ni = min(segment_ints, out_ints - lo)
            out[lo : lo + ni] = self.decompress(words[bounds[s] : bounds[s + 1]], out_ints=ni)[0]
        return out

    def compress_batch_segments(
        self, data: np.ndarray, segment_ints: int = BLOCK_INTS << 13
    ) -> list[np.ndarray]:
        """Batched columns of any length: (C, n) -> C per-column streams,
        each equal to compress_segments / the golden model of that column
        (BASELINE.json configs[3] is 256 columns x 1 Gbit, past the
        position cap of one batched call). Each segment is one
        compress_batch over all C columns."""
        data = np.ascontiguousarray(data, dtype=np.uint32)
        _check_segment_ints(segment_ints)
        C, n = data.shape
        parts: list[list[np.ndarray]] = [[] for _ in range(C)]
        for lo in range(0, max(n, 1), segment_ints):
            words, totals = self.compress_batch(data[:, lo : lo + segment_ints])
            for c in range(C):
                parts[c].append(words[c, : totals[c]])
        return [np.concatenate(p) for p in parts]

    @staticmethod
    def _segment_edges(words: np.ndarray, out_ints: int, segment_ints: int) -> list[int]:
        """Word boundaries that split a stream at block-aligned segment
        edges (exact: no fill crosses them): [0, end of segment 0, ...,
        len(words)]. Shared by the single-stream and batched decoders.

        wah_tpu builds an int64 chunk count and its cumsum over the whole
        stream; here the stream is walked in pieces with a running carry,
        which finds the same edges in bounded memory."""
        seg_chunks = (segment_ints // BLOCK_INTS) * BLOCK_CHUNKS
        n_segs = -(-out_ints // segment_ints)
        edges_c = np.arange(1, n_segs, dtype=np.int64) * seg_chunks
        edges_w = np.empty(n_segs - 1, np.int64)
        carry = found = 0
        for lo in range(0, words.shape[0], _EDGE_PIECE):
            piece = words[lo : lo + _EDGE_PIECE]
            is_fill = (piece & np.uint32(BIT31)) != 0
            ccum = np.cumsum(np.where(is_fill, piece & np.uint32(LEN_MASK), 1), dtype=np.int64)
            ccum += carry
            carry = int(ccum[-1])
            upto = int(np.searchsorted(edges_c, carry, side="right"))
            at = np.searchsorted(ccum, edges_c[found:upto], side="left")
            if not np.array_equal(ccum[at], edges_c[found:upto]):
                break
            edges_w[found:upto] = lo + at + 1
            found = upto
        if found != n_segs - 1:
            raise ValueError(
                "stream does not split at block-aligned segment edges "
                "(wrong segment_ints, or not a WAH stream)"
            )
        return [0, *edges_w.tolist(), words.shape[0]]

    def decompress_batch_segments(
        self, streams: list[np.ndarray], out_ints: int, segment_ints: int = BLOCK_INTS << 13
    ) -> np.ndarray:
        """Inverse of compress_batch_segments: C per-column streams ->
        (C, out_ints) bitmaps, segment by segment (each segment is one
        decompress_batch; its columns expand equally because they share
        the segment length)."""
        _check_segment_ints(segment_ints)
        streams = [np.ascontiguousarray(s, dtype=np.uint32) for s in streams]
        C = len(streams)
        if out_ints <= segment_ints:
            bounds = [[0, len(s)] for s in streams]
        else:
            bounds = [self._segment_edges(s, out_ints, segment_ints) for s in streams]
        out = np.empty((C, out_ints), np.uint32)
        for s in range(len(bounds[0]) - 1):
            segs = [streams[c][bounds[c][s] : bounds[c][s + 1]] for c in range(C)]
            totals = np.array([len(x) for x in segs], np.int64)
            w2 = np.zeros((C, int(totals.max())), np.uint32)
            for c, x in enumerate(segs):
                w2[c, : len(x)] = x
            lo = s * segment_ints
            ni = min(segment_ints, out_ints - lo)
            out[:, lo : lo + ni] = self.decompress_batch(w2, totals, out_ints=ni)
        return out

    # -- compressed-domain logical ops (bitmap-index queries) --------------
    def logical(
        self, stream_a: np.ndarray, stream_b: np.ndarray, op: str, n_ints: int
    ) -> np.ndarray:
        """A op B on compressed streams of equal logical length n_ints
        (op: and/or/xor/andnot): decode both, combine, re-encode, on the
        device. Returns the compressed result."""
        if n_ints == 0:
            return np.zeros(0, np.uint32)
        a = np.ascontiguousarray(stream_a, dtype=np.uint32)
        b = np.ascontiguousarray(stream_b, dtype=np.uint32)
        M = max(-(-max(len(a), len(b)) // BLOCK_CHUNKS), 1) * BLOCK_CHUNKS
        words, total = _lops.logical_op(
            words_to_tensor(a, self.device, size=M), len(a),
            words_to_tensor(b, self.device, size=M), len(b), op, n_ints,
        )
        return tensor_to_words(words[: int(total)])

    def logical_many(self, streams, op: str, n_ints: int) -> np.ndarray:
        """Fold k compressed streams of logical length n_ints with an
        associative op (or/and/xor) in one pipeline: one batched decode,
        a tree reduce, one encode. Returns the compressed result."""
        streams = [np.ascontiguousarray(s, dtype=np.uint32) for s in streams]
        if not streams:
            raise ValueError("empty stream set")
        if len(streams) == 1:
            return streams[0].copy()
        if n_ints == 0:
            return np.zeros(0, np.uint32)
        C = len(streams)
        M = max(-(-max(len(s) for s in streams) // BLOCK_CHUNKS), 1) * BLOCK_CHUNKS
        rows = torch.stack([words_to_tensor(s, self.device, size=M) for s in streams])
        ms = torch.tensor([len(s) for s in streams], dtype=torch.int32, device=self.device)
        words, total = _lops.logical_reduce_flat(rows.reshape(-1), C, ms, op, n_ints)
        return tensor_to_words(words[: int(total)])


def compress(data: np.ndarray, device="cuda") -> tuple[np.ndarray, PhaseTimings]:
    return WahCodec(device).compress(data)


def decompress(
    words: np.ndarray, out_ints: int | None = None, device="cuda"
) -> tuple[np.ndarray, PhaseTimings]:
    return WahCodec(device).decompress(words, out_ints=out_ints)
