"""numpy uint32 <-> torch int32 word tensors, and the copies between the
host and a CUDA device.

torch cannot shift uint32 tensors, so the port carries WAH words and
bitmap ints as int32 tensors holding the uint32 bit patterns. These two
functions are the only place the views change; the public API keeps
numpy uint32 in and out, like wah_tpu. words_to_tensor is also the one
place where words are padded for a device (its `size`): every entry
point copies its arrays as they are, and the padding is written on the
device.

On a CUDA device an array of STAGE_MIN_WORDS words or more moves through
a pinned staging ring that the module keeps, one per device: RING_BUFFERS
pinned buffers of CHUNK_WORDS words, each with the CUDA event of its last
copy. The array moves a chunk at a time, and the host copies one chunk
between the array and a buffer, on torch's intra-op threads, while the
card's copy engine moves another between a buffer and the device. A
chunk to the device is the head of a buffer, H2D_CHUNK_WORDS words, so
that the buffers the host writes stay in its cache; a chunk from the
device fills a buffer, since the host's copy of each chunk into the
fresh result ends when the slowest of its threads has taken its page
faults, and fewer, longer copies lose less to that wait. A shorter array
is copied directly from or into pageable memory, which the driver stages
through its own buffers. The ring is made at the first
staged copy on its device, never grows and lives as long as the process;
its lock gives it to one copy at a time. Every copy is issued on the
device's current stream, so what follows on that stream needs no other
synchronisation, and no view of a ring's buffer leaves this module.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["words_to_tensor", "tensor_to_words", "to_i32", "staged_chunks", "copies"]

# The ring's shape, its chunks and the size at which a copy takes it,
# measured on an H100 by `python3 chip_smoke.py --copies` and the
# benchmark's api cell (PERF.md).
CHUNK_WORDS = 32 << 20  # 128 MiB a buffer: a chunk from the device
H2D_CHUNK_WORDS = 8 << 20  # 32 MiB: a chunk to the device
RING_BUFFERS = 2
STAGE_MIN_WORDS = 1 << 20  # 4 MiB

# copies by route ("host": no CUDA device, "direct", "staged") and the
# chunks the staged ones moved
copies = {"host": 0, "direct": 0, "staged": 0, "chunks": 0}


class _Ring:
    """Staging buffers of equal length, each with the event of the last
    copy that used it (a host wait on it frees the buffer), and the lock
    that gives the ring to one copy at a time."""

    def __init__(self, bufs: list[torch.Tensor], events: list):
        self.bufs = bufs
        self.events = events
        self.lock = threading.Lock()


_rings: dict[int, _Ring] = {}
_rings_lock = threading.Lock()


def _ring(device: torch.device) -> _Ring:
    index = torch.cuda.current_device() if device.index is None else device.index
    with _rings_lock:
        if index not in _rings:
            with torch.cuda.device(index):
                _rings[index] = _Ring(
                    [torch.empty(CHUNK_WORDS, dtype=torch.int32, pin_memory=True)
                     for _ in range(RING_BUFFERS)],
                    [torch.cuda.Event() for _ in range(RING_BUFFERS)])
        return _rings[index]


def staged_chunks(n_words: int, device, to_device: bool) -> int:
    """Chunks a copy of `n_words` words to or from `device` moves through
    the ring; 0 where it is copied directly."""
    if torch.device(device).type != "cuda" or n_words < STAGE_MIN_WORDS:
        return 0
    return -(-n_words // (H2D_CHUNK_WORDS if to_device else CHUNK_WORDS))


def _stage_in(src: torch.Tensor, dst: torch.Tensor, ring: _Ring, stream, chunk: int) -> None:
    """Host `src` -> device `dst` (1-D, equal lengths) through `ring`, in
    chunks of `chunk` words (at most a buffer): the host fills one buffer
    while the copy engine reads the one before."""
    depth = len(ring.bufs)
    n = src.shape[0]
    for i, lo in enumerate(range(0, n, chunk)):
        hi = min(lo + chunk, n)
        buf, done = ring.bufs[i % depth][: hi - lo], ring.events[i % depth]
        done.synchronize()  # the copy engine has read the buffer's last chunk
        buf.copy_(src[lo:hi])
        dst[lo:hi].copy_(buf, non_blocking=True)
        done.record(stream)


def _stage_out(src: torch.Tensor, dst: torch.Tensor, ring: _Ring, stream) -> None:
    """Device `src` -> host `dst` (1-D, equal lengths) through `ring`, a
    buffer a chunk: up to one chunk a buffer in flight, and the host empties
    each buffer in turn, then refills it with the next chunk the ring has
    no room for yet."""
    chunk, depth = ring.bufs[0].shape[0], len(ring.bufs)
    n = src.shape[0]
    los = range(0, n, chunk)

    def issue(i: int) -> None:
        lo, j = los[i], i % depth
        hi = min(lo + chunk, n)
        ring.events[j].synchronize()  # the host has read the buffer's last chunk
        ring.bufs[j][: hi - lo].copy_(src[lo:hi], non_blocking=True)
        ring.events[j].record(stream)

    for i in range(min(depth, len(los))):
        issue(i)
    for i, lo in enumerate(los):
        hi, j = min(lo + chunk, n), i % depth
        ring.events[j].synchronize()
        dst[lo:hi].copy_(ring.bufs[j][: hi - lo])
        if i + depth < len(los):
            issue(i + depth)


def words_to_tensor(words: np.ndarray, device, size: int | None = None) -> torch.Tensor:
    """(n,) numpy uint32 -> (n,) int32 tensor on `device`, same bits. On the
    CPU the tensor shares a writable array's memory. With `size` (>= n) the
    tensor has `size` words: the n words are copied into the head of a
    fresh tensor, and its tail is zeroed on `device`. To a CUDA device,
    through the pinned ring from STAGE_MIN_WORDS words on, else directly;
    either way on the device's current stream, and the array may change
    once the call returns.

    Rows (C, n) -> (C, n), or (C, size) with `size`: the C*n words cross as
    they are, by the route above, and are widened on `device`, each row
    zeroed past its n words. This is the one rule of the port for putting
    host words on a device: callers never pad on the host."""
    words = np.require(words, dtype=np.uint32, requirements=["C", "W"])
    if words.ndim == 2:
        C, n = words.shape
        rows = words_to_tensor(words.reshape(-1), device).view(C, n)
        if size is None or size == n:
            return rows
        out = torch.empty((C, size), dtype=torch.int32, device=rows.device)
        out[:, n:].zero_()
        out[:, :n].copy_(rows)
        return out
    host = torch.from_numpy(words.view(np.int32))
    n = host.shape[0]
    device = torch.device(device)
    chunks = staged_chunks(n, device, to_device=True)
    if not chunks:
        copies["direct" if device.type == "cuda" else "host"] += 1
        if size is None:
            return host.to(device)
        out = torch.empty(size, dtype=torch.int32, device=device)
        out[n:].zero_()
        out[:n].copy_(host)
        return out
    out = torch.empty(n if size is None else size, dtype=torch.int32, device=device)
    out[n:].zero_()
    ring = _ring(out.device)
    with ring.lock:
        _stage_in(host, out[:n], ring, torch.cuda.current_stream(out.device), H2D_CHUNK_WORDS)
        copies["staged"] += 1
        copies["chunks"] += chunks
    return out


def tensor_to_words(t: torch.Tensor) -> np.ndarray:
    """int32 tensor (any device) -> numpy uint32 array of its shape, same
    bits. On the CPU the array shares the tensor's memory. From a CUDA
    device it is a fresh array the caller owns, copied through the pinned
    ring from STAGE_MIN_WORDS words on, else directly; either way after
    what the device's current stream was given before."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected an int32 tensor, got {t.dtype}")
    chunks = staged_chunks(t.numel(), t.device, to_device=False)
    if not chunks:
        copies["direct" if t.is_cuda else "host"] += 1
        return t.cpu().numpy().view(np.uint32)
    out = np.empty(t.shape, np.uint32)
    ring = _ring(t.device)
    with ring.lock:
        _stage_out(t.contiguous().view(-1), torch.from_numpy(out.view(np.int32)).view(-1),
                   ring, torch.cuda.current_stream(t.device))
        copies["staged"] += 1
        copies["chunks"] += chunks
    return out


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an integer tensor as an int32 bit pattern (wraps
    explicitly instead of relying on the cast's overflow behaviour)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)
