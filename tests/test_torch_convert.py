"""convert's copies on the CPU.

The chunk loops of the pinned staging ring (_stage_in, _stage_out) run
here with an unpinned stand-in ring of a few words a buffer and events
that only log what the loops ask of them, chunks to the device the head
of a buffer or the whole of it: at the edge lengths of a chunk they give
the direct copy's words, and no buffer is written before the event of
its last copy was waited for. words_to_tensor and tensor_to_words run
their staged route on the stand-in too (the `size=` tail, a 2-D
non-contiguous tensor, results that never alias the ring). Rows (C, n)
go to (C, W) by either route: the words exact, every row zeroed past n.
The routes
themselves: the CPU keeps its zero-copy path at any size, and
staged_chunks takes the ring on a CUDA device from STAGE_MIN_WORDS words.
The same copies on the card are in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from wah_tpu_torch import convert
from wah_tpu_torch.convert import staged_chunks, tensor_to_words, words_to_tensor

CHUNK, H2D_CHUNK = 5, 3  # the stand-in ring's buffers, and its chunks to the device


class _LogEvent:
    """A stand-in for a buffer's CUDA event: records and waits, logged."""

    def __init__(self, log: list, j: int):
        self.log, self.j = log, j

    def record(self, stream=None) -> None:
        self.log.append(("record", self.j))

    def synchronize(self) -> None:
        self.log.append(("wait", self.j))


def _stand_in(depth: int, log: list) -> convert._Ring:
    return convert._Ring([torch.full((CHUNK,), -7, dtype=torch.int32) for _ in range(depth)],
                         [_LogEvent(log, j) for j in range(depth)])


def _lengths(chunk: int, depth: int) -> list[int]:
    """Empty, one word, a chunk and a ring's worth of chunks either side,
    many rounds."""
    ring = depth * chunk
    return [0, 1, chunk - 1, chunk, chunk + 1, ring - 1, ring, ring + 1, 7 * ring + 3]


def _words(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 1 << 32, size=n, dtype=np.uint32)


def _waited_before_reuse(log: list) -> bool:
    """Every buffer's copy is recorded only after the copy before it on
    that buffer was waited for."""
    pending = set()
    for what, j in log:
        if what == "record":
            if j in pending:
                return False
            pending.add(j)
        else:
            pending.discard(j)
    return True


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("direction", ["in", "in_whole_buffers", "out"])
@pytest.mark.parametrize("at", range(9))
def test_the_chunk_loops_give_the_direct_copys_words(direction, depth, at):
    chunk = H2D_CHUNK if direction == "in" else CHUNK
    n = _lengths(chunk, depth)[at]
    words = _words(n, seed=n)
    src = torch.from_numpy(words.view(np.int32))
    dst = torch.full((n,), -1, dtype=torch.int32)
    log = []
    if direction == "out":
        convert._stage_out(src, dst, _stand_in(depth, log), None)
    else:
        convert._stage_in(src, dst, _stand_in(depth, log), None, chunk)
    np.testing.assert_array_equal(dst.numpy().view(np.uint32), words)
    assert sum(what == "record" for what, _ in log) == -(-n // chunk)
    assert _waited_before_reuse(log)
    if direction == "out":  # the host read every buffer it filled
        last = {j: what for what, j in log}
        assert all(what == "wait" for what in last.values())


@pytest.fixture
def staged(monkeypatch):
    """words_to_tensor and tensor_to_words on the CPU take their staged
    route through a stand-in ring of 3 x CHUNK words; yields the ring."""
    ring = _stand_in(3, [])
    monkeypatch.setattr(convert, "H2D_CHUNK_WORDS", H2D_CHUNK)
    monkeypatch.setattr(convert, "staged_chunks", lambda n, device, to_device: (
        -(-n // (H2D_CHUNK if to_device else CHUNK)) if n else 0))
    monkeypatch.setattr(convert, "_ring", lambda device: ring)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(convert, "copies", dict.fromkeys(convert.copies, 0))
    return ring


@pytest.mark.parametrize("n", [1, CHUNK, 3 * CHUNK + 1, 10 * CHUNK + 2])
@pytest.mark.parametrize("extra", [None, 0, 1, 2 * CHUNK + 3])
def test_the_staged_route_round_trips(staged, n, extra):
    words = _words(n, seed=100 + n)
    size = None if extra is None else n + extra
    t = words_to_tensor(words, "cpu", size=size)
    assert t.dtype == torch.int32 and t.shape == (n if size is None else size,)
    assert not np.shares_memory(t.numpy(), words)
    assert not t[n:].any()  # the tail is zeroed
    back = tensor_to_words(t[:n])
    np.testing.assert_array_equal(back, words)
    assert back.flags.owndata and back.flags.writeable
    chunks = -(-n // H2D_CHUNK) + -(-n // CHUNK)
    assert convert.copies == {"host": 0, "direct": 0, "staged": 2, "chunks": chunks}


def test_staged_results_keep_their_words_and_never_alias_the_ring(staged):
    a, b = _words(4 * CHUNK + 1, seed=1), _words(4 * CHUNK + 1, seed=2)
    got_a = tensor_to_words(words_to_tensor(a, "cpu"))
    got_b = tensor_to_words(words_to_tensor(b, "cpu"))
    np.testing.assert_array_equal(got_a, a)
    np.testing.assert_array_equal(got_b, b)
    for buf in staged.bufs:
        assert not np.shares_memory(got_a, buf.numpy())
        assert not np.shares_memory(got_b, buf.numpy())


def test_the_staged_route_copies_a_non_contiguous_tensor_in_its_shape(staged):
    rows = torch.from_numpy(_words(6 * 8, seed=3).view(np.int32)).view(6, 8)
    got = tensor_to_words(rows[:, 1:6])
    assert got.shape == (6, 5)
    np.testing.assert_array_equal(got, rows[:, 1:6].numpy().view(np.uint32))


@pytest.mark.parametrize("route", ["host", "staged"])
@pytest.mark.parametrize("C", [1, 5])
@pytest.mark.parametrize("wider", [False, True])
@pytest.mark.parametrize("n", [0, 1, 991, 992, 993])
def test_rows_are_copied_as_they_are_and_widened_on_the_device(request, route, C, wider, n):
    """(C, n) -> (C, W), W = n or the next whole block of 992 ints: the C*n
    words cross as they are, in one copy, and each row is zero past n."""
    ring = request.getfixturevalue("staged") if route == "staged" else None
    W = (n // 992 + 1) * 992 if wider else n
    rows = _words(C * n, seed=200 + n).reshape(C, n)
    t = words_to_tensor(rows, "cpu", size=W if wider else None)
    assert t.dtype == torch.int32 and t.shape == (C, W)
    got = t.numpy().view(np.uint32)
    np.testing.assert_array_equal(got[:, :n], rows)
    assert not got[:, n:].any()
    if ring is not None:
        assert convert.copies["staged"] == (1 if n else 0)
        assert convert.copies["chunks"] == -(-C * n // H2D_CHUNK)
        for buf in ring.bufs:
            assert not np.shares_memory(got, buf.numpy())
    elif n and not wider:
        assert t.data_ptr() == rows.ctypes.data  # the CPU keeps its zero-copy view


@pytest.mark.parametrize("n", [0, 1, convert.STAGE_MIN_WORDS + 1])
def test_the_cpu_route_stays_zero_copy_at_any_size(n, monkeypatch):
    monkeypatch.setattr(convert, "copies", dict.fromkeys(convert.copies, 0))
    rings = dict(convert._rings)
    words = _words(n, seed=4)
    t = words_to_tensor(words, "cpu")
    assert n == 0 or t.data_ptr() == words.ctypes.data  # shares the writable array
    back = tensor_to_words(t)
    assert n == 0 or back.ctypes.data == words.ctypes.data
    sized = words_to_tensor(words, "cpu", size=n + 3)
    np.testing.assert_array_equal(tensor_to_words(sized[:n]), words)
    assert not sized[n:].any()
    assert convert.copies == {"host": 4, "direct": 0, "staged": 0, "chunks": 0}
    assert convert._rings == rings  # no ring made


@pytest.mark.parametrize("to_device", [True, False])
def test_staged_chunks_takes_the_ring_only_on_cuda_from_the_threshold(to_device):
    C, H, T = convert.CHUNK_WORDS, convert.H2D_CHUNK_WORDS, convert.STAGE_MIN_WORDS
    assert 0 < T <= H <= C
    chunk = H if to_device else C
    cuda = torch.device("cuda", 0)
    for n in (0, 1, T - 1, T, T + 1, H - 1, H, H + 1, C - 1, C, C + 1,
              convert.RING_BUFFERS * C + 1):
        assert staged_chunks(n, "cpu", to_device) == 0
        assert staged_chunks(n, cuda, to_device) == (0 if n < T else -(-n // chunk))
    assert staged_chunks(chunk + 1, "cuda", to_device) == 2
