"""The yardstick on the CPU: the reference codec against hand-counted
streams, the roofline byte counts, and the trace arithmetic against a
canned Chrome trace."""
import json

import numpy as np
import pytest

from gpubench import activity, rooflines
from gpubench.reference import control, wah

# one group of 31 words = 32 chunks; a block = 1024 chunks = 992 words
ZERO_FILL, ONE_FILL = 0x80000000, 0xC0000000


def test_all_zero_block_is_one_fill():
    assert wah.encode(np.zeros(992, np.uint32)).tolist() == [ZERO_FILL | 1024]


def test_fills_stop_at_block_edges():
    ones = np.full(2 * 992, 0xFFFFFFFF, np.uint32)
    assert wah.encode(ones).tolist() == [ONE_FILL | 1024, ONE_FILL | 1024]


def test_literals_and_a_partial_group():
    # bit 0 set: chunk 0 is the literal 1, then 31 zero chunks of the group
    x = np.zeros(31, np.uint32)
    x[0] = 1
    assert wah.encode(x).tolist() == [1, ZERO_FILL | 31]
    # one word pads to a group of 31: 32 chunks; bit 31 is bit 0 of chunk 1
    assert wah.encode(np.array([0x80000000], np.uint32)).tolist() == [
        ZERO_FILL | 1, 1, ZERO_FILL | 30]


def test_chunks_cross_word_edges():
    # chunk 1 holds bits 31..61: bit 31 of word 0 and bits 0..29 of word 1
    x = np.zeros(31, np.uint32)
    x[0], x[1] = 0x80000000, 0x3FFFFFFF
    assert wah.chunks_of(x)[:3].tolist() == [0, 0x7FFFFFFF, 0]
    assert wah.encode(x).tolist() == [ZERO_FILL | 1, ONE_FILL | 1, ZERO_FILL | 30]


@pytest.mark.parametrize("n", [1, 31, 992, 993, 5000])
@pytest.mark.parametrize("density", [0.0, 0.004, 0.5, 1.0])
def test_decode_inverts_encode(n, density):
    bits = np.random.default_rng(n).random((n, 32)) < density
    x = np.packbits(bits, axis=1, bitorder="little").view(np.uint32).reshape(-1)
    assert np.array_equal(wah.decode(wah.encode(x), n), x)
    assert np.array_equal(control.decode(control.encode(x), n), x)


def test_warp_control_splits_runs_that_cross_a_warp():
    # 2 groups of zeros: one fill of 64 chunks, but two of 32 in the control
    x = np.zeros(62, np.uint32)
    assert wah.encode(x).tolist() == [ZERO_FILL | 64]
    assert control.encode(x).tolist() == [ZERO_FILL | 32, ZERO_FILL | 32]


def test_words_differing_counts_length():
    a = np.array([1, 2, 3], np.uint32)
    assert wah.words_differing(a, a) == 0
    assert wah.words_differing(a, np.array([1, 5], np.uint32)) == 2
    assert wah.words_differing(a.view(np.int32), a) == 0


@pytest.mark.parametrize("run_chunks", [1024, 32])
@pytest.mark.parametrize("n", [2 * 992, 7 * 992 + 500])
def test_encode_in_pieces_of_whole_blocks_is_the_same_stream(monkeypatch, run_chunks, n):
    # runs never cross a block's edge, so pieces of whole blocks join exactly;
    # long zero runs at the pieces' edges show a run carried across one
    rng = np.random.default_rng(n)
    x = np.where(rng.random(n) < 0.1, rng.integers(0, 2**32, n, dtype=np.uint64), 0)
    x = x.astype(np.uint32)
    x[992 - 40: 992 + 40] = 0
    whole = wah.encode(x, run_chunks)  # one piece
    for blocks in (1, 2):
        monkeypatch.setattr(wah, "PIECE_BLOCKS", blocks)
        assert np.array_equal(wah.encode(x, run_chunks), whole)
    assert np.array_equal(wah.decode(whole, n), x)


def test_roofline_counts_the_operation():
    # bytes: the input read once, the output written once
    assert rooflines.encode_bytes(992, 1000) == 4 * 992 + 4 * 1000
    assert rooflines.decode_bytes(1000, 992) == 4 * 1000 + 4 * 992
    assert rooflines.chunks(992) == 1024
    assert rooflines.chunks(1) == 32
    n = 262144 * 992  # the protocol bitmap at s = 256
    t = rooflines.encode_seconds(n, n)
    assert t == pytest.approx(8 * n / rooflines.PEAK_BYTES_PER_S)
    # the operation count's time is a tenth of the byte bound's, at any density
    ops_s = rooflines.OPS_PER_CHUNK * rooflines.chunks(n) / rooflines.PEAK_INT_OPS_PER_S
    assert ops_s < 0.11 * rooflines.encode_seconds(n, 0)


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


# an operation's span [0, 100] with two calls in it; a kernel and a memcpy
# that overlap, a kernel in the second call, a memset after it
CANNED = [
    _x("op#0", "user_annotation", 0, 100),
    _x("a#0", "user_annotation", 10, 30),
    _x("b#0", "user_annotation", 50, 40),
    _x("(anonymous namespace)::encode_tiles_kernel(unsigned int const*)", "kernel", 15, 15),
    _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 25, 20),
    _x("void at::native::fill<int>(int)", "kernel", 60, 10),
    _x("Memset (Device)", "gpu_memset", 95, 4),
    _x("aten::cumsum", "cpu_op", 55, 3),
    _x("cudaLaunchKernel", "cuda_runtime", 14, 1),
    _x("a#0", "gpu_user_annotation", 15, 30),
]


def test_canned_trace(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": CANNED + [{"ph": "i", "name": "mark", "ts": 5}]}))
    events = activity.read_events(path)
    assert len(events) == len(CANNED)
    merged = activity.union((a, b) for a, b, _ in activity.device_intervals(events))
    assert merged == [(15, 45), (60, 70), (95, 99)]
    act = activity.device_activity(events, 0, 100)
    assert act["window_us"] == 100 and act["busy_us"] == 44
    assert act["ops"][0] == ("Memcpy HtoD (Pageable -> Device)", 20, 1)
    # unclipped, the frozen copy's window runs from the first event to the last
    assert activity.device_activity(events)["window_us"] == 100
    spans = activity.benchmark_spans(events, merged)
    assert [(s.name, s.index, s.busy_us) for s in spans] == [("op", 0, 44), ("a", 0, 25), ("b", 0, 10)]
    # gaps [0, 15] and [99, 100] in op, [45, 60] and [70, 95] in b
    assert activity.idle_by_span(merged, 0, 100, spans) == [("b", 40), ("op", 16)]
    assert activity.idle_by_span(merged, 0, 100, []) == [(activity.NO_SPAN, 56)]


def test_kernel_labels():
    assert activity.op_label(CANNED[3]["name"]) == "K1 encode_tiles_kernel"
    assert activity.op_label("void (anonymous namespace)::decode_blocks_kernel(int)") == "K4 decode_blocks_kernel"
    assert activity.op_label("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH (Device -> Pageable)"


def test_idle_share_of_the_untraced_window():
    from gpubench.harness import Context

    # 4 traced operations keep the device busy 3 ms in all; once the trace
    # closed, an operation took 1 ms of the window: idle 25%
    ctx = Context([], [], window_us=8000.0, busy_us=3000.0, n_traced=4, untraced_op_s=1e-3)
    assert ctx.idle_percent() == pytest.approx(25.0)
    # nothing traced, or no operation after the trace: nothing to read
    assert Context([], [], 0.0, 0.0).idle_percent() is None
    assert Context([], [], 8000.0, 3000.0, n_traced=4).idle_percent() is None
