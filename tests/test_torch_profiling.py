"""wah_tpu_torch.utils.profiling on the CPU: the measuring rules of
marginal_seconds on synthetic clocks, amortized_seconds on a step of
known cost, trace's Chrome-trace output and device_activity's reading of
one, and the program's spans: none without a profiler, the documented
names and links under one. The CUDA-graph clock runs only on the card
(tests/test_torch_cuda.py).

Each synthetic clock is run(k) = d + k s in binary fractions, so every
slope is exact in floating point; the k sequences below are worked out by
hand from wah_tpu/utils/profiling.py:95-131:

  b1 = run(1); k = 8; while bK < 4 b1: k = min(max_iters, max(2k,
  int(3.2 b1 / slope) + 1), max(2k, int(2.5 / slope))), break once bK >
  b1 + 2.5; then up to three K -> 2K slopes against (b1, bK), K doubling
  while they differ by more than rel_tol, unless b2K > b1 + 6.
"""
import contextlib
import json
import tempfile

import numpy as np
import pytest
import torch

from wah_tpu_torch import WahCodec
from wah_tpu_torch.ops.cuda import decode_kernel, encode_kernel
from wah_tpu_torch.utils import profiling

S = 2.0 ** -20  # the marginal step of the clocks (~1 us)


def _clock(d, s, extra=None):
    """run(k) = d + k s (+ extra[k]), recording each k it is asked for."""
    seen = []

    def run(k):
        seen.append(k)
        return d + k * s + (extra or {}).get(k, 0.0)

    return run, seen


def test_escalation_visits_the_reference_sequence():
    # b1 = 1025 S; k = 8: bK = 1032 S < 4 b1, slope S, target
    # int(3.2 * 1025) + 1 = 3281, budget int(2.5 / S) -> k = 3281,
    # bK = 4305 S >= 4100 S; slopes at 6562: (7586 - 4305) / 3281 = 1 and
    # (4305 - 1025) / 3280 = 1 agree -> S.
    run, seen = _clock(1024 * S, S)
    assert profiling.marginal_seconds(run) == S
    assert seen == [1, 8, 3281, 6562]


def test_noise_breaks_the_cross_check_once_and_k_doubles():
    # 400 S of noise at k = 3281: slopes (7586 - 4705) / 3281 = 0.878 S
    # against (4705 - 1025) / 3280 = 1.122 S differ by 22% > 15%, so K
    # doubles to 6562: (14148 - 7586) / 6562 = 1 against (7586 - 1025) /
    # 6561 = 1 -> S.
    run, seen = _clock(1024 * S, S, {3281: 400 * S})
    assert profiling.marginal_seconds(run) == pytest.approx(S, rel=0.15)
    assert seen == [1, 8, 3281, 6562, 13124]


def test_escalation_stops_past_the_2_5_s_budget():
    # d = 2 s; the step costs 2^-10 s up to k = 8 and 2^-9 s after it, so
    # the slope is underestimated: b1 = 2 + 2^-10, k = 8, slope 2^-10,
    # target int(3.2 * 2049) + 1 = 6557, budget 2560 -> k = 2560, bK =
    # 2 + (8 + 2 * 2552) / 1024 = 6.992 < 4 b1 but > b1 + 2.5: stop
    # escalating (without the break: k = 5120, then 10240). Slope at
    # 5120: 5 / 2560 = 2^-9.
    seen = []

    def run(k):
        seen.append(k)
        return 2.0 + min(k, 8) * 2.0 ** -10 + max(k - 8, 0) * 2.0 ** -9

    assert profiling.marginal_seconds(run) == 2.0 ** -9
    assert seen == [1, 8, 2560, 5120]


def test_unstable_slopes_return_once_a_window_passes_6_s():
    # d = 1 s, s = 2^-12: k = 8, then budget int(2.5 * 4096) = 10240 (bK =
    # 3.5), then 20480 (bK = 6 > b1 + 2.5: break); 3 s of noise at 40960
    # makes the slopes (14 - 6) / 20480 and 5 / 20479 disagree, but b2K =
    # 14 > b1 + 6: the K -> 2K slope is returned without doubling.
    run, seen = _clock(1.0, 2.0 ** -12, {40960: 3.0})
    assert profiling.marginal_seconds(run) == 8.0 / 20480
    assert seen == [1, 8, 10240, 20480, 40960]


def test_unstable_slopes_stop_at_max_iters():
    # the same noise as above with max_iters = 2048: k = 8 -> 2048 (the
    # cap; bK = 1.5 < 4 b1 but k is at the cap), slopes at 4096 taken once.
    run, seen = _clock(1.0, 2.0 ** -12, {4096: 3.0})
    assert profiling.marginal_seconds(run, max_iters=2048) == pytest.approx(
        (3.0 + 2048 * 2.0 ** -12) / 2048)
    assert seen == [1, 8, 2048, 4096]


def test_amortized_seconds_of_a_busy_wait_on_the_cpu(monkeypatch):
    """A step that busy-waits 2 ms on the clock amortized_seconds reads. The
    clock is a virtual one, whose every read costs 10 us, so that other
    processes on the machine cannot stretch the wait: the windows, the
    warm-up and the escalation are the ones a real clock would get."""
    now = [0.0]

    def clock():
        now[0] += 1e-5
        return now[0]

    monkeypatch.setattr(profiling.time, "perf_counter", clock)
    cost = 2e-3

    def busy(x):
        t0 = clock()
        while clock() - t0 < cost:
            pass
        return x + 1

    got = profiling.amortized_seconds(busy, torch.zeros(4))
    assert got == pytest.approx(cost, rel=0.3)


def test_trace_writes_a_chrome_trace_of_the_block(tmp_path):
    with profiling.trace(str(tmp_path)) as logdir:
        torch.cumsum(torch.arange(1000), 0)
    assert logdir == str(tmp_path)
    assert isinstance(logdir.profiler, torch.profiler.profile)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "aten::cumsum" in names
    assert any(e.key == "aten::cumsum" for e in logdir.profiler.key_averages())
    act = profiling.device_activity(logdir)
    assert act["busy_us"] == 0.0 and act["ops"] == [] and act["window_us"] > 0


def test_device_activity_takes_the_union_of_device_intervals(tmp_path):
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 100, "dur": 900},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 200, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 250, "dur": 100},  # overlaps k1
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 500, "dur": 250},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 550, "dur": 50},  # inside
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 900, "dur": 100},
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 0},  # no duration: not counted
    ]
    (tmp_path / "w.1.pt.trace.json").write_text(json.dumps({"traceEvents": ev}))
    act = profiling.device_activity(str(tmp_path))
    assert act["window_us"] == 900  # 100 .. 1000
    assert act["busy_us"] == 150 + 250 + 100
    assert act["busy_share"] == pytest.approx(500 / 900)
    assert act["ops"] == [("Memcpy HtoD", 250.0, 1), ("k1", 200.0, 2), ("k2", 100.0, 1),
                          ("Memset", 50.0, 1)]


def test_trace_defaults_to_a_fresh_directory_each_time(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    dirs = []
    for _ in range(2):
        with profiling.trace() as logdir:
            torch.arange(10).sum()
        dirs.append(logdir)
    assert dirs[0] != dirs[1]
    for d in dirs:
        assert d.startswith(str(tmp_path / "wah_tpu_torch_trace-"))
        assert len(list(tmp_path.glob(f"{d.rsplit('/', 1)[1]}/*.pt.trace.json"))) == 1


# 5,000 ints: compress copies the bitmap as it is into a device buffer of
# 6 whole blocks (5,952 ints); decompress copies the stream as it is into a
# device buffer of whole 1024-word blocks
N_INTS = 5000
# (name, parent) of every span of one round trip, in the order they close
ROUND_TRIP = [
    ("wah.compress.to_device", "wah.compress"),
    ("wah.encode", "wah.compress.kernel"),
    ("wah.compress.kernel", "wah.compress"),
    ("wah.compress.from_device", "wah.compress"),
    ("wah.compress", None),
    ("wah.decompress.to_device", "wah.decompress"),
    ("wah.decompress.validate", "wah.decompress"),
    ("wah.decode", "wah.decompress.kernel"),
    ("wah.decompress.kernel", "wah.decompress"),
    ("wah.decompress.from_device", "wah.decompress"),
    ("wah.decompress", None),
]


def _round_trip():
    data = (np.random.default_rng(7).random(N_INTS) < 0.05).astype(np.uint32)
    codec = WahCodec("cpu")
    stream, tc = codec.compress(data)
    out, td = codec.decompress(stream, out_ints=N_INTS)
    assert np.array_equal(out, data)
    return data, stream, tc, td


def test_spans_record_nothing_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.clear()
    _round_trip()
    assert profiling.spans() == []
    assert profiling.span("wah.compress") is profiling.span("wah.decode")  # one shared no-op


def test_a_traced_round_trip_records_the_documented_spans(tmp_path):
    profiling.clear()
    with profiling.trace(str(tmp_path)):
        data, stream, _, _ = _round_trip()
    got = profiling.spans()
    assert [(r.name, r.parent) for r in got] == ROUND_TRIP
    calls = {r.name.split(".")[1]: r.call for r in got if r.parent is None}
    assert calls["compress"] != calls["decompress"]
    for r in got:
        side = "compress" if r.name == "wah.encode" or r.name.startswith("wah.compress") \
            else "decompress"
        assert r.call == calls[side] and r.t0 <= r.t1
        assert not r.name[-1].isdigit()  # never the benchmark's "<span>#<index>"
    by_name = {r.name: r for r in got}
    for r in got:  # each span lies inside its parent
        if r.parent is not None:
            assert by_name[r.parent].t0 <= r.t0 and r.t1 <= by_name[r.parent].t1
    want = {
        "wah.compress.to_device": N_INTS * 4,  # the bitmap as it is, padded on the device
        "wah.compress.from_device": stream.nbytes,
        "wah.decompress.to_device": stream.nbytes,
        "wah.decompress.validate": stream.nbytes,
        # the decoded ints that cross: whole groups of 31, before out_ints trims them
        "wah.decompress.from_device": -(-N_INTS // 31) * 31 * 4,
    }
    assert {r.name: r.counts.get("bytes") for r in got if "bytes" in r.counts} == want
    # the copies' chunks through convert's pinned ring: none on the CPU
    assert {r.name: r.counts["staged_chunks"] for r in got if "staged_chunks" in r.counts} == {
        f"wah.{side}.{phase}": 0 for side in ("compress", "decompress")
        for phase in ("to_device", "from_device")}
    assert want["wah.decompress.from_device"] >= data.nbytes
    (trace_file,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(trace_file.read_text())["traceEvents"]
    annotated = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {name for name, _ in ROUND_TRIP} <= annotated


def test_phase_spans_enclose_their_phase_timings():
    profiling.clear()
    with profiling.trace():
        _, _, tc, td = _round_trip()
    got = {r.name: r for r in profiling.spans()}
    for side, timings in (("compress", tc), ("decompress", td)):
        for phase in ("to_device", "kernel", "from_device"):
            r = got[f"wah.{side}.{phase}"]
            assert (r.t1 - r.t0) * 1e3 >= getattr(timings, f"{phase}_ms") - 0.5


@pytest.mark.parametrize("pipeline", ["wah.encode", "wah.decode"])
def test_each_pipeline_records_one_span(pipeline):
    g = torch.Generator().manual_seed(3)
    ints = torch.randint(-2**31, 2**31, (2 * 992,), dtype=torch.int32, generator=g)
    words, total = encode_kernel.encode_padded(ints, 2 * 1024, stitch="v3")
    profiling.clear()
    with profiling.trace():
        if pipeline == "wah.encode":
            encode_kernel.encode_padded(ints, 2 * 1024, stitch="v3")
        else:
            decode_kernel.decode(words, int(total), 2 * 1024)
    (r,) = profiling.spans()
    assert r.name == pipeline and r.parent is None and r.counts == {}


def test_the_span_buffer_stops_at_its_maxlen(monkeypatch):
    """The buffer keeps the newest SPAN_BUFFER records. Recording is forced
    on, with a no-op range, so that the test does not pay a profiler's
    cost for each of the 65,536 spans."""
    monkeypatch.setattr(profiling, "_recording", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: contextlib.nullcontext())
    profiling.clear()
    for i in range(profiling.SPAN_BUFFER + 10):
        with profiling.span("wah.test", i=i):
            pass
    got = profiling.spans()
    assert profiling.SPAN_BUFFER == 65536 and len(got) == profiling.SPAN_BUFFER
    assert got[0].counts == {"i": 10} and got[-1].counts == {"i": profiling.SPAN_BUFFER + 9}
    profiling.clear()
    assert profiling.spans() == []
