"""Profiling helpers: device timeline traces and amortized step timing —
the port's counterpart of wah_tpu.utils.profiling.

The reference measures kernels with cudaEvents (timeMeasuring.h:11-28).
Here (a) `trace(...)` is a torch.profiler context that writes a
Chrome-trace timeline (TensorBoard and Perfetto load it), and (b)
`amortized_seconds(...)` is the marginal time of one call of a step,
measured as the extra cost of more calls: on a CUDA device the step is
captured once in a CUDA graph and the graph replayed K times between two
CUDA events, so the host's launch gaps between the step's small ops,
which an eager timing of the step includes, stay out of the number.
`marginal_seconds` holds the measuring rules, as a function of any
`run(k) -> seconds` clock.

(c) `span(name, **counts)` marks a phase of the program's own work (the
API's host phases, the pipelines' issue). It records only while a torch
profiler records, under `trace` or any other: then it opens a
torch.profiler range of that name, which lands in the Chrome trace on the
device's clock, and keeps a `SpanRecord` on time.perf_counter() in a
bounded buffer that `spans()` reads and `clear()` empties. Otherwise it
costs one check. The names the port records:

  wah.compress, wah.decompress            a whole WahCodec call (the top
                                          level: one call id each)
  wah.decompress.validate                 V1's check and count of the stream
                                          on the device, and the host's read
                                          of its result (bytes of the stream)
  wah.{compress,decompress}.to_device     the PhaseTimer phases; the copies
  wah.{compress,decompress}.kernel        carry the bytes that cross and the
  wah.{compress,decompress}.from_device   chunks they moved through convert's
                                          pinned ring (staged_chunks; 0 when
                                          copied directly)
  wah.encode                              encode_padded's pipeline, issued
  wah.decode                              decode's pipeline, issued
  wah.sharded.encode                      parallel.encode_sharded (holds
                                          wah.encode and the totals' gather)
  wah.sharded.word_cap                    parallel.stitch_word_cap: the host
                                          read of the totals
  wah.sharded.stitch                      parallel.stitch_global: the payload's
                                          gather, its compaction and the host
                                          read of the stream's end (bytes of
                                          the gathered payload)
  wah.sharded.decode                      parallel.decode_sharded (holds
                                          wah.decode)
  wah.gather                              one collective of parallel._comm
                                          (route; bytes delivered to this
                                          rank, its own row included)
"""
from __future__ import annotations

import collections
import itertools
import json
import tempfile
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Callable, NamedTuple

import torch

__all__ = [
    "trace", "device_activity", "amortized_seconds", "marginal_seconds", "capture", "CapturedStep",
    "span", "spans", "clear", "SpanRecord",
]


class SpanRecord(NamedTuple):
    """One closed span: its name, its start and end on time.perf_counter(),
    the name of the span it was opened in (None at the top level), the id
    of the top-level span it belongs to (one call of the API), and the
    numbers it counted (bytes=...)."""

    name: str
    t0: float
    t1: float
    parent: str | None
    call: int
    counts: dict


# the newest records; a trace that outruns it keeps its last SPAN_BUFFER
SPAN_BUFFER = 65536
_records: collections.deque = collections.deque(maxlen=SPAN_BUFFER)
_open = threading.local()  # .stack: the spans open on this thread
_calls = itertools.count(1)
_recording = torch._C._autograd._profiler_enabled


class _NoSpan:
    """What `span` gives while no profiler records: nothing at all."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **counts) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "counts", "parent", "call", "t0", "_range")

    def __init__(self, name: str, counts: dict):
        self.name = name
        self.counts = counts

    def set(self, **counts) -> None:
        """Count what is known only inside the span (the bytes of a result)."""
        self.counts.update(counts)

    def __enter__(self):
        stack = _open.__dict__.setdefault("stack", [])
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer else None
        self.call = outer.call if outer else next(_calls)
        stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._range.__exit__(*exc)
        _open.stack.pop()
        _records.append(SpanRecord(self.name, self.t0, t1, self.parent, self.call, self.counts))
        return False


def span(name: str, **counts):
    """A context manager around a phase of the program's work, recording
    only while a torch profiler records (see the module's docstring); its
    `set(**counts)` adds counts from inside. Names never end in
    "#<digits>", the form of a benchmark's own spans."""
    if not _recording():
        return _NO_SPAN
    return _Span(name, counts)


def spans() -> list[SpanRecord]:
    """The records kept, oldest first."""
    return list(_records)


def clear() -> None:
    """Forget the records kept."""
    _records.clear()


class Trace(str):
    """The log directory `trace` yields (a str, as wah_tpu's), with the
    torch.profiler object it ran as `.profiler`: read its events after the
    block ends."""

    profiler: torch.profiler.profile


@contextmanager
def trace(logdir: str | None = None):
    """Capture a device profile around a block into `logdir` (default: a
    fresh wah_tpu_torch_trace-* directory in the temporary directory), as
    a Chrome-trace JSON: `tensorboard --logdir=...` or Perfetto. CPU
    activity always, CUDA activity whenever a CUDA device is present. The
    program's spans record inside the block."""
    if logdir is None:
        logdir = tempfile.mkdtemp(prefix="wah_tpu_torch_trace-")
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Trace(logdir)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    ) as prof:
        out.profiler = prof
        yield out
        if cuda:
            torch.cuda.synchronize()


# Chrome-trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_activity(logdir: str) -> dict:
    """Read the newest Chrome trace in `logdir` (what `trace` wrote): the
    window from its first event to the end of its last (host or device),
    the time the device was busy in it (the union of its kernel, memcpy
    and memset intervals), their ratio, and the device operations by
    total time, longest first, as (name, microseconds, count)."""
    path = max(Path(logdir).glob("*.pt.trace.json"), key=lambda f: f.stat().st_mtime)
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{path}: no timed events")
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    spans, by_name = [], {}
    for e in events:
        if e.get("cat") in DEVICE_CATEGORIES:
            ts, dur = float(e["ts"]), float(e["dur"])
            spans.append((ts, ts + dur))
            us, n = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (us + dur, n + 1)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):  # the union of the intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        "window_us": t1 - t0,
        "busy_us": busy,
        "busy_share": busy / (t1 - t0) if t1 > t0 else 0.0,
        "ops": [(name, us, n) for name, (us, n) in ranked],
    }


def marginal_seconds(
    run: Callable[[int], float],
    iters: int = 8,
    max_iters: int = 1 << 16,
    rel_tol: float = 0.15,
) -> float:
    """Marginal seconds of one iteration, given `run(k)`, the seconds of k
    iterations in one timed window (wah_tpu/utils/profiling.py:95-131).

    b1 = run(1) holds the fixed cost of a window (a dispatch, an event
    pair); K escalates geometrically until the window's work dominates it
    (bK >= 4 b1), aiming at 3.2 b1 / slope but never past 2.5 s of work a
    window, and stops escalating once a window passes b1 + 2.5 s. The
    slope returned is the K -> 2K one, whose fixed cost cancels; it is
    held against the (b1, bK) slope, and where the two disagree by more
    than `rel_tol` K doubles and both are taken again, up to three times,
    unless a window passes b1 + 6 s or K reaches max_iters.
    """
    b1 = run(1)
    k, bk = iters, run(iters)
    while bk < 4.0 * b1 and k < max_iters:
        slope = max((bk - b1) / (k - 1), 1e-12)
        k_target = max(2 * k, int(3.2 * b1 / slope) + 1)
        k_budget = max(2 * k, int(2.5 / slope))
        k = min(max_iters, k_target, k_budget)
        bk = run(k)
        if bk > b1 + 2.5:
            break

    for _ in range(3):
        b2k = run(2 * k)
        s_hi = max(b2k - bk, 1e-12) / k  # the fixed cost cancels
        s_lo = max(bk - b1, 1e-12) / (k - 1)
        if (
            abs(s_hi - s_lo) <= rel_tol * max(s_hi, s_lo)
            or k >= max_iters
            or b2k > b1 + 6.0
        ):
            return s_hi
        k, bk = 2 * k, b2k  # unstable: double the window and retry
    return s_hi


class CapturedStep(NamedTuple):
    """One call of a step captured in a CUDA graph: `graph.replay()` runs
    it again on the current stream, writing `out`, the tensors the
    captured call returned, in place."""

    graph: torch.cuda.CUDAGraph
    out: Any


_WARMUP_CALLS = 3


def capture(step: Callable, *args) -> CapturedStep:
    """Capture one call of `step(*args)` in a CUDA graph, after a few eager
    calls on a side stream (torch's CUDA-graph notes: lazy set-up happens
    outside the capture). A step that cannot be captured, one
    that reads a device value on the host (int(t), .tolist()) or copies
    from pageable host memory, raises the capture's error: nothing falls
    back to eager calls, which would time something else."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(_WARMUP_CALLS):
            step(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.current_stream()
    try:
        with torch.cuda.graph(graph):
            out = step(*args)
    except RuntimeError as e:
        raise RuntimeError(f"step cannot be captured in a CUDA graph: {e}") from e
    finally:
        torch.cuda.set_stream(stream)  # a failed capture leaves its own stream current
    graph.replay()  # the first replay uploads the graph
    torch.cuda.synchronize()
    return CapturedStep(graph, out)


def _replay_clock(captured: CapturedStep, reps: int) -> Callable[[int], float]:
    def run(k: int) -> float:
        best = float("inf")
        for _ in range(reps):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            for _ in range(k):
                captured.graph.replay()
            ev1.record()
            ev1.synchronize()
            best = min(best, ev0.elapsed_time(ev1) / 1e3)
        return best

    return run


def _host_clock(step: Callable, args, reps: int) -> Callable[[int], float]:
    def run(k: int) -> float:
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(k):
                step(*args)
            best = min(best, time.perf_counter() - t0)
        return best

    return run


def amortized_seconds(
    step: Callable,
    *args,
    iters: int = 8,
    reps: int = 3,
    max_iters: int = 1 << 16,
    rel_tol: float = 0.15,
    cache: dict | None = None,
    cache_key=None,
) -> float:
    """Marginal seconds of one call of `step(*args)`, by marginal_seconds'
    rules over a clock of `reps` windows of k calls (the best of them).

    The device is read from `args`: pass the step's tensors as arguments.
    On a CUDA device (any CUDA tensor among them) one call is captured
    in a CUDA graph (`capture`) and a window is k replays between two CUDA
    events on the current stream: the device time of k calls, with the
    host's launch gaps inside one call left out. wah_tpu's step takes a
    perturbation argument so that XLA cannot hoist the body out of its
    loop; a replayed graph is never hoisted, so the step here takes only
    its own arguments. A step that cannot be captured raises; there is no
    eager fallback. On the CPU a window is k calls between two
    time.perf_counter() reads.

    cache/cache_key: `cache[cache_key]` keeps the CapturedStep (the
    counterpart of wah_tpu's compiled loop), so timing the same step
    again skips the capture, and its `.out` holds what the replays wrote.
    The key must pin the step and its arguments: a hit replays the cached
    graph, whatever `step` is passed.
    """
    on_card = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    if not on_card:
        step(*args)  # warm
        run = _host_clock(step, args, reps)
    else:
        captured = cache.get(cache_key) if cache is not None else None
        if captured is None:
            captured = capture(step, *args)
            if cache is not None:
                cache[cache_key] = captured
        run = _replay_clock(captured, reps)
    return marginal_seconds(run, iters=iters, max_iters=max_iters, rel_tol=rel_tol)
