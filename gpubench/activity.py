"""Device activity read from a torch.profiler Chrome trace.

`device_activity` is a frozen copy of the arithmetic of
wah_tpu_torch.utils.profiling.device_activity (the union of the kernel,
memcpy and memset intervals over a window, and the device operations by
total time), taking parsed events instead of a log directory so that the
benchmark picks its own window. The rest attributes the device's busy time
to the benchmark's spans (torch.profiler.record_function ranges, named
"<span>#<operation index>"), and labels each idle gap with the innermost
span that was open on the host when the device waited.

Times are the trace's microseconds.
"""
from __future__ import annotations

import bisect
import json
import re
from dataclasses import dataclass
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_CATEGORY = "user_annotation"
NO_SPAN = "no benchmark span"
KERNEL_IDS = json.loads((Path(__file__).with_name("kernels.json")).read_text())


@dataclass
class Span:
    """One benchmark span: `name` (what the host was calling), `index` (the
    operation of the window it belongs to), host start and end, and the
    device time of the union of device intervals inside it."""

    name: str
    index: int
    t0: float
    t1: float
    busy_us: float = 0.0


def read_events(path) -> list[dict]:
    """The complete ("X") events of a Chrome trace that have a duration."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def device_intervals(events) -> list[tuple[float, float, str]]:
    return [
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in events if e.get("cat") in DEVICE_CATEGORIES
    ]


def union(intervals) -> list[tuple[float, float]]:
    """The intervals merged into disjoint ones, in order."""
    merged: list[list[float]] = []
    for a, b, *_ in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_within(merged, lo: float, hi: float) -> float:
    """Length of the merged intervals' part inside [lo, hi]."""
    i = max(bisect.bisect_right(merged, (lo, float("inf"))) - 1, 0)
    busy = 0.0
    while i < len(merged) and merged[i][0] < hi:
        a, b = merged[i]
        busy += max(0.0, min(b, hi) - max(a, lo))
        i += 1
    return busy


def device_activity(events, lo: float | None = None, hi: float | None = None) -> dict:
    """The window [lo, hi] (default: the first event's start to the last
    event's end, host or device), the device's busy time in it (the union
    of its kernel, memcpy and memset intervals), their ratio, and the
    device operations by total time inside it, longest first, as
    (name, microseconds, count)."""
    if not events:
        raise ValueError("no timed events")
    if lo is None:
        lo = min(float(e["ts"]) for e in events)
    if hi is None:
        hi = max(float(e["ts"]) + float(e["dur"]) for e in events)
    spans, by_name = [], {}
    for a, b, name in device_intervals(events):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        spans.append((a, b))
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + (b - a), n + 1)
    busy = busy_within(union(spans), lo, hi)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        "window_us": hi - lo,
        "busy_us": busy,
        "busy_share": busy / (hi - lo) if hi > lo else 0.0,
        "ops": [(name, us, n) for name, (us, n) in ranked],
    }


_SPAN_NAME = re.compile(r"^(.+)#(\d+)$")


def benchmark_spans(events, merged) -> list[Span]:
    """The benchmark's spans, in order of start, each with its device busy
    time (the part of `merged` inside it)."""
    out = []
    for e in events:
        if e.get("cat") != SPAN_CATEGORY:
            continue
        m = _SPAN_NAME.match(e["name"])
        if not m:
            continue
        t0 = float(e["ts"])
        t1 = t0 + float(e["dur"])
        out.append(Span(m.group(1), int(m.group(2)), t0, t1, busy_within(merged, t0, t1)))
    out.sort(key=lambda s: (s.t0, -s.t1))
    return out


def idle_by_span(merged, lo: float, hi: float, spans) -> list[tuple[str, float]]:
    """The device's idle time in [lo, hi], summed by the innermost benchmark
    span open at each gap's midpoint, longest first, in microseconds."""
    gaps, end = [], lo
    for a, b in merged:
        if a > end and end < hi:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        gaps.append((end, hi))
    totals: dict[str, float] = {}
    stack: list[Span] = []
    k = 0
    for a, b in gaps:
        mid = (a + b) / 2
        while k < len(spans) and spans[k].t0 <= mid:
            stack.append(spans[k])
            k += 1
        # the spans open at the midpoint; they nest, so few are open at once
        open_ = [s for s in stack if s.t1 >= mid]
        stack = open_
        label = min(open_, key=lambda s: s.t1 - s.t0).name if open_ else NO_SPAN
        totals[label] = totals.get(label, 0.0) + (b - a)
    return sorted(totals.items(), key=lambda kv: -kv[1])


def op_label(name: str) -> str:
    """A device operation's name, with the port's kernel id (K1-K6, T1)
    before each of its hand-written kernels."""
    base = name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0].strip()
    kid = KERNEL_IDS.get(base)
    return f"{kid} {base}" if kid else name[:160]
