"""The program's own spans in the traced window: what
wah_tpu_torch.utils.profiling.span recorded (host clock,
time.perf_counter(), the clock of Op.t0 and Op.t1) while the benchmark's
profiler ran, kept where a span lies inside a traced operation and
grouped by that operation. The per-layer metrics that read them call
the functions below; each gives None where no program span falls inside
a traced operation, as with a program that records none.
"""
from __future__ import annotations

import bisect


def by_op(ctx) -> dict[int, list] | None:
    """{operation index: its program spans, in the order they closed} over
    the traced operations that hold any, or None."""
    if ctx is None or not ctx.spans:
        return None
    from wah_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)  # absent from a program without spans
    if read is None:
        return None
    ops = sorted((ctx.ops[i] for i in {s.index for s in ctx.spans}), key=lambda op: op.t0)
    starts = [op.t0 for op in ops]
    out: dict[int, list] = {}
    for r in read():
        k = bisect.bisect_right(starts, r.t0) - 1
        if k >= 0 and r.t1 <= ops[k].t1:
            out.setdefault(ops[k].index, []).append(r)
    return out or None


def mean_ms(ctx, names) -> float | None:
    """The time in the spans named `names` an operation, in ms, the mean
    over the operations that hold program spans."""
    grouped = by_op(ctx)
    if grouped is None:
        return None
    total = sum(r.t1 - r.t0 for rs in grouped.values() for r in rs if r.name in names)
    return 1e3 * total / len(grouped)


def self_ms(ctx, names) -> float | None:
    """The self time of the spans named `names` an operation, in ms: their
    time minus that of the spans opened directly inside them (one thread's
    children follow each other), the mean as in mean_ms."""
    grouped = by_op(ctx)
    if grouped is None:
        return None
    total = 0.0
    for rs in grouped.values():
        for r in rs:
            if r.name in names:
                total += r.t1 - r.t0
            elif r.parent in names:
                total -= r.t1 - r.t0
    return 1e3 * total / len(grouped)


def rate_GBps(ctx, names) -> float | None:
    """The counted bytes of the spans named `names` over their time, in
    GB/s, or None where no such span counted any."""
    grouped = by_op(ctx)
    if grouped is None:
        return None
    rs = [r for rs in grouped.values() for r in rs if r.name in names and "bytes" in r.counts]
    seconds = sum(r.t1 - r.t0 for r in rs)
    return 1e-9 * sum(r.counts["bytes"] for r in rs) / seconds if seconds > 0 else None
