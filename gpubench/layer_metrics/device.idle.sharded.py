"""Rank 0's device idle share of the window, in %: 100 minus its busy
time an operation (the union of kernel, memcpy and memset time over the
traced operations, gpubench/activity.py) over the window's time an
operation once the trace has closed (Context.idle_percent)."""


def read(ctx):
    return ctx.idle_percent() if ctx is not None else None
