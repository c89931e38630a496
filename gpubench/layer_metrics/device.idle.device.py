"""The device's idle share of the window, in %: 100 minus the device's
busy time an operation (the union of kernel, memcpy and memset time over
the traced operations, gpubench/activity.py) over the window's time an
operation once the trace has closed, so that the profiler's slowing of
the host does not read as idle time (Context.idle_percent)."""


def read(ctx):
    return ctx.idle_percent() if ctx is not None else None
