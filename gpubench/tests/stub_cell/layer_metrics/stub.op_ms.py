"""A stub cell's per-layer metric: the host time of an operation, in ms,
the mean over the window's operations."""


def read(ctx):
    if ctx is None or not ctx.ops:
        return None
    return 1e3 * sum(op.t1 - op.t0 for op in ctx.ops) / len(ctx.ops)
