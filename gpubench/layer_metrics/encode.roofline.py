"""Share of the roofline of the encode operation (bitmap read once, stream
written once, gpubench/rooflines.py) over the device's busy time inside
the benchmark's device.encode spans (K1, the count scan, K2 and their
small operations), in %, summed over the traced round trips."""

from gpubench import rooflines


def read(ctx):
    if ctx is None:
        return None
    bound = busy = 0.0
    for s in ctx.spans_named("device.encode"):
        c = ctx.ops[s.index].counts
        bound += rooflines.encode_seconds(c["n_ints"], c["total"])
        busy += s.busy_us * 1e-6
    return 100.0 * bound / busy if busy > 0 else None
