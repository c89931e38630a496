"""Share of the roofline of the decode operation (stream read once, bitmap
written once, gpubench/rooflines.py) over the device's busy time inside
the benchmark's device.decode spans (K3, the granule scan, K4 and their
small operations), in %, summed over the traced round trips."""

from gpubench import rooflines


def read(ctx):
    if ctx is None:
        return None
    bound = busy = 0.0
    for s in ctx.spans_named("device.decode"):
        c = ctx.ops[s.index].counts
        bound += rooflines.decode_seconds(c["total"], c["n_out"])
        busy += s.busy_us * 1e-6
    return 100.0 * bound / busy if busy > 0 else None
