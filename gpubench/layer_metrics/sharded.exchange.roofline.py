"""Share of the link's roofline of what must reach rank 0 in a sharded
operation (the other ranks' live stream words and bitmap ints,
gpubench/links.py, over NVLink's peak in one direction) over rank 0's
device busy time inside the benchmark's sharded.stitch and
sharded.gather spans (the payload's gather and K2's compaction, the
bitmap's gather and its copy out), in %, summed over the traced
operations."""

from gpubench import links

SPANS = ("sharded.stitch", "sharded.gather")


def read(ctx):
    if ctx is None:
        return None
    bound = busy = 0.0
    for s in ctx.spans:
        c = ctx.ops[s.index].counts
        if s.name in SPANS and "total_0" in c:
            if s.name == SPANS[0]:
                bound += links.exchange_seconds(c["n_ints"], c["total"], c["n_0"], c["total_0"])
            busy += s.busy_us * 1e-6
    return 100.0 * bound / busy if busy > 0 else None
