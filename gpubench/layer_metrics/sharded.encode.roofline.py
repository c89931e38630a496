"""Share of the roofline of rank 0's part of the sharded encode (its
shard of n_l ints read once, its total_0 stream words written once,
gpubench/rooflines.py) over rank 0's device busy time inside the
benchmark's sharded.encode spans (K1, the count scan, K2, the totals'
gather, until stitch_word_cap has read the totals), in %, summed over
the traced operations."""

from gpubench import rooflines


def read(ctx):
    if ctx is None:
        return None
    bound = busy = 0.0
    for s in ctx.spans_named("sharded.encode"):
        c = ctx.ops[s.index].counts
        if "total_0" in c:
            bound += rooflines.encode_seconds(c["n_l"], c["total_0"])
            busy += s.busy_us * 1e-6
    return 100.0 * bound / busy if busy > 0 else None
