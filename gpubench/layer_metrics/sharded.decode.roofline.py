"""Share of the roofline of rank 0's part of the sharded decode over rank
0's device busy time inside the benchmark's sharded.decode spans (K3 and
the granule scan over the replicated stream, K4 over rank 0's span), in
%, summed over the traced operations. Rank 0's span is its own shard, so
the operation reads its total_0 stream words once and writes its n_l
ints once (gpubench/rooflines.py); reading the rest of the stream is the
implementation's."""

from gpubench import rooflines


def read(ctx):
    if ctx is None:
        return None
    bound = busy = 0.0
    for s in ctx.spans_named("sharded.decode"):
        c = ctx.ops[s.index].counts
        if "total_0" in c:
            bound += rooflines.decode_seconds(c["total_0"], c["n_l"])
            busy += s.busy_us * 1e-6
    return 100.0 * bound / busy if busy > 0 else None
