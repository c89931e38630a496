"""The bytes the program's gathers delivered to rank 0 in one sharded
operation (the `bytes` of its wah.gather spans: the totals, the payload,
the decoded spans, each with rank 0's own row), in MB, the mean over the
traced operations; None where the program records no such span."""

from gpubench import program_spans


def read(ctx):
    grouped = program_spans.by_op(ctx)
    if grouped is None:
        return None
    got = [r.counts["bytes"] for rs in grouped.values() for r in rs
           if r.name == "wah.gather" and "bytes" in r.counts]
    return 1e-6 * sum(got) / len(grouped) if got else None
