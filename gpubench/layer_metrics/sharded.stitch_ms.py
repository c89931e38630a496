"""The host's time in the program's wah.sharded.word_cap and
wah.sharded.stitch spans of one sharded operation (stitch_word_cap's read
of the totals, which waits for the encode; stitch_global: the payload's
gather, K2's compaction and the read of the stream's end), in ms, the
mean over the traced operations; None where the program records neither
span."""

from gpubench import program_spans

NAMES = {"wah.sharded.word_cap", "wah.sharded.stitch"}


def read(ctx):
    grouped = program_spans.by_op(ctx)
    if grouped is None or not any(r.name in NAMES for rs in grouped.values() for r in rs):
        return None
    return program_spans.mean_ms(ctx, NAMES)
