"""Validation of the stream in one WahCodec round trip: the program's
wah.decompress.validate span (V1, ops/cuda/stream_check.check_stream, on
the stream's device copy: the check and the chunk count in one pass, then
the host's read of its 16 B result), in ms, the mean over the traced round
trips."""

from gpubench import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, {"wah.decompress.validate"})
