"""Validation of the stream in one WahCodec round trip: the program's
wah.decompress.validate span (checked_stream: the C++ host codec's check,
or numpy's), in ms, the mean over the traced round trips."""

from gpubench import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, {"wah.decompress.validate"})
