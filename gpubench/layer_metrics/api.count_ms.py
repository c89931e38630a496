"""The chunk count of the stream in one WahCodec round trip: the program's
wah.decompress.count span (stream_chunks, which sizes the decode's
output), in ms, the mean over the traced round trips."""

from gpubench import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, {"wah.decompress.count"})
