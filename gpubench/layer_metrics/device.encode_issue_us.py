"""The host's issue of the encode pipeline in one device round trip: the
program's wah.encode span (encode_padded: K1, the count scan, K2 and
their small operations, launched), without the driver's read of the
total, in us, the mean over the traced round trips."""

from gpubench import program_spans


def read(ctx):
    ms = program_spans.mean_ms(ctx, {"wah.encode"})
    return None if ms is None else 1e3 * ms
