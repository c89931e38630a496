"""The host's issue of the decode pipeline in one device round trip: the
program's wah.decode span (decode: K3, the granule scan, K4 and their
small operations, launched), without the driver's read of n_ints, in us,
the mean over the traced round trips."""

from gpubench import program_spans


def read(ctx):
    ms = program_spans.mean_ms(ctx, {"wah.decode"})
    return None if ms is None else 1e3 * ms
