"""Device-to-host copies of the WahCodec round trips: the bytes counted by
the program's wah.compress.from_device and wah.decompress.from_device
spans (the host read of the length, then convert.tensor_to_words into
pageable memory) over their host time, in GB/s, over the traced round
trips."""

from gpubench import program_spans


def read(ctx):
    return program_spans.rate_GBps(ctx, {"wah.compress.from_device",
                                         "wah.decompress.from_device"})
