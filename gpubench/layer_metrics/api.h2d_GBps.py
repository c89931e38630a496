"""Host-to-device copies of the WahCodec round trips: the bytes counted by
the program's wah.compress.to_device and wah.decompress.to_device spans
(convert.words_to_tensor from pageable memory) over their host time, in
GB/s, over the traced round trips."""

from gpubench import program_spans


def read(ctx):
    return program_spans.rate_GBps(ctx, {"wah.compress.to_device", "wah.decompress.to_device"})
