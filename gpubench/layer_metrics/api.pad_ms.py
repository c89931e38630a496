"""The host copies to whole blocks in one WahCodec round trip: the
program's wah.compress.pad and wah.decompress.pad spans (np.concatenate
of the bitmap to 992-int blocks, of the stream to 1024-word blocks), in
ms, the mean over the traced round trips; 0 where nothing needed
padding."""

from gpubench import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, {"wah.compress.pad", "wah.decompress.pad"})
