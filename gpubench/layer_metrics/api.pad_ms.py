"""The host copy of the bitmap to whole blocks in one WahCodec round trip:
the program's wah.compress.pad span (np.concatenate of the bitmap to
992-int blocks; compress only: decompress copies the stream as it is), in
ms, the mean over the traced round trips; 0 where nothing needed
padding."""

from gpubench import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, {"wah.compress.pad"})
