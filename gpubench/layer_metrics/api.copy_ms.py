"""Host-device copies of one WahCodec round trip (pageable H2D and D2H,
convert.words_to_tensor / tensor_to_words): to_device_ms + from_device_ms
of compress and of decompress, as the program's PhaseTimings give them,
in ms, the mean over the window's round trips."""


def read(ctx):
    if ctx is None:
        return None
    copies = [
        sum(op.counts[f"{side}.{p}"] for side in ("compress", "decompress")
            for p in ("to_device_ms", "from_device_ms"))
        for op in ctx.ops if op.name == "roundtrip"
    ]
    return sum(copies) / len(copies) if copies else None
