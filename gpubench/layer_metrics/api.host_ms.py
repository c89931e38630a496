"""Host time of one WahCodec round trip outside the six phases that the
program times itself (PhaseTimings of compress and of decompress:
to_device, kernel, from_device): padding, the stream's check on the
device and its read, and allocation. The benchmark's host clock per
round trip minus the phases, in ms, the mean over the window's round
trips."""

from gpubench.drivers.api_roundtrip import PHASES


def read(ctx):
    if ctx is None:
        return None
    rest = [
        (op.t1 - op.t0) * 1e3 - sum(op.counts[f"{side}.{p}"]
                                    for side in ("compress", "decompress") for p in PHASES)
        for op in ctx.ops if op.name == "roundtrip"
    ]
    return sum(rest) / len(rest) if rest else None
