"""Closed loop through the public API, numpy in and out: one operation is
WahCodec.compress of a bitmap, then WahCodec.decompress of its stream
(out_ints = the bitmap's length). The inputs, drawn on the device and
handed to the API as host arrays, are cycled.

traffic params: "exponents": one bitmap per entry, bits set with
probability 2^-exponent.
"""
from __future__ import annotations

from gpubench import inputs
from gpubench.driver import Driver as Base
from gpubench.driver import parallel_map
from gpubench.reference import control, wah

PHASES = ("to_device_ms", "kernel_ms", "from_device_ms")


class Driver(Base):
    op_span = "api.roundtrip"

    def make_inputs(self) -> None:
        self.n = int(self.config["blocks"]) * int(self.config["block_ints"])
        g = inputs.generator(self.seed, self.device)
        self.bitmaps = [
            inputs.to_host_words(inputs.bernoulli_bitmap(self.n, int(e), g))
            for e in self.traffic["exponents"]
        ]

    def prepare(self) -> None:
        from wah_tpu_torch import WahCodec

        self.codec = WahCodec(self.device)
        for i in range(len(self.bitmaps)):
            self.step(i)

    def step(self, i: int):
        k = i % len(self.bitmaps)
        with self.span("api.compress"):
            stream, tc = self.codec.compress(self.bitmaps[k])
        with self.span("api.decompress"):
            out, td = self.codec.decompress(stream, out_ints=self.n)
        counts = {"bytes": 8 * self.n, "stream_words": len(stream), "input": k}
        for side, t in (("compress", tc), ("decompress", td)):
            for p in PHASES:
                counts[f"{side}.{p}"] = getattr(t, p)
        return "roundtrip", (k, stream, out), counts

    def control_step(self, i: int):
        k = i % len(self.bitmaps)
        stream = control.encode(self.bitmaps[k])
        out = control.decode(stream, self.n)
        return "roundtrip", (k, stream, out), {"bytes": 8 * self.n,
                                               "stream_words": len(stream), "input": k}

    def free(self) -> None:
        self.codec = None
        super().free()

    def check(self, ops, kept) -> dict:
        want = parallel_map(wah.encode, self.bitmaps)
        length_wrong = sum(op.counts["stream_words"] != len(want[op.counts["input"]]) for op in ops)
        stream_wrong = bitmap_wrong = 0
        for _, (k, stream, out) in kept:
            stream_wrong += wah.words_differing(stream, want[k])
            bitmap_wrong += wah.words_differing(out, self.bitmaps[k])
        return {
            "stream_length_wrong": (int(length_wrong), 0),
            "stream_words_wrong": (stream_wrong, 0),
            "bitmap_words_wrong": (bitmap_wrong, 0),
        }
