"""Closed loop on device-resident bitmaps: the calls WahCodec makes, without
its host preparation and copies. One operation: encode_padded(stitch="v3")
(K1, the count scan, K2), the host read of the stream's total, decode
(K3, the granule scan, K4), the host read of n_ints. The inputs are
cycled.

traffic params: "exponents": one bitmap per entry, bits set with
probability 2^-exponent.
"""
from __future__ import annotations

import torch

from gpubench import inputs
from gpubench.driver import Driver as Base
from gpubench.driver import parallel_map
from gpubench.reference import control, wah


class Driver(Base):
    op_span = "device.roundtrip"

    def make_inputs(self) -> None:
        self.n = int(self.config["blocks"]) * int(self.config["block_ints"])
        g = inputs.generator(self.seed, self.device)
        self.exponents = [int(e) for e in self.traffic["exponents"]]
        self.bitmaps = [inputs.bernoulli_bitmap(self.n, e, g) for e in self.exponents]
        chunks = -(-self.n // 31) * 32
        self.n_chunks = chunks
        self.capacity = -(-chunks // 1024) * 1024

    def prepare(self) -> None:
        from wah_tpu_torch.ops.cuda import decode_kernel, encode_kernel

        self.kernels = (encode_kernel, decode_kernel)
        # one operation an input, then as many outputs held as the check
        # keeps, so that the window allocates from the cache
        held = [self.step(i)[1] for i in range(len(self.bitmaps) + int(self.traffic["check_sample"]))]
        del held
        self.sync()

    def step(self, i: int):
        k = i % len(self.bitmaps)
        x = self.bitmaps[k]
        ek, dk = self.kernels
        with self.span("device.encode"):
            words, total = ek.encode_padded(x, self.n_chunks, stitch="v3")
            m = int(total)
        with self.span("device.decode"):
            ints, n_ints = dk.decode(words, m, self.capacity)
            n_out = int(n_ints)
        counts = {"bytes": 8 * self.n, "n_ints": self.n, "total": m, "n_out": n_out, "input": k}
        return "roundtrip", (k, words, m, ints, n_out), counts

    def control_step(self, i: int):
        k = i % len(self.bitmaps)
        x = inputs.to_host_words(self.bitmaps[k])
        words = control.encode(x)
        ints = control.decode(words, self.n)
        counts = {"bytes": 8 * self.n, "n_ints": self.n, "total": len(words),
                  "n_out": len(ints), "input": k}
        return "roundtrip", (k, words, len(words), ints, len(ints)), counts

    def free(self) -> None:
        self.kernels = None
        super().free()

    def check(self, ops, kept) -> dict:
        hosts = [inputs.to_host_words(b) for b in self.bitmaps]
        want = parallel_map(wah.encode, hosts)
        total_wrong = sum(op.counts["total"] != len(want[op.counts["input"]]) for op in ops)
        n_wrong = sum(op.counts["n_out"] != self.n for op in ops)
        stream_wrong = bitmap_wrong = 0
        for _, (k, words, m, ints, n_out) in kept:
            got = words[:m].cpu().numpy() if isinstance(words, torch.Tensor) else words[:m]
            stream_wrong += wah.words_differing(got, want[k])
            out = ints[:n_out].cpu().numpy() if isinstance(ints, torch.Tensor) else ints[:n_out]
            bitmap_wrong += wah.words_differing(out, hosts[k])
        return {
            "total_wrong": (int(total_wrong), 0),
            "n_ints_wrong": (int(n_wrong), 0),
            "stream_words_wrong": (stream_wrong, 0),
            "bitmap_words_wrong": (bitmap_wrong, 0),
        }
