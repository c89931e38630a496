"""Closed loop on one bitmap block-sharded over the ranks, device-resident:
the calls ShardedCodec makes, through the public functions of
wah_tpu_torch.parallel, without its host copies. One operation, on every
rank, in the benchmark's spans:

  sharded.encode  encode_sharded of this rank's shard (K1, the count scan,
                  K2; the totals gathered), then stitch_word_cap, whose
                  host read of the totals ends the encode on the device;
  sharded.stitch  stitch_global bounded by that cap (the payload gathered,
                  compacted by K2, the host read of the stream's end), and
                  the host read of the stream's total;
  sharded.decode  decode_sharded of this rank's span of the replicated
                  stream (K3, the granule scan, K4);
  sharded.gather  the all-gather of the ranks' spans (_comm.all_gather),
                  cut to the bitmap's n ints: the operation ends with the
                  whole bitmap on this rank, in stream order.

The bitmaps are cycled. Every rank ends an operation with the whole
stream and the whole bitmap; rank 0 returns both for the check.

The host waits for the device only where the operation itself reads a
number (the totals, the stream's end, its total). The decode's chunk
count is compared on the device, and the gather is not waited for: the
host issues the next operation's encode behind it, and that operation's
read of its totals waits for both. So the host's issue time between two
operations is hidden behind the gather, and a host slowed by its
neighbours moves the rate less. The window's last gather may end up to
one operation after the window's clock stops (under 0.1% of a 51 s
window). While a trace is taken the host waits at the end of the decode
and of the gather too, so that each span holds its own device time.

config: "ints" (n), "p_bit", "ranks" (the cell's chips). traffic:
"bitmaps", how many bitmaps are cycled.

Inputs: every bit set independently with probability p_bit (a float32
uniform below it, so to 2^-24). The bitmap is padded with zero ints to
nb blocks of 992 ints, nb the blocks of its chunks rounded up to a
multiple of the ranks; rank r holds blocks [r nb_l, (r + 1) nb_l) and
draws their live ints on its own device from a generator seeded by
(seed, r, bitmap).

check (rank 0, after the window): each bitmap drawn again on rank 0's
device, shard by shard from the same seeds, and its stream by the plain
reference gpubench/reference_torch/wah_torch on that device. Every
operation's total against the reference's, and its chunk count
against the bitmap's (counted on the device); each kept
operation's whole stream word for word, and its whole gathered bitmap,
which holds every rank's decode, against the input; the operations whose
stitch raised the overflow flag. All limits 0.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from gpubench import inputs
from gpubench.driver import Driver as Base
from gpubench.driver import parallel_map
from gpubench.reference import control
from gpubench.reference_torch import wah_torch

BLOCK_INTS = wah_torch.BLOCK_INTS
BLOCK_CHUNKS = wah_torch.BLOCK_CHUNKS
DRAW_INTS = 1 << 22  # ints drawn a call: 512 MB of float32 uniforms
CONTROL_INTS = (1 << 14) * BLOCK_INTS  # the control's pieces, whole blocks
# bit j of an int32 word, as its int32 value
BIT_VALUES = [1 << j for j in range(31)] + [-(1 << 31)]


def draw_shard(out: torch.Tensor, seed: int, rank: int, bitmap: int, live: int,
               p: float) -> torch.Tensor:
    """Fill the int32 tensor `out`: `live` ints with every bit set with
    probability p, drawn on its device from the generator of (seed, rank,
    bitmap), then zeros. Returns `out`."""
    g = inputs.generator((seed * 1000003 + rank) * 1009 + bitmap, out.device)
    bits = torch.tensor(BIT_VALUES, dtype=torch.int32, device=out.device)
    out[live:] = 0
    for lo in range(0, live, DRAW_INTS):
        m = min(DRAW_INTS, live - lo)
        u = torch.rand((m, 32), generator=g, device=out.device)
        out[lo : lo + m] = torch.where(u < p, bits, 0).sum(1, dtype=torch.int32)
    return out


def on(t, device) -> torch.Tensor:
    """An output (tensor, or the control's uint32 array) as int32 on device."""
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t, dtype=np.uint32).view(np.int32))
    return t.to(device)


class Driver(Base):
    op_span = "sharded.roundtrip"

    def make_inputs(self) -> None:
        if int(self.config["ranks"]) != self.world:
            raise ValueError(f"{self.config['ranks']} ranks configured, {self.world} running")
        self.n = int(self.config["ints"])
        self.p = float(self.config["p_bit"])
        self.n_chunks = -(-self.n // 31) * 32
        blocks = -(-self.n_chunks // BLOCK_CHUNKS)
        self.nb = -(-blocks // self.world) * self.world
        self.n_l = self.nb // self.world * BLOCK_INTS
        self.n_bitmaps = int(self.traffic["bitmaps"])
        self.shards = [self.shard(self.rank, k, torch.empty(self.n_l, dtype=torch.int32,
                                                            device=self.device))
                       for k in range(self.n_bitmaps)]
        self.overflows = torch.zeros((), dtype=torch.int64, device=self.device)
        self.chunks_wrong = torch.zeros((), dtype=torch.int64, device=self.device)

    def live(self, rank: int) -> int:
        """Ints of the bitmap in rank `rank`'s shard; the rest is padding."""
        return max(0, min(self.n_l, self.n - rank * self.n_l))

    def shard(self, rank: int, k: int, out: torch.Tensor) -> torch.Tensor:
        return draw_shard(out, self.seed, rank, k, self.live(rank), self.p)

    def bitmap(self, k: int) -> torch.Tensor:
        """Bitmap k, all of it, drawn again shard by shard on this device."""
        out = torch.empty(self.world * self.n_l, dtype=torch.int32, device=self.device)
        for r in range(self.world):
            self.shard(r, k, out[r * self.n_l : (r + 1) * self.n_l])
        return out[: self.n]

    def prepare(self) -> None:
        from wah_tpu_torch import parallel
        from wah_tpu_torch.parallel import _comm

        self.par, self.comm = parallel, _comm
        # one operation a bitmap, then as many as the check keeps, rank 0
        # holding their outputs as the window's sample does, so that the
        # window allocates from the cache
        sample = int(self.traffic["check_sample"])
        held = collections.deque(maxlen=sample if self.rank == 0 else 0)
        for i in range(self.n_bitmaps + sample):
            held.append(self.step(i)[1])
        del held
        self.sync()
        self.overflows.zero_()
        self.chunks_wrong.zero_()

    def step(self, i: int):
        k = i % self.n_bitmaps
        par = self.par
        with self.span("sharded.encode"):
            words_l, totals = par.encode_sharded(self.shards[k], self.n_chunks)
            cap = par.stitch_word_cap(totals)
        with self.span("sharded.stitch"):
            stream, total, overflow = par.stitch_global(words_l, totals, cap)
            m = int(total)
        del words_l
        self.overflows += overflow
        with self.span("sharded.decode"):
            ints_l, n_chunks = par.decode_sharded(stream, m, self.nb * BLOCK_CHUNKS)
            self.chunks_wrong += n_chunks != self.n_chunks
            self.span_end()
        with self.span("sharded.gather"):
            bitmap = self.comm.all_gather(ints_l).reshape(-1)[: self.n]
            self.span_end()
        counts = {"bytes": 8 * self.n, "n_ints": self.n, "n_l": self.n_l,
                  "n_0": self.live(0), "total": m, "input": k}
        if self.span.active:  # rank 0's part of the stream, for the traced metrics
            counts["total_0"] = int(totals[0])
        return "roundtrip", (k, stream[:m], bitmap), counts

    def control_step(self, i: int):
        k = i % self.n_bitmaps
        x = inputs.to_host_words(self.bitmap(k))
        pieces = [x[lo : lo + CONTROL_INTS] for lo in range(0, x.shape[0], CONTROL_INTS)]
        streams = parallel_map(control.encode, pieces)
        ints = parallel_map(lambda a: control.decode(a[0], a[1].shape[0]), zip(streams, pieces))
        words = np.concatenate(streams)
        counts = {"bytes": 8 * self.n, "n_ints": self.n, "n_l": self.n_l, "n_0": self.live(0),
                  "total": words.shape[0], "input": k}
        return "roundtrip", (k, words, np.concatenate(ints)), counts

    def span_end(self) -> None:
        """While a trace is taken, wait for the device: the span then holds
        its own device time. Otherwise the host issues on."""
        if self.span.active:
            self.sync()

    def free(self) -> None:
        self.shards = self.par = self.comm = None
        super().free()

    def check(self, ops, kept) -> dict:
        # the reference stream stays in its pieces, and comparisons go a
        # slice at a time: beside the kept outputs rank 0 holds the bitmap
        # and its stream once
        total_wrong = stream_wrong = bitmap_wrong = 0
        for k in range(self.n_bitmaps):
            x = self.bitmap(k)
            want = wah_torch.encode_pieces(x)
            total = sum(p.shape[0] for p in want)
            total_wrong += sum(op.counts["total"] != total for op in ops
                               if op.counts["input"] == k)
            for _, (kk, words, bitmap) in kept:
                if kk == k:
                    stream_wrong += wah_torch.stream_differing(on(words, self.device), want)
                    bitmap_wrong += wah_torch.words_differing(on(bitmap, self.device), x)
            del x, want
        return {
            "total_wrong": (int(total_wrong), 0),
            "chunks_wrong": (int(self.chunks_wrong), 0),
            "stream_words_wrong": (stream_wrong, 0),
            "bitmap_words_wrong": (bitmap_wrong, 0),
            "overflow": (int(self.overflows), 0),
        }
