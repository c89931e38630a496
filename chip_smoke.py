"""Smoke test of the torch port (wah_tpu_torch) on one NVIDIA GPU.

Run from the repository root: `python3 chip_smoke.py`. It needs one CUDA
device, nvcc (PATH, CUDA_HOME or /usr/local/cuda) and no network, and
imports nothing of JAX or wah_tpu. Phases, one or more lines each:

  1. device   the card's name and power limit, as nvidia-smi reports them
  2. build    nvcc builds kernels K1-K6, T1 and V1 from wah_tpu_torch/csrc/
  3. kernels  each kernel against its plain torch version on the card, at
              the main path's shapes (32,768 blocks, the 130 MB protocol),
              K6 also on the all-zero 130 MB bitmap's staging and on
              offset edge cases, V1 also with a bad last word: bit-exact,
              tolerance 0 (an integer codec)
  3b. batch   the batched encode (K1 with a per-column position mask, K2
              with per-row counts) and decode (K3 with per-column valid
              counts, K4 with the mask) against their plain twins at the
              query benchmark's shape: 16 columns x 8,192 blocks, 2^-8
  3c. fused   K5 (encode_fused) against its plain version and against the
              K1 + K2 pipeline: the protocol, all-zero, all-one, clustered,
              one block, an odd block count, block counts around its tile
              size and its persistent grid, a chunk base with a clamped
              bound and with the bound inside a tile, every block past the
              bound, 262,144 blocks (992 MB), ten and two launches in a row
  3d. scans   T1's kernel (rows_scan: the kernels' shared block scans and
              warp search) against torch.cumsum / cummax / searchsorted at
              (4, 2048) and (32768, 2048), with ties in the search; 1, 3 and
              many rows, 0 to 300 keys, spans inside the row, mixed sign and
              INT_MIN rows
  3e. hazards K1 and K4, whose CTAs walk several blocks, at block counts
              that are no multiple of their grids (1, 2, 263, 265, 32,767)
              with a bound that ends inside the last block; K4 with capacity
              past the stream's end and with a chunk base; K4 over batched
              columns of which one fills its capacity exactly and one is
              all-zero; both at 262,144 blocks (992 MB); each == plain
  4. codec    WahCodec("cuda").compress / .decompress: the bench protocol
              (stream == golden, in full), clustered, all-zero, all-one,
              odd sizes, tiny, empty, and the 992 MB sweep size (stream ==
              the plain torch encode on the card); every case round-trips
  4b. queries the index queries at the query shape: k = 4 and 16 OR and
              AND folds, a pairwise AND (~2^-16, stitched by K2; K6 must
              not run), NOT; each == the plain pipeline on the card and ==
              golden.encode of the numpy result
  4c. index   BitmapIndex over TPC-H SF10 lineitem.l_quantity (59,986,052
              rows, 50 values): TPC-H Q6's and Q19's quantity ranges, a
              membership, a NOT and a disjoint AND (K2); every stream ==
              golden, every count == numpy, rows == numpy
  4d. segments  compress_segments / decompress_segments of a bitmap past
              the int32 position cap: 66 copies of the protocol bitmap
              (8.58 GB; a plain compress must raise), stream == 66 golden
              copies, round trip; compress_batch_segments /
              decompress_batch_segments of BASELINE.json configs[3]'s
              columns (1 Gbit each, P(bit) = 0.01; BATCH_COLUMNS of its 256),
              every stream == golden, round trip
  4e. differential  wah_tpu_torch.differential.run on the card, full matrix
  4f. cli     python3 -m wah_tpu_torch compress / info / decompress / logical
              as subprocesses on temporary files, outputs against numpy
  4g. sharded wah_tpu_torch.parallel: ShardedCodec("cuda") in a one-rank
              NCCL group on the protocol (== golden) and on BASELINE.json
              configs[4] (2,000,000,000 ints, 64e9 bits, P(bit) = 0.01; ==
              the golden streams of its pieces), both round-tripped; `python
              -m wah_tpu_torch.parallel 2 --device cuda` (two gloo ranks on
              one card, gathers staged through host memory) on the dry-run
              bitmap and the protocol; the bodies of 8 ranks at 12 and 263
              blocks a rank (== golden, spans == the input); the gathered
              payload bytes at 2^-4 and 2^-8 (== benchmarks/scaling_model.json),
              a word_cap that overflows and its exact retry; stitch_global's
              CUDA-event ms and ShardedCodec's host-clock ms beside WahCodec's
  5. counts   every kernel of each main path (phases 3d, 4, 4b-4e, 4g)
              launched in that path's own run
  6. times    CUDA-event milliseconds of each kernel and pipeline against
              the plain versions: the 130 MB protocol, K6 against K2 on
              two stagings, the query folds; K1 and K4 also on the query
              shape's batched columns; K5 beside the K1 + cumsum + K2
              pipeline; T1's kernel beside the torch scans; K2 and K6
              beside torch.masked_select; V1 beside the torch compare and
              sum calls, also on the 992 MB sweep bitmap's stream (2^-4,
              ~1.07 GB); each kernel's bound from this run's bytes; host-clock seconds of the index build, of Q6
              and of the segment paths through the API
  6b. profiling  wah_tpu_torch.utils.profiling on the protocol: K1-K4 and
              the encode and decode pipelines timed by amortized_seconds
              (one call captured in a CUDA graph, replayed K times) beside
              phase 6's eager CUDA-event ms and the host's time to issue
              one eager call, each replayed output == the eager one word
              for word; one WahCodec() compress and
              decompress traced by profiling.trace: the device-busy share
              of the traced window and the five device operations that took
              the most time; steps that a capture must refuse (a host read)
  6c. copies  the yardstick of wah_tpu_torch.convert's pinned staging ring
              on the 992 MB sweep bitmap: the copy engine's GB/s from
              pinned memory, whole and in 4-64 MiB chunks; the pageable
              copies without the ring; the host's copies between pageable
              and pinned memory, into warm and into fresh pages, on torch's
              intra-op threads and on one thread; the staged copies at 2
              and 3 buffers of 8-128 MiB, a buffer a chunk (words checked);
              one copy of 64 KiB to 32 MiB staged and direct, in us

Any failure raises, so the exit code is not 0 and no result line is
printed. The second-to-last line is {"kernels": [...]}, the last
{"ok": true, "device": {...}}.

For work on a kernel, `python3 chip_smoke.py --kernels [--profile]` runs
only phases 1-3e and the kernel and pipeline times of phases 6 and 6b
(about a minute) and prints no result lines; `--profile` adds
torch.profiler's per-kernel device times over a few launches, taken
through profiling.trace. `python3 chip_smoke.py --copies` runs only
phases 1 and 6c (about two minutes). To time another tree of the
port in the same call (two versions compare only within one call, on one
card), copy this script into that tree and run it there.
"""
from __future__ import annotations

import contextlib
import json
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

PROTOCOL_BLOCKS = 32768  # 130 MB bitmap: the bench protocol (bench.py)
SWEEP_MAX_BLOCKS = 262144  # 992 MB: the reference sweep's largest size (s = 256)
SEED = 1337
# the query benchmark's shape (benchmarks/query_bench.py:37-40): 32.5 MB columns, 2^-8
QUERY_COLUMNS, QUERY_BLOCKS, QUERY_ANDS = 16, 8192, 8
# TPC-H SF10 lineitem: 59,986,052 rows, l_quantity uniform in 1..50 (spec clause 4.2.3)
LINEITEM_ROWS, QUANTITIES = 59_986_052, 50

# the any-size paths: 66 protocol bitmaps (2,162,688 blocks, 8.58 GB, past the
# 2^31 - 1 chunk cap of one call) in the API's default segments; and the
# columns of BASELINE.json configs[3] (256 x 1 Gbit, P(bit) = 0.01) in the
# API's default batch segments, from a pool of distinct columns. 128 of the
# 256 columns: the API takes and returns host arrays, and 256 columns are
# 32 GB in, 32 GB out and ~15 GB of streams, more than a 96 GiB host holds
# beside the temporaries
SEGMENT_COPIES, SEGMENT_INTS = 66, 992 << 18
BATCH_COLUMNS, BATCH_COLUMN_INTS, BATCH_SEGMENT_INTS = 128, 31_250_000, 992 << 13
BATCH_POOL, BATCH_DENSITY = 4, 0.01
SCAN_ROWS, SCAN_KEYS = 32768, 64  # T1 at full width: 268 MB of int32 rows
CLI_INTS = 1_000_000  # 4 MB files for the CLI phase
# BASELINE.json configs[4], "a 64e9-bit bitmap sharded ... ordered gather,
# bit-exact stitched output": 2e9 ints (2,016,130 blocks, just under the
# 2^31 - 1 chunk cap of one call) at P(bit) = 0.01, made of CONFIG4_POOL
# distinct pieces of PROTOCOL_BLOCKS blocks and a partial last piece
CONFIG4_INTS, CONFIG4_DENSITY, CONFIG4_POOL = 2_000_000_000, 0.01, 4
# shard shapes that are no multiple of K1's or K4's walk (tests/test_dist.py:141)
SHARD_RANKS, SHARD_BLOCKS = 8, (12, 263)
# the stitch payloads of benchmarks/scaling_model.py: 32,768 blocks, seed 1337
PAYLOAD_BLOCKS, PAYLOAD_EVERY_N = 32768, (16, 256)

# Published peaks of one H100 SXM: 3.35 TB/s of HBM3, 67 T 32-bit
# operations a second outside the tensor cores
PEAK_BYTES_PER_S, PEAK_OPS_PER_S = 3.35e12, 67e12
# rough instruction counts per element (chunk or word) of each kernel: they
# only show which of the two bounds is the larger
OPS_PER_ELEMENT = {"encode_tiles": 60, "stitch_tiles_v2": 4, "prescan_words": 8,
                   "decode_blocks": 80, "stitch_tiles": 12, "encode_fused": 64, "rows_scan": 40,
                   "check_stream": 8}

# (name, source, TPU kernel replaced)
KERNELS = [
    ("encode_tiles", "wah_tpu_torch/csrc/encode.cu", "wah_tpu/ops/pallas/encode_kernel.py:323"),
    ("stitch_tiles_v2", "wah_tpu_torch/csrc/stitch.cu", "wah_tpu/ops/pallas/stitch2.py:250"),
    ("prescan_words", "wah_tpu_torch/csrc/decode.cu", "wah_tpu/ops/pallas/decode_kernel.py:686"),
    ("decode_blocks", "wah_tpu_torch/csrc/decode.cu", "wah_tpu/ops/pallas/decode_kernel.py:470"),
    ("stitch_tiles", "wah_tpu_torch/csrc/stitch_gather.cu", "wah_tpu/ops/pallas/encode_kernel.py:504"),
    ("encode_fused", "wah_tpu_torch/csrc/encode_fused.cu", "wah_tpu/ops/pallas/encode_kernel.py:713"),
    ("rows_scan", "wah_tpu_torch/csrc/scan_check.cu", "tests/test_pallas.py:196"),
    ("check_stream", "wah_tpu_torch/csrc/stream_check.cu",
     "none: wah_tpu checks and counts a stream on the host (wah_tpu/api.py checked_stream)"),
]


def bench_bitmap(n_ints: int, seed: int = SEED) -> np.ndarray:
    """The bench protocol bitmap (bench.py:41-48): P(bit) = 2^-4."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 16, size=(n_ints, 32), dtype=np.uint8) == 0
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32).reshape(-1)


def sparse_bitmap(n_ints: int, seed: int = SEED, ands: int = 4) -> np.ndarray:
    """P(bit) = 2^-ands as the AND of `ands` uniform words (4: the
    protocol's distribution without its 32x byte-per-bit intermediate)."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 1 << 32, size=n_ints, dtype=np.uint32)
    for _ in range(ands - 1):
        out &= rng.integers(0, 1 << 32, size=n_ints, dtype=np.uint32)
    return out


def bernoulli_bitmap(n_ints: int, density: float, seed: int) -> np.ndarray:
    """P(bit) = density, each bit independent: the set bits' positions are
    the running sum of geometric gaps (no per-bit random number)."""
    rng = np.random.default_rng(seed)
    nbits = n_ints * 32
    k = int(nbits * density + 8 * (nbits * density) ** 0.5 + 64)
    pos = np.cumsum(rng.geometric(density, size=k)) - 1
    if pos[-1] < nbits:
        raise AssertionError("bernoulli_bitmap: too few gaps drawn")
    pos = pos[pos < nbits]
    # the positions are distinct, so the sum of their bit values is their OR
    words = np.bincount(pos >> 5, weights=(1 << (pos & 31)).astype(np.float64), minlength=n_ints)
    return words.astype(np.uint32)


def generate_random_data(n_ints: int, every_n: int, seed: int = 1337) -> np.ndarray:
    """Bernoulli bitmap with P(bit set) = 1/every_n (reference
    generateRandomData, tests.cpp:42-64, fixed seed 1337).

    Generated in slabs: the naive (n, 32) int64 draw would need ~66 GB
    for the 992 MB sweep config. PCG64 consumes its bit stream value by
    value, so slab-wise draws produce the identical bitmap (pinned by
    tests/test_report.py)."""
    rng = np.random.default_rng(seed)
    out = np.empty(n_ints, dtype=np.uint32)
    slab = 1 << 21
    for lo in range(0, n_ints, slab):
        hi = min(lo + slab, n_ints)
        bits = rng.integers(0, every_n, size=(hi - lo, 32), dtype=np.int64) == 0
        out[lo:hi] = (
            np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")
            .view(np.uint32)
            .reshape(-1)
        )
    return out


def mask_bitmap(mask: np.ndarray) -> np.ndarray:
    """Row mask -> uint32 bitmap (bit r = row r), zero-padded to whole ints."""
    padded = np.zeros(-(-mask.shape[0] // 32) * 32, np.uint8)
    padded[: mask.shape[0]] = mask
    return np.packbits(padded, bitorder="little").view(np.uint32)


def clustered_bitmap(n_ints: int, seed: int, a: float) -> np.ndarray:
    """Zipfian clustered runs (tests/conftest.py:39-54)."""
    g = np.random.default_rng(seed)
    total_bits = n_ints * 32
    runs, acc, val = [], 0, 0
    while acc < total_bits:
        ln = max(min(int(g.zipf(a)) * 31, total_bits - acc), 1)
        runs.append((val, ln))
        acc += ln
        val ^= 1
    bits = np.concatenate([np.full(ln, v, dtype=np.uint8) for v, ln in runs])
    return np.packbits(bits, bitorder="little").view(np.uint32).reshape(-1)


def device_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def exact(name: str, got, want) -> int:
    """Raise unless the two int32 tensors are equal; return max |got - want|."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err:
        raise AssertionError(f"{name}: max_abs_err {err} (tolerance 0)")
    return err


def same_stream(name: str, got: np.ndarray, want: np.ndarray) -> None:
    if got.shape != want.shape or not np.array_equal(got, want):
        diff = np.flatnonzero(got[: len(want)] != want[: len(got)])
        first = int(diff[0]) if diff.size else min(len(got), len(want))
        raise AssertionError(f"{name}: {len(got)} words vs {len(want)}, first differing word {first}")


def stitch_case(counts, seed: int, cuda):
    """Staging rows of random nonzero words with the given per-row counts,
    and their exclusive offsets (nb+1,), on the card."""
    import torch

    counts = np.asarray(counts, np.int64)
    rng = np.random.default_rng(seed)
    staging = rng.integers(1, 2**31 - 1, size=(len(counts), 1024)).astype(np.int32)
    staging[np.arange(1024)[None, :] >= counts[:, None]] = 0
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return torch.from_numpy(staging).to(cuda), torch.from_numpy(offsets).to(cuda)


def check_k6(name: str, staging, offsets_ext) -> int:
    """K6 against its plain version: bit-exact up to the total, and zero from
    there to the end of the last tile that holds words."""
    from wah_tpu_torch.ops.cuda import encode_kernel as ek
    from wah_tpu_torch.ops.cuda import stitch2

    total = int(offsets_ext[-1])
    end = -(-total // 1024) * 1024
    got = ek.stitch_tiles(staging, offsets_ext)
    want = stitch2.stitch_tiles_plain(staging, offsets_ext)
    if want[total:end].any():
        raise AssertionError(f"K6 {name}: plain version not zero past the total")
    return exact(f"K6 {name} (total {total})", got[:end], want[:end])


def cuda_ms(fn, iters: int) -> float:
    """Mean CUDA-event milliseconds of fn() over `iters` runs after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(iters):
        fn()
    ev1.record()
    ev1.synchronize()
    return ev0.elapsed_time(ev1) / iters


def check_stream_library(w, m: int):
    """[first_bad, n_chunks] of w[:m] (int32) by torch calls alone: the
    yardstick for V1, used nowhere in the port."""
    import torch

    w = w[:m]
    length = w & 0x3FFFFFFF
    fill = w < 0
    bad = (w == 0) | (w == 0x7FFFFFFF) | (fill & ((length < 1) | (length > 1024)))
    return bad.any(), bad.int().argmax(), torch.where(fill, length, 1).sum(dtype=torch.int64)


def host_issue_ms(fn, iters: int) -> float:
    """Host-clock milliseconds to issue one fn() (its launches queued, not
    run): the mean of `iters` calls after one warm-up, read before the
    device is waited for. An eager time near this is bound by the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def main() -> None:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="only phases 1-3e and the kernel times of phase 6; no result lines")
    ap.add_argument("--copies", action="store_true",
                    help="only phase 1 and the host-device copy yardstick of phase 6c")
    ap.add_argument("--profile", action="store_true",
                    help="with --kernels: torch.profiler's device times of a few launches")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the GPU")
    if args.copies:
        card = device_line()
        print(f"[1 device] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
        with Phase("6c copies"):
            phase_copies(torch.device("cuda"), card)
        return
    run(torch.device("cuda"), kernels_only=args.kernels, profile=args.profile)


class Phase:
    """Prints a phase's wall time when it ends (after a device sync)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if exc[0] is None:
            torch.cuda.synchronize()
            print(f"[{self.name}] wall {time.perf_counter() - self.t0:.2f} s", flush=True)


def run(cuda, kernels_only: bool = False, profile: bool = False) -> None:
    """All phases on the CUDA device `cuda`; with `kernels_only` the kernel
    checks and times alone, without the result lines."""
    import torch

    from wah_tpu_torch.ops.cuda import _build
    from wah_tpu_torch.ops.cuda import decode_kernel as dk
    from wah_tpu_torch.ops.cuda import encode_kernel as ek
    from wah_tpu_torch.ops.cuda import scan_check, stitch2
    from wah_tpu_torch.ops.cuda import stream_check as sc

    wrappers = {w.__name__: w for w in (ek.encode_tiles, stitch2.stitch_tiles_v2,
                                        dk.prescan_words, dk.decode_blocks, ek.stitch_tiles,
                                        ek.encode_fused, scan_check.rows_scan, sc.check_stream)}

    # 1. device
    card = device_line()
    print(f"[1 device] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    print(f"[2 build] {time.perf_counter() - t0:.2f} s -> {_build.library_path().name}")
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"    {line.strip()}")

    counts = {}  # main path -> {kernel: launches in that path's own run}

    def main_path(name, expected, fn):
        """Drive one main path with every count set to 0 just before it;
        read the counts just after, and fail if a kernel of it never ran."""
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts[name] = {k: w.launches for k, w in wrappers.items()}
        missing = [k for k in expected if counts[name][k] == 0]
        print(f"[5 counts] {name}: {counts[name]}", flush=True)
        if missing:
            raise AssertionError(f"{name}: kernels never launched on the main path: {missing}")
        return out

    with Phase("3 kernels"):
        errs, proto = phase_kernels(cuda)
    with Phase("3b batch"):
        query = phase_batch(cuda, errs)
    with Phase("3c fused"):
        phase_fused(cuda, errs, proto)
    with Phase("3d scans"):
        scans = phase_scans(cuda, errs, main_path)
    with Phase("3e hazards"):
        phase_hazards(cuda, errs, proto)
    if kernels_only:
        with Phase("6 times"):
            ms, _ = phase_kernel_times(cuda, card, proto, query, scans, profile)
        print_bounds(card, ms, kernel_bounds(proto, scans))
        with Phase("6b profiling"):
            phase_profiling(cuda, card, proto, ms)
        return
    with Phase("4 codec"):
        ratio, proto["golden"] = main_path(
            "codec", list(wrappers)[:4] + ["check_stream"],
            lambda: phase_codec(cuda, proto["data"]))
    with Phase("4b queries"):
        phase_queries(cuda, query, main_path)
    with Phase("4c index"):
        index_times = phase_index(cuda, main_path)

    with Phase("4d segments"):
        segment_times = phase_segments(cuda, proto, main_path)
    with Phase("4e differential"):
        phase_differential(cuda, main_path)
    with Phase("4f cli"):
        phase_cli()
    with Phase("4g sharded"):
        phase_sharded(cuda, card, proto, main_path)

    # 5. launch counts of the main paths
    launches = {k: sum(c[k] for c in counts.values()) for k in wrappers}
    print(f"[5 counts] all main paths: {launches}")

    with Phase("6 times"):
        ms, library_ms = phase_kernel_times(cuda, card, proto, query, scans)
        phase_host_times(cuda, card, index_times, segment_times)
    print(f"[6 times] compression ratio (words / ints): {ratio}")
    bounds = kernel_bounds(proto, scans)
    print_bounds(card, ms, bounds)
    with Phase("6b profiling"):
        phase_profiling(cuda, card, proto, ms)
    with Phase("6c copies"):
        phase_copies(cuda, card)

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": ms[name][0], "plain_ms": ms[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": library_ms.get(name)}
        for name, src, rep in KERNELS
    ]
    print(f"[7 host] peak resident memory of this process "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.1f} GB")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def print_bounds(card, ms, bounds) -> None:
    for name, (bound_ms, by, nbytes) in bounds.items():
        print(f"[6 times] {name}: bound {bound_ms:.4f} ms by {by} ({nbytes / 1e6:.1f} MB moved at "
              f"{PEAK_BYTES_PER_S / 1e12} TB/s), measured {ms[name][0]:.4f} ms = "
              f"{bound_ms / ms[name][0]:.0%} of the bound's rate, on {card}")


def kernel_bounds(proto, scans):
    """name -> (bound ms, "bytes" or "operations", bytes): the least time the
    card could take at the shapes timed in phase 6, the larger of this run's
    bytes (each input read once, each output written once; for the stitches
    and K5 only the words this data produces) over the memory rate and a
    rough count of its operations over the 32-bit rate."""
    p = proto
    nb, total, rows = PROTOCOL_BLOCKS, p["m"], p["rows"]
    chunks = nb * 1024
    x, keys = scans["x"], scans["keys"]
    work = {  # name: (bytes, elements)
        "encode_tiles": (nb * 992 * 4 + 12 + chunks * 4 + nb * 4, chunks),
        "stitch_tiles_v2": (2 * total * 4 + (nb + 1) * 4, total),
        "stitch_tiles": (2 * total * 4 + (nb + 1) * 4, total),
        "prescan_words": (2 * p["stream"].numel() * 4 + 2 * rows * 4, p["stream"].numel()),
        "decode_blocks": (p["stream"].numel() * 4 + rows * 4 + 16 + p["nbo"] * 992 * 4,
                          p["nbo"] * 1024),
        "encode_fused": (nb * 992 * 4 + 8 + total * 4 + nb * 4, chunks),
        "rows_scan": (3 * x.numel() * 4 + 2 * keys.numel() * 4, x.numel()),
        "check_stream": (total * 4 + 16, total),
    }
    out = {}
    for name, (nbytes, elements) in work.items():
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = elements * OPS_PER_ELEMENT[name] / PEAK_OPS_PER_S * 1e3
        out[name] = (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", nbytes)
    return out


def phase_kernels(cuda):
    """3. Each kernel against its plain version at the protocol's shapes;
    K6 also on the all-zero bitmap's staging and on offset edge cases."""
    import torch

    from wah_tpu_torch import golden
    from wah_tpu_torch.convert import words_to_tensor
    from wah_tpu_torch.ops.cuda import decode_kernel as dk
    from wah_tpu_torch.ops.cuda import encode_kernel as ek
    from wah_tpu_torch.ops.cuda import stitch2
    from wah_tpu_torch.ops.cuda import stream_check as sc

    n = PROTOCOL_BLOCKS * 992
    data = bench_bitmap(n)
    ints = words_to_tensor(data, cuda)
    ints2d = ints.view(PROTOCOL_BLOCKS, 992)
    nv = torch.tensor([golden.chunk_count(n), 0, 0x7FFFFFFF], dtype=torch.int32, device=cuda)
    errs = {}
    staging, counts = ek.encode_tiles(ints2d, nv)
    staging_p, counts_p = ek.encode_tiles_plain(ints2d, nv)
    errs["encode_tiles"] = max(
        exact("K1 staging", staging, staging_p), exact("K1 counts", counts, counts_p)
    )
    offsets_ext = torch.cat([counts.new_zeros(1), torch.cumsum(counts[:, 0], 0, dtype=torch.int32)])
    total = int(offsets_ext[-1])
    words = stitch2.stitch_tiles_v2(staging, offsets_ext)
    words_p = stitch2.stitch_tiles_plain(staging, offsets_ext)
    words_c = stitch2.stitch_tiles_v2(staging, offsets_ext, counts=counts[:, 0].contiguous())
    errs["stitch_tiles_v2"] = max(
        exact("K2 stream", words[:total], words_p[:total]),
        exact("K2 stream (counts=)", words_c[:total], words_p[:total]),
    )
    m = total
    stream = torch.zeros(-(-m // 1024) * 1024, dtype=torch.int32, device=cuda)
    stream[:m] = words[:m]
    rows = stream.shape[0] // 128
    vc = (m - 128 * torch.arange(rows, device=cuda)).clamp(0, 128).to(torch.int32)
    words_t, g_sums = dk.prescan_words(stream, vc, rows)
    words_t_p, g_sums_p = dk.prescan_words_plain(stream, vc, rows)
    errs["prescan_words"] = max(
        exact("K3 words_t", words_t, words_t_p), exact("K3 g_sums", g_sums, g_sums_p)
    )
    g_incl = torch.cumsum(g_sums, 0, dtype=torch.int32)
    n_chunks = int(g_incl[-1])
    g_base = g_incl - g_sums
    meta = torch.tensor([n_chunks, m, 0, 0x7FFFFFFF], dtype=torch.int32, device=cuda)
    nbo = -(-n_chunks // 1024)
    out = dk.decode_blocks(words_t, g_base, meta, nbo)
    errs["decode_blocks"] = exact("K4 ints", out, dk.decode_blocks_plain(words_t, g_base, meta, nbo))
    bad_last = stream.clone()
    bad_last[m - 1] = 0
    errs["check_stream"] = max(
        exact("V1 [first_bad, n_chunks]", sc.check_stream(stream, m), sc.check_stream_plain(stream, m)),
        exact("V1, bad last word", sc.check_stream(bad_last, m), sc.check_stream_plain(bad_last, m)),
    )
    if sc.check_stream(stream, m).tolist() != [m, n_chunks] or int(sc.check_stream(bad_last, m)[0]) != m - 1:
        raise AssertionError("V1 disagrees with K3's chunk count or misses the bad last word")
    del bad_last

    # K6: the protocol's staging, the all-zero bitmap's (one word a row), edges
    zeros = torch.zeros_like(ints2d)
    staging_z, counts_z = ek.encode_tiles(zeros, nv)
    offsets_z = torch.cat([counts_z.new_zeros(1), torch.cumsum(counts_z[:, 0], 0, dtype=torch.int32)])
    k6 = [check_k6("protocol", staging, offsets_ext), check_k6("all-zero", staging_z, offsets_z)]
    edges = {
        "ties in the middle and at the end": [0] * 5 + [3, 0, 0, 700] + [1024] * 3 + [0] * 20,
        "total a multiple of 1024": [512, 512, 0, 1024, 0, 1000, 24],
        "every row full": [1024] * 64,
        "a total of one word": [1] + [0] * 63,
        "no words": [0] * 16,
    }
    for i, (name, c) in enumerate(edges.items()):
        k6.append(check_k6(name, *stitch_case(c, i, cuda)))
    errs["stitch_tiles"] = max(k6)
    torch.cuda.synchronize()
    print(f"[3 kernels] {PROTOCOL_BLOCKS} blocks, stream {m} words: all bit-exact {errs}; "
          f"K6 also on the all-zero staging ({int(offsets_z[-1])} words) and {len(edges)} edge cases")
    proto = dict(data=data, ints=ints, ints2d=ints2d, nv=nv, staging=staging,
                 offsets_ext=offsets_ext, staging_z=staging_z, offsets_z=offsets_z,
                 stream=stream, m=m, vc=vc, rows=rows, words_t=words_t, g_base=g_base,
                 meta=meta, nbo=nbo)
    return errs, proto


def phase_codec(cuda, data):
    """4. The codec's main path through the public API."""
    from wah_tpu_torch import WahCodec, golden
    from wah_tpu_torch.convert import tensor_to_words, words_to_tensor
    from wah_tpu_torch.ops.cuda import encode_kernel as ek

    n = PROTOCOL_BLOCKS * 992
    codec = WahCodec(cuda)
    ratio = {}
    golden_proto = golden.encode(data)

    def roundtrip(name, x, want=None):
        s, t_enc = codec.compress(x)
        if want is None:
            want = golden.encode(x)
        if s.shape != want.shape or not np.array_equal(s, want):
            raise AssertionError(f"{name}: stream differs ({len(s)} vs {len(want)} words)")
        back, t_dec = codec.decompress(s, out_ints=len(x))
        if not np.array_equal(back, x):
            raise AssertionError(f"{name}: round trip differs")
        ratio[name] = len(s) / max(len(x), 1)
        print(f"[4 codec] {name}: {len(x)} ints -> {len(s)} words, round trip ok; "
              f"enc ms h2d/kernel/d2h {t_enc.as_tuple()}, dec {t_dec.as_tuple()}", flush=True)

    roundtrip("protocol_130MB_p2^-4_seed1337", data, want=golden_proto)
    roundtrip("clustered_zipf1.5", clustered_bitmap(2048 * 992, seed=5, a=1.5))
    roundtrip("clustered_zipf1.1", clustered_bitmap(2048 * 992, seed=6, a=1.1))
    roundtrip("all_zeros_130MB", np.zeros(n, np.uint32))
    roundtrip("all_ones_130MB", np.full(n, 0xFFFFFFFF, np.uint32))
    roundtrip("odd_130MB_minus_345", data[: n - 345].copy())
    roundtrip("odd_3x992_plus_345", sparse_bitmap(3 * 992 + 345, seed=6))
    roundtrip("tiny", np.array([0x1, 0, 0, 0xFFFFFFFF], dtype=np.uint32))
    empty, _ = codec.compress(np.zeros(0, np.uint32))
    back, _ = codec.decompress(empty)
    if empty.size or back.size:
        raise AssertionError("empty input must give empty outputs")
    print("[4 codec] empty: ok")

    # the sweep's largest size; reference stream: plain encode on the card,
    # one 32,768-block segment at a time (fills never cross blocks)
    big = sparse_bitmap(SWEEP_MAX_BLOCKS * 992, seed=SEED)
    big_dev = words_to_tensor(big, cuda)
    seg = PROTOCOL_BLOCKS * 992
    parts = []
    for lo in range(0, big.shape[0], seg):
        w_p, tot_p = ek.encode_padded_plain(
            big_dev[lo : lo + seg], golden.chunk_count(big.shape[0]), (lo // 992) * 1024
        )
        parts.append(tensor_to_words(w_p[: int(tot_p)]))
    del big_dev
    roundtrip("sweep_992MB_p2^-4", big, want=np.concatenate(parts))
    return ratio, golden_proto


def phase_batch(cuda, errs):
    """3b. The batched kernels against their plain twins at the query
    benchmark's shape, on the card."""
    import torch

    from wah_tpu_torch import golden
    from wah_tpu_torch.convert import words_to_tensor
    from wah_tpu_torch.ops.cuda import decode_kernel as dk
    from wah_tpu_torch.ops.cuda import encode_kernel as ek

    C, nb = QUERY_COLUMNS, QUERY_BLOCKS
    n = nb * 992
    cols = sparse_bitmap(C * n, seed=SEED, ands=QUERY_ANDS).reshape(C, n)
    nv = golden.chunk_count(n)
    rows = words_to_tensor(cols.reshape(-1), cuda).view(C * nb, 992)
    words, totals = ek.encode_rows_batch(rows, C, nv)
    words_p, totals_p = ek.encode_rows_batch_plain(rows, C, nv)
    err = exact("batch totals", totals, totals_p)
    cap = nb * 1024
    for c in range(C):
        t = int(totals[c])
        err = max(err, exact(f"batch encode column {c}", words[c * cap : c * cap + t],
                             words_p[c * cap : c * cap + t]))
    del words_p
    # decode the flat output as it stands: words past each total are K2's
    # unspecified tails, which K3 must mask
    ints = dk.decode_rows_batch(words, C, totals, cap)
    ints_p = dk.decode_rows_batch_plain(words, C, totals, cap)
    err = max(err, exact("batch decode", ints, ints_p))
    if not torch.equal(ints, rows.reshape(-1)):
        raise AssertionError("batch decode: the columns do not round-trip")
    del ints, ints_p
    for k in ("encode_tiles", "stitch_tiles_v2", "prescan_words", "decode_blocks"):
        errs[k] = max(errs[k], err)
    mb = cols.nbytes / 1e6
    print(f"[3b batch] {C} columns x {nb} blocks ({mb:.1f} MB), P(bit) = 2^-{QUERY_ANDS}: "
          f"encode_rows_batch and decode_rows_batch == plain, round trip ok; "
          f"stream words per column {totals.tolist()}", flush=True)
    return dict(cols=cols, n=n, cap=cap, words=words, totals=totals, rows=rows)


def phase_queries(cuda, query, main_path):
    """4b. The index queries at the query benchmark's shape: the kernel
    pipeline (counted), then each result against the same pipeline through
    the plain versions on the card and against golden."""
    from wah_tpu_torch import golden
    from wah_tpu_torch.convert import tensor_to_words
    from wah_tpu_torch.ops import logical
    from wah_tpu_torch.ops.cuda import encode_kernel as ek
    from wah_tpu_torch.ops.cuda import stitch2

    cols, n, cap, words, totals = (query[k] for k in ("cols", "n", "cap", "words", "totals"))
    folds = [(k, op) for k in (4, 16) for op in ("or", "and")]

    def queries(plain):
        out = {}
        for k, op in folds:
            w, t = logical.logical_reduce_flat(words[: k * cap], k, totals[:k], op, n, plain)
            out[f"k{k}_{op}"] = tensor_to_words(w[: int(t)])
        m_a, m_b = int(totals[0]), int(totals[1])
        k6, k2 = ek.stitch_tiles.launches, stitch2.stitch_tiles_v2.launches
        w, t = logical.logical_op(words[:cap], m_a, words[cap : 2 * cap], m_b, "and", n, plain)
        out["pair_and"] = tensor_to_words(w[: int(t)])
        if not plain and (ek.stitch_tiles.launches, stitch2.stitch_tiles_v2.launches) != (k6, k2 + 1):
            raise AssertionError("pairwise AND: not stitched by K2 alone")
        out["not"] = tensor_to_words(logical.complement_stream(words[:cap], m_a)[:m_a])
        return out

    got = main_path("queries", ["encode_tiles", "stitch_tiles_v2", "prescan_words",
                                "decode_blocks"], lambda: queries(False))
    plain = queries(True)
    want = {f"k{k}_{op}": golden.encode({"or": np.bitwise_or, "and": np.bitwise_and}[op]
                                        .reduce(cols[:k])) for k, op in folds}
    want["pair_and"] = golden.encode(cols[0] & cols[1])
    want["not"] = golden.encode(~cols[0])
    for name in got:
        same_stream(f"query {name} (kernels vs plain)", got[name], plain[name])
        same_stream(f"query {name} (vs golden)", got[name], want[name])
    print(f"[4b queries] == plain pipeline and golden: "
          f"{ {name: len(s) for name, s in got.items()} } words", flush=True)


def phase_index(cuda, main_path):
    """4c. BitmapIndex over TPC-H SF10 lineitem.l_quantity, through the API."""
    from wah_tpu_torch import BitmapIndex, WahCodec, golden
    from wah_tpu_torch.ops.cuda import encode_kernel as ek

    quantity = np.random.default_rng(SEED).integers(1, QUANTITIES + 1, size=LINEITEM_ROWS)
    values = quantity - 1  # indexed as l_quantity - 1: columns 0..49
    codec = WahCodec(cuda)
    queries = {  # name -> (query on the index, numpy mask of the rows)
        "q6_quantity_lt_24": (lambda i: i.query_range(0, 22), lambda: quantity < 24),
        "q19_1_to_11": (lambda i: i.query_range(0, 10), lambda: quantity <= 11),
        "q19_10_to_20": (lambda i: i.query_range(9, 19), lambda: (quantity >= 10) & (quantity <= 20)),
        "q19_20_to_30": (lambda i: i.query_range(19, 29), lambda: (quantity >= 20) & (quantity <= 30)),
        "in_1_or_50": (lambda i: i.query_in([0, 49]), lambda: np.isin(quantity, [1, 50])),
        "not_24": (lambda i: i.query_not(23), lambda: quantity != 24),
        "and_1_2_disjoint": (lambda i: i.codec.logical(i.column(0), i.column(1), "and", i.n_ints),
                             lambda: np.zeros(LINEITEM_ROWS, bool)),
    }
    times = {}

    def drive():
        t0 = time.perf_counter()
        idx = BitmapIndex.build(values, QUANTITIES, codec=codec)
        times["build_s"] = time.perf_counter() - t0
        out = {}
        for name, (q, _) in queries.items():
            k6 = ek.stitch_tiles.launches
            t0 = time.perf_counter()
            out[name] = q(idx)
            times[name] = time.perf_counter() - t0
            if ek.stitch_tiles.launches != k6:
                raise AssertionError(f"{name}: K6 ran; every encode is stitched by K2")
        rows = idx.rows(out["q19_1_to_11"])
        return idx, out, rows

    idx, got, rows = main_path("index", ["encode_tiles", "stitch_tiles_v2", "prescan_words",
                                         "decode_blocks"], drive)
    for v in (0, 23, 49):
        same_stream(f"index column {v}", idx.column(v), golden.encode(mask_bitmap(values == v)))
    for name, (_, mask_fn) in queries.items():
        mask = mask_fn()
        same_stream(f"index {name}", got[name], golden.encode(mask_bitmap(mask)))
        if idx.count(got[name]) != int(mask.sum()):
            raise AssertionError(f"index {name}: count {idx.count(got[name])} != {int(mask.sum())}")
    if not np.array_equal(rows, np.flatnonzero(quantity <= 11)):
        raise AssertionError("index rows(q19_1_to_11) differ from numpy")
    print(f"[4c index] {LINEITEM_ROWS} rows x {QUANTITIES} columns "
          f"({idx.uncompressed_bytes() / 1e6:.1f} MB of bitmap, {idx.compressed_bytes() / 1e6:.1f} MB "
          f"compressed): every stream == golden, counts and rows == numpy; counts "
          f"{ {name: idx.count(s) for name, s in got.items()} }", flush=True)
    return dict(times=times, idx=idx, q6=queries["q6_quantity_lt_24"][0])


def phase_fused(cuda, errs, proto):
    """3c. K5 against its plain version and against the K1 + K2 pipeline:
    words[:total], total and counts, tolerance 0."""
    import torch

    from wah_tpu_torch import golden
    from wah_tpu_torch.convert import words_to_tensor
    from wah_tpu_torch.ops.cuda import encode_kernel as ek

    err = 0

    def check(name, ints, n_valid, base=0, plain=ek.encode_padded_fused_plain):
        nonlocal err
        words, total = ek.encode_padded_fused(ints, n_valid, base)
        t = int(total)
        ek.check_fused_error()
        for how, fn in (("plain", plain), ("K1 + K2", lambda *a: ek.encode_padded(*a, stitch="v3"))):
            w, n = fn(ints, n_valid, base)
            if int(n) != t:
                raise AssertionError(f"K5 {name}: total {t} != {how} {int(n)}")
            err = max(err, exact(f"K5 {name} vs {how}", words[:t], w[:t]))
        return t

    def check_counts(name, ints, n_valid):
        nonlocal err
        ints2d = ints.view(-1, 992)
        nv = torch.tensor([n_valid, 0], dtype=torch.int32, device=cuda)
        err = max(err, exact(f"K5 {name} counts", ek.encode_fused(ints2d, nv)[1],
                             ek.encode_fused_plain(ints2d, nv)[1]))
        ek.check_fused_error()

    nb = PROTOCOL_BLOCKS
    nv = golden.chunk_count(nb * 992)
    sizes = {"protocol": check("protocol", proto["ints"], nv)}
    if sizes["protocol"] != proto["m"]:
        raise AssertionError("K5 protocol: total differs from the K1 + K2 phase")
    check_counts("protocol", proto["ints"], nv)
    zeros = torch.zeros_like(proto["ints"])
    ones = torch.full_like(proto["ints"], -1)
    sizes["all-zero"] = check("all-zero", zeros, nv)
    sizes["all-one"] = check("all-one", ones, nv)
    check_counts("all-zero", zeros, nv)
    for a, seed in ((1.5, 5), (1.1, 6)):
        x = words_to_tensor(clustered_bitmap(2048 * 992, seed=seed, a=a), cuda)
        sizes[f"zipf{a}"] = check(f"clustered zipf {a}", x, golden.chunk_count(x.shape[0]))
    sizes["1 block"] = check("one block", proto["ints"][:992].contiguous(), 1024)
    odd = nb // 8 + 1
    sizes[f"{odd} blocks"] = check("odd block count", proto["ints"][: odd * 992].contiguous(),
                                   odd * 1024 - 500)
    # a shard in the middle of a longer bitmap: the global bound lies past the
    # call's blocks and is clamped to them; then a bound inside the call
    lo, hi = nb // 32, 3 * (nb // 32)
    shard = proto["ints"][lo * 992 : hi * 992].contiguous()
    sizes["clamped bound"] = check("chunk base, clamped bound", shard, nv, lo * 1024)
    sizes["bound inside"] = check("chunk base, bound inside", shard, (hi - lo // 2) * 1024 + 77, lo * 1024)

    # block counts around the tile size B and the persistent grid: whatever
    # the grid is (1 to 16 CTAs of 128 threads on each SM), one of these counts
    # is one tile fewer and one of them one tile more than it holds
    B = ek.FUSED_TILE_BLOCKS
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    around = sorted({1, B - 1, B, B + 1, 2 * B + 1, nb - 1}
                    | {(sms * c + d) * B for c in range(1, 17) for d in (-1, 1)} - {0})
    for n in around:
        check(f"{n} blocks", proto["ints"][: n * 992].contiguous(), n * 1024 - 300)
    sizes[f"{len(around)} counts around B = {B} and the grid"] = f"{around[0]}..{around[-1]}"
    # every block past the bound: no word, every count 0
    x = proto["ints"][: (2 * B + 1) * 992].contiguous()
    if check("all blocks past the bound", x, 5 * 1024, 4 * B * 1024) != 0:
        raise AssertionError("K5: blocks past the bound must emit nothing")
    past = ek.encode_fused(x.view(-1, 992), torch.tensor([5 * 1024, 4 * B * 1024],
                                                         dtype=torch.int32, device=cuda))[1]
    ek.check_fused_error()
    if past.any():
        raise AssertionError("K5: blocks past the bound must count 0")
    # a chunk base with the bound inside the second tile, then inside the last block
    sizes["bound inside a tile"] = check("chunk base, bound inside a tile", x,
                                         (2 + B + 1) * 1024 + 100, 2 * 1024)
    check("chunk base, bound inside the last block", x, (2 + 2 * B) * 1024 + 5, 2 * 1024)

    # ten launches back to back on one stream with different inputs, nothing
    # read before the last
    runs = []
    for i in range(10):
        n = (1, B + 1, 4097, 515, nb, 2 * B + 1, 33, nb // 2, B, 1000)[i]
        x = (zeros if i == 7 else proto["ints"])[i * 992 : (i + n) * 992].contiguous()
        runs.append((x, n * 1024 - 37 * i, ek.encode_padded_fused(x, n * 1024 - 37 * i)))
    ek.check_fused_error()
    for i, (x, n_valid, (w, tot)) in enumerate(runs):
        w_p, tot_p = ek.encode_padded_fused_plain(x, n_valid)
        if int(tot) != int(tot_p):
            raise AssertionError(f"K5 ten in a row, launch {i}: total {int(tot)} != {int(tot_p)}")
        err = max(err, exact(f"K5 ten in a row, launch {i}", w[: int(tot)], w_p[: int(tot)]))
    del runs

    # two launches in a row on different inputs, nothing read between them
    w1, t1 = ek.encode_padded_fused(proto["ints"], nv)
    w2, t2 = ek.encode_padded_fused(zeros, nv)
    ek.check_fused_error()
    p1, n1 = ek.encode_padded_fused_plain(proto["ints"], nv)
    if int(t1) != int(n1) or int(t2) != nb:
        raise AssertionError(f"K5 twice in a row: totals {int(t1)}, {int(t2)}")
    err = max(err, exact("K5 twice in a row, first", w1[: int(t1)], p1[: int(t1)]))
    if not bool((w2[:nb] == -(2**31) + 1024).all()):  # BIT31 | 1024 as int32
        raise AssertionError("K5 twice in a row: the second stream is wrong")
    del w1, w2, p1, zeros, ones

    # the sweep's largest size, made on the card (P(bit) = 2^-4); the plain
    # encode goes one protocol-sized piece at a time
    big_nb = SWEEP_MAX_BLOCKS
    gen = torch.Generator(device=cuda).manual_seed(SEED)
    big = torch.randint(-2**31, 2**31, (big_nb * 992,), generator=gen, dtype=torch.int32, device=cuda)
    for _ in range(3):
        big &= torch.randint(-2**31, 2**31, big.shape, generator=gen, dtype=torch.int32, device=cuda)

    def plain_in_pieces(ints, n_valid, base):
        parts, total = [], 0
        for lo in range(0, ints.shape[0], nb * 992):
            w, t = ek.encode_padded_fused_plain(ints[lo : lo + nb * 992], n_valid,
                                                base + lo // 992 * 1024)
            parts.append(w[: int(t)])
            total += int(t)
        out = torch.cat(parts)
        return out, torch.tensor(total)

    sizes[f"{big_nb} blocks"] = check("992 MB", big, golden.chunk_count(big.shape[0]),
                                      plain=plain_in_pieces)
    errs["encode_fused"] = err
    print(f"[3c fused] K5 (tiles of {B} blocks) == plain and == K1 + K2, words[:total], total and "
          f"counts bit-exact; ten and two launches in a row ok; stream words {sizes}", flush=True)


def phase_scans(cuda, errs, main_path):
    """3d. T1's kernel against its plain version (torch.cumsum / cummax /
    searchsorted). The full-width call is its main path and is counted."""
    import torch

    from wah_tpu_torch.ops.cuda import scan_check

    def case(rows, high, q, seed):
        rng = np.random.default_rng(seed)
        x = rng.integers(0, high, size=(rows, 2048), dtype=np.int32)
        csum = np.cumsum(x, axis=1)
        keys = rng.integers(csum[:, :1], csum[:, -1:] + 50, size=(rows, q))
        # a third of the keys are sums of the row itself: exact ties
        picks = np.take_along_axis(csum, rng.integers(0, 2048, (rows, q)), 1)
        keys[:, ::3] = picks[:, ::3]
        return torch.from_numpy(x).to(cuda), torch.from_numpy(keys.astype(np.int32)).to(cuda)

    def compare(name, got, x, keys):
        want = scan_check.rows_scan_plain(x, keys)
        return max(exact(f"T1 {name} {what}", g, w)
                   for g, w, what in zip(got, want, ("cumsum", "cummax", "search")))

    x, keys = case(SCAN_ROWS, 100, SCAN_KEYS, 17)
    got = main_path("scan_check", ["rows_scan"], lambda: scan_check.rows_scan(x, keys))
    err = compare("full width", got, x, keys)
    small = case(4, 100, SCAN_KEYS, 17)  # the TPU test's shape and seed
    err = max(err, compare("(4, 2048)", scan_check.rows_scan(*small), *small))
    ties = case(SCAN_ROWS // 8, 2, SCAN_KEYS, 18)  # half the steps add 0: long ties
    err = max(err, compare("ties", scan_check.rows_scan(*ties), *ties))

    def edge(name, x, q, lo=0, hi=2048, seed=19):
        """x (numpy, non-negative over [lo, hi)) with q keys a row from
        cumsum[lo] to past cumsum[hi - 1], a third of them exact ties."""
        rng = np.random.default_rng(seed)
        csum = np.cumsum(x, axis=1, dtype=np.int32).astype(np.int64)
        keys = np.zeros((x.shape[0], 0), np.int64)
        if q:
            keys = rng.integers(csum[:, lo : lo + 1], csum[:, hi - 1 : hi] + 50, size=(x.shape[0], q))
            picks = np.take_along_axis(csum[:, lo:hi], rng.integers(0, hi - lo, (x.shape[0], q)), 1)
            keys[:, ::3] = picks[:, ::3]
        xt, kt = torch.from_numpy(x).to(cuda), torch.from_numpy(keys.astype(np.int32)).to(cuda)
        want = scan_check.rows_scan_plain(xt, kt, lo, hi)
        return max(exact(f"T1 {name} {what}", g, w) for g, w, what in
                   zip(scan_check.rows_scan(xt, kt, lo, hi), want, ("cumsum", "cummax", "search")))

    rng = np.random.default_rng(23)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    edges = 0
    for rows in (1, 3, 8 * sms + 1):
        for q in (0, 1, SCAN_KEYS, 300):
            xe = rng.integers(0, 100, size=(rows, 2048), dtype=np.int32)
            err = max(err, edge(f"({rows}, 2048), {q} keys", xe, q),
                      edge(f"({rows}, 2048), {q} keys, span [5, 1902)", xe, q, 5, 1902))
            edges += 2
    # mixed sign outside the searched span, INT_MIN rows (the sum wraps, the
    # maximum stays), a row that starts at INT_MIN
    xe = rng.integers(-1000, 1000, size=(37, 2048), dtype=np.int32)
    xe[:, 700:1500] = np.abs(xe[:, 700:1500])
    err = max(err, edge("mixed sign, span [700, 1500)", xe, SCAN_KEYS, 700, 1500),
              edge("mixed sign, no keys", xe, 0))
    lowest = np.full((5, 2048), np.iinfo(np.int32).min, np.int32)
    err = max(err, edge("INT_MIN rows", lowest, 0))
    lowest[:, 1:] = rng.integers(-5, 5, size=(5, 2047))
    err = max(err, edge("rows that start at INT_MIN", lowest, 0))
    edges += 4
    errs["rows_scan"] = err
    print(f"[3d scans] rows_scan == torch.cumsum / cummax / searchsorted at (4, 2048), "
          f"({SCAN_ROWS}, 2048) with {SCAN_KEYS} keys a row, ({SCAN_ROWS // 8}, 2048) of 0/1 "
          f"steps (ties), and {edges} edge cases (1, 3 and {8 * sms + 1} rows; 0, 1, {SCAN_KEYS} and "
          f"300 keys; a span inside the row; mixed sign; INT_MIN): bit-exact", flush=True)
    return dict(x=x, keys=keys)


def phase_hazards(cuda, errs, proto):
    """3e. K1 and K4 where a grid of CTAs that each walk several blocks could
    go wrong; every comparison is with the plain version, tolerance 0."""
    import torch

    from wah_tpu_torch.ops.cuda import decode_kernel as dk
    from wah_tpu_torch.ops.cuda import encode_kernel as ek

    ints, nb = proto["ints"], PROTOCOL_BLOCKS
    err = {"encode_tiles": 0, "decode_blocks": 0}

    def nv3(bound, base=0, mask=0x7FFFFFFF):
        return torch.tensor([bound, base, mask], dtype=torch.int32, device=cuda)

    def k1(name, x2d, nv):
        got, want = ek.encode_tiles(x2d, nv), ek.encode_tiles_plain(x2d, nv)
        err["encode_tiles"] = max(err["encode_tiles"], exact(f"K1 {name} staging", got[0], want[0]),
                                  exact(f"K1 {name} counts", got[1], want[1]))
        return got

    def k4(name, stream, m, cap, base=0):
        got, n = dk.decode(stream, m, cap, base)
        want, n_p = dk.decode_plain(stream, m, cap, base)
        if int(n) != int(n_p):
            raise AssertionError(f"K4 {name}: n_ints {int(n)} != {int(n_p)}")
        err["decode_blocks"] = max(err["decode_blocks"], exact(f"K4 {name}", got, want))
        return got

    def padded_stream(words, total):
        out = torch.zeros(-(-total // 1024) * 1024, dtype=torch.int32, device=cuda)
        out[:total] = words[:total]
        return out

    # block counts that no grid divides, the bound ending inside the last block
    for n in (1, 2, 263, 265, nb - 1):
        x, bound = ints[: n * 992], n * 1024 - 300
        k1(f"{n} blocks", x.view(n, 992), nv3(bound))
        words, total = ek.encode_padded(x, bound, stitch="v3")
        back = k4(f"{n} blocks", padded_stream(words, int(total)), int(total), n * 1024)
        n_ints = 31 * bound // 32  # the ints that lie wholly below the bound
        if not torch.equal(back[:n_ints], x[:n_ints]):
            raise AssertionError(f"K1 -> K4 at {n} blocks: no round trip")
    # capacity past the stream's end (zeros), and a decoded span
    back = k4("capacity past the stream", proto["stream"], proto["m"], (nb + 37) * 1024)
    if back[nb * 992 :].any():
        raise AssertionError("K4: chunks past the stream must decode to zero")
    k4("chunk base 2 x 1024", proto["stream"], proto["m"], 5000 * 1024, 2 * 1024)
    k4("chunk base near the end", proto["stream"], proto["m"], 300 * 1024, (nb - 263) * 1024)
    # K1 with a position mask and a bound inside a column (the batch's validity)
    k1("position mask", ints[: 1024 * 992].view(1024, 992), nv3(256 * 1024 - 77, 0, 256 * 1024 - 1))
    k1("chunk base, bound inside", ints[: 530 * 992].view(530, 992), nv3(2 * 1024 + 529 * 1024 + 5, 2 * 1024))

    # batched columns: one fills its capacity exactly (every chunk a literal:
    # the tie of the granule search), one is all-zero, between others
    cnb = 512
    gen = torch.Generator(device=cuda).manual_seed(SEED)
    rnd = torch.randint(-2**31, 2**31, (cnb * 992,), generator=gen, dtype=torch.int32, device=cuda)
    cols = torch.stack([
        ints[: cnb * 992], (rnd & -0x55555556) | 0x11111111, torch.zeros_like(rnd),
        ints[cnb * 992 : 2 * cnb * 992], torch.full_like(rnd, -1), rnd & (rnd >> 7) & (rnd >> 13),
    ])
    C, cap = cols.shape[0], cnb * 1024
    rows = cols.view(C * cnb, 992)
    words, totals = ek.encode_rows_batch(rows, C, cnb * 1024)
    words_p, totals_p = ek.encode_rows_batch_plain(rows, C, cnb * 1024)
    e = exact("hazard batch totals", totals, totals_p)
    if int(totals[1]) != cap or int(totals[2]) != cnb:
        raise AssertionError(f"hazard batch: totals {totals.tolist()}: column 1 must fill its "
                             f"capacity {cap} and column 2 be {cnb} fills")
    for c in range(C):
        t = int(totals[c])
        e = max(e, exact(f"hazard batch column {c}", words[c * cap : c * cap + t],
                         words_p[c * cap : c * cap + t]))
    err["encode_tiles"] = max(err["encode_tiles"], e)
    got = dk.decode_rows_batch(words, C, totals, cap)
    err["decode_blocks"] = max(err["decode_blocks"], exact(
        "K4 batched columns", got, dk.decode_rows_batch_plain(words, C, totals, cap)))
    if not torch.equal(got, rows.reshape(-1)):
        raise AssertionError("hazard batch: the columns do not round-trip")
    del cols, rows, words, words_p, got, rnd

    # the sweep's largest size for both kernels; the plain versions go one
    # protocol-sized span at a time
    big_nb = SWEEP_MAX_BLOCKS
    big = torch.randint(-2**31, 2**31, (big_nb * 992,), generator=gen, dtype=torch.int32, device=cuda)
    for _ in range(3):
        big &= torch.randint(-2**31, 2**31, big.shape, generator=gen, dtype=torch.int32, device=cuda)
    bound = big_nb * 1024 - 300
    staging, counts = ek.encode_tiles(big.view(big_nb, 992), nv3(bound))
    e = 0
    for lo in range(0, big_nb, nb):
        st_p, ct_p = ek.encode_tiles_plain(big[lo * 992 : (lo + nb) * 992].view(nb, 992),
                                           nv3(bound, lo * 1024))
        e = max(e, exact(f"K1 992 MB staging from block {lo}", staging[lo : lo + nb], st_p),
                exact(f"K1 992 MB counts from block {lo}", counts[lo : lo + nb], ct_p))
    err["encode_tiles"] = max(err["encode_tiles"], e)
    del staging, counts
    words, total = ek.encode_padded(big, bound, stitch="v3")
    m = int(total)
    stream = padded_stream(words, m)
    del words
    back, _ = dk.decode(stream, m, big_nb * 1024)
    e = 0
    for lo in range(0, big_nb, nb):
        want, _ = dk.decode_plain(stream, m, nb * 1024, lo * 1024)
        e = max(e, exact(f"K4 992 MB from block {lo}", back[lo * 992 : (lo + nb) * 992], want))
    err["decode_blocks"] = max(err["decode_blocks"], e)
    n_ints = 31 * bound // 32
    if not torch.equal(back[:n_ints], big[:n_ints]):
        raise AssertionError("K1 -> K4 at 992 MB: no round trip")
    for k, v in err.items():
        errs[k] = max(errs[k], v)
    print(f"[3e hazards] K1 and K4 == plain at 1, 2, 263, 265 and {nb - 1} blocks, K4 with capacity "
          f"past the stream and with chunk bases, K1 with a position mask, {C} batched columns of "
          f"{cnb} blocks (totals {totals.tolist()}: one at capacity, one all-zero), and at "
          f"{big_nb} blocks ({big_nb * 992 * 4 / 1e6:.0f} MB, {m} words): bit-exact, round trips ok",
          flush=True)


def phase_segments(cuda, proto, main_path):
    """4d. The any-size paths through the API, at full width."""
    from wah_tpu_torch import WahCodec, api, golden

    codec = WahCodec(cuda)
    times = {}
    four = ["encode_tiles", "stitch_tiles_v2", "prescan_words", "decode_blocks"]

    # one bitmap past the int32 position cap
    data, g = proto["data"], proto["golden"]
    bitmap = np.tile(data, SEGMENT_COPIES)
    n = bitmap.shape[0]
    if golden.chunk_count(n) <= 2**31 - 1 or n <= api.MAX_INTS_PER_BITMAP:
        raise AssertionError("the segmented bitmap must lie past the int32 position cap")
    try:
        codec.compress(bitmap)
    except ValueError as e:
        print(f"[4d segments] a plain compress of {n} ints raises: {e}", flush=True)
    else:
        raise AssertionError("compress past the position cap must raise")

    def single():
        t0 = time.perf_counter()
        stream = codec.compress_segments(bitmap, segment_ints=SEGMENT_INTS)
        times["compress_segments_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = codec.decompress_segments(stream, n, segment_ints=SEGMENT_INTS)
        times["decompress_segments_s"] = time.perf_counter() - t0
        return stream, back

    stream, back = main_path("segments", four, single)
    if stream.shape[0] != SEGMENT_COPIES * g.shape[0]:
        raise AssertionError(f"segments: {stream.shape[0]} words, want {SEGMENT_COPIES} x {g.shape[0]}")
    for i in range(SEGMENT_COPIES):
        same_stream(f"segments copy {i}", stream[i * len(g) : (i + 1) * len(g)], g)
        if not np.array_equal(back[i * len(data) : (i + 1) * len(data)], data):
            raise AssertionError(f"segments: copy {i} does not round-trip")
    times["segments_bytes"] = bitmap.nbytes
    n_segs = -(-n // SEGMENT_INTS)
    print(f"[4d segments] {n} ints ({bitmap.nbytes / 1e9:.2f} GB, {golden.chunk_count(n)} chunks) in "
          f"{n_segs} segments -> {stream.shape[0]} words == {SEGMENT_COPIES} golden copies; round trip ok; "
          f"compress {times['compress_segments_s']:.2f} s, decompress "
          f"{times['decompress_segments_s']:.2f} s", flush=True)
    del bitmap, stream, back

    # batched columns, each longer than one batched call takes
    pool = [bernoulli_bitmap(BATCH_COLUMN_INTS, BATCH_DENSITY, SEED + i) for i in range(BATCH_POOL)]
    want = [golden.encode(c) for c in pool]
    cols = np.stack([pool[c % BATCH_POOL] for c in range(BATCH_COLUMNS)])

    def batch():
        t0 = time.perf_counter()
        streams = codec.compress_batch_segments(cols, segment_ints=BATCH_SEGMENT_INTS)
        times["compress_batch_segments_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = codec.decompress_batch_segments(streams, cols.shape[1], segment_ints=BATCH_SEGMENT_INTS)
        times["decompress_batch_segments_s"] = time.perf_counter() - t0
        return streams, out

    streams, out = main_path("batch_segments", four, batch)
    for c in range(BATCH_COLUMNS):
        same_stream(f"batch segments column {c}", streams[c], want[c % BATCH_POOL])
        if not np.array_equal(out[c], pool[c % BATCH_POOL]):
            raise AssertionError(f"batch segments: column {c} does not round-trip")
    times["batch_bytes"] = cols.nbytes
    bits = sum(int(np.unpackbits(c[:100_000].view(np.uint8)).sum()) for c in pool)
    print(f"[4d segments] {BATCH_COLUMNS} columns (of BASELINE.json configs[3]'s 256; {BATCH_POOL} "
          f"distinct) x {BATCH_COLUMN_INTS} ints ({cols.nbytes / 1e9:.2f} GB, P(bit) measured "
          f"{bits / (BATCH_POOL * 3.2e6):.4f}) in {-(-BATCH_COLUMN_INTS // BATCH_SEGMENT_INTS)} segments "
          f"a column: every stream == golden ({[len(w) for w in want]} words), round trip ok; "
          f"compress {times['compress_batch_segments_s']:.2f} s, decompress "
          f"{times['decompress_batch_segments_s']:.2f} s", flush=True)
    return times


def phase_differential(cuda, main_path):
    """4e. The differential's full matrix on the card; K5 and K6 run on every case."""
    from wah_tpu_torch import differential

    report = main_path("differential", ["encode_tiles", "stitch_tiles_v2", "prescan_words",
                                        "decode_blocks", "encode_fused", "stitch_tiles"],
                       lambda: differential.run(cuda))
    print(f"[4e differential] {differential.summary_line(report)}", flush=True)
    if report["summary"]["failed"] or report["summary"]["total_cases"] != 26:
        raise AssertionError(f"differential: {report['summary']}")


def run_all(commands, cwd, timeout=300):
    """Run the commands side by side; raise if one fails; leave none running."""
    procs = [subprocess.Popen(c, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in commands]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for c, p, out in zip(commands, procs, outs):
        if p.returncode:
            raise AssertionError(f"{' '.join(map(str, c[2:]))}: exit {p.returncode}\n{out}")
    return outs


def phase_cli():
    """4f. The file CLI as a user calls it (default device: the card)."""
    root = Path(__file__).resolve().parent
    cli = [sys.executable, "-m", "wah_tpu_torch"]
    odd = sparse_bitmap(CLI_INTS, seed=SEED).astype("<u4").tobytes()[:-3]  # no multiple of 4 bytes
    cols = [sparse_bitmap(CLI_INTS, seed=SEED + 1 + i, ands=a) for i, a in enumerate((8, 2, 12))]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "c0.bin").write_bytes(odd)
        for i, c in enumerate(cols):
            (tmp / f"d{i}.bin").write_bytes(c.astype("<u4").tobytes())
        wahs = [str(tmp / f"d{i}.bin.wah") for i in range(3)]
        run_all([[*cli, "compress", str(tmp / f"{f}.bin")] for f in ("c0", "d0", "d1", "d2")], root)
        # a 3-way OR of equal-length files, in the compressed domain
        info, _, _ = run_all([[*cli, "info", str(tmp / "c0.bin.wah")],
                              [*cli, "decompress", str(tmp / "c0.bin.wah"), "-o", str(tmp / "c0.out")],
                              [*cli, "logical", "or", *wahs, "-o", str(tmp / "or.wah")]], root)
        if (tmp / "c0.out").read_bytes() != odd:
            raise AssertionError("cli: compress -> decompress differs from the input file")
        run_all([[*cli, "decompress", str(tmp / "or.wah"), "-o", str(tmp / "or.bin")]], root)
        got = np.fromfile(tmp / "or.bin", dtype="<u4")
        if not np.array_equal(got, cols[0] | cols[1] | cols[2]):
            raise AssertionError("cli: logical or differs from numpy")
    print(f"[4f cli] compress, info, decompress ({len(odd)} B file) and a 3-way logical or "
          f"({CLI_INTS * 4} B files) as subprocesses on the default device: files == numpy; "
          f"{info.strip()}; {time.perf_counter() - t0:.1f} s", flush=True)


def phase_sharded(cuda, card, proto, main_path):
    """4g. The sharded codec (wah_tpu_torch.parallel) on the card."""
    import shutil

    import torch
    import torch.distributed as dist

    from wah_tpu_torch import WahCodec, golden
    from wah_tpu_torch.convert import tensor_to_words, words_to_tensor
    from wah_tpu_torch.parallel import (ShardedCodec, decode_local, encode_local, encode_sharded,
                                        estimate_word_cap, multihost, stitch_global, stitch_word_cap)
    from wah_tpu_torch.parallel._comm import all_gather

    four = ["encode_tiles", "stitch_tiles_v2", "prescan_words", "decode_blocks"]
    data, g = proto["data"], proto["golden"]
    n = data.shape[0]
    root = Path(__file__).resolve().parent

    # configs[4]'s bitmap and its reference stream, from the golden streams
    # of its distinct pieces (no fill crosses a block edge)
    t0 = time.perf_counter()
    piece = PROTOCOL_BLOCKS * 992
    n_full, rest = divmod(CONFIG4_INTS, piece)
    pool = [bernoulli_bitmap(piece, CONFIG4_DENSITY, SEED + 40 + i) for i in range(CONFIG4_POOL)]
    big = np.concatenate([pool[i % CONFIG4_POOL] for i in range(n_full)]
                         + [pool[n_full % CONFIG4_POOL][:rest]])
    pool_golden = [golden.encode(p) for p in pool]
    big_golden = np.concatenate([pool_golden[i % CONFIG4_POOL] for i in range(n_full)]
                                + [golden.encode(pool[n_full % CONFIG4_POOL][:rest])])
    del pool_golden
    print(f"[4g sharded] configs[4]: {big.shape[0]} ints ({big.shape[0] * 32 / 1e9:.0f}e9 bits, "
          f"{golden.chunk_count(big.shape[0])} chunks, {-(-golden.chunk_count(big.shape[0]) // 1024)} "
          f"blocks) from {CONFIG4_POOL} distinct pieces of {PROTOCOL_BLOCKS} blocks, reference "
          f"{big_golden.shape[0]} words; set-up {time.perf_counter() - t0:.1f} s", flush=True)

    # (a) and (b): one NCCL rank through the API
    if not dist.is_nccl_available():
        raise AssertionError("torch.distributed has no NCCL here")
    backend = multihost.choose_backend(1, "cuda")
    if backend != "nccl":
        raise AssertionError(f"one rank on a card must take NCCL, the rule gave {backend}")
    print(f"[4g sharded] backend {backend} for a world of 1 (multihost.choose_backend: every rank "
          f"has a card of its own; under a group every gather is NCCL's, even at one rank)",
          flush=True)
    tmp = tempfile.mkdtemp(prefix="wah_smoke_")
    if cuda.index is not None:
        torch.cuda.set_device(cuda)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0,
                            timeout=multihost.TIMEOUT)
    try:
        group = multihost.global_group()
        codec = ShardedCodec(cuda, group)
        times = {}

        def drive():
            out = {}
            for name, x in (("protocol", data), ("configs[4]", big)):
                t0 = time.perf_counter()
                stream = codec.compress(x)
                t1 = time.perf_counter()
                back = codec.decompress(stream, out_ints=x.shape[0])
                times[name] = (t1 - t0, time.perf_counter() - t1)
                out[name] = stream, back
            return out

        torch.cuda.reset_peak_memory_stats(cuda)
        routes = dict(all_gather.routes)
        got = main_path("distribution", four, drive)
        peak = torch.cuda.max_memory_allocated(cuda)
        # the totals, the stream and the bitmap of each of the two bitmaps
        route = "device" if cuda.type == "cuda" else "host"
        if all_gather.routes != {**routes, route: routes[route] + 6}:
            raise AssertionError(f"gathers by route {all_gather.routes}, before {routes}: want 6 "
                                 f"of route {route}")
        print(f"[4g sharded] 6 all_gathers of route {route} (NCCL on the card): the totals, the "
              f"stream and the bitmap of each", flush=True)
        for name, x, want in (("protocol", data, g), ("configs[4]", big, big_golden)):
            stream, back = got[name]
            same_stream(f"sharded {name}", stream, want)
            if not np.array_equal(back, x):
                raise AssertionError(f"sharded {name}: no round trip")
            print(f"[4g sharded] ShardedCodec at world size 1 (NCCL), {name}: {x.shape[0]} ints -> "
                  f"{stream.shape[0]} words == golden in full, round trip ok; host clock compress "
                  f"{times[name][0]:.3f} s, decompress {times[name][1]:.3f} s on {card}", flush=True)
        print(f"[4g sharded] peak device memory of the two {peak / 1e9:.1f} GB", flush=True)
        del got, big, big_golden, pool

        # (f) times at D = 1: stitch_global on the protocol, bounded and not
        # (CUDA events); the API against WahCodec's (host clock, W S S W)
        nv = golden.chunk_count(n)
        words_l, totals = encode_sharded(words_to_tensor(data, cuda), nv, group)
        cap_w = stitch_word_cap(totals)
        st = {label: min(cuda_ms(lambda: stitch_global(words_l, totals, wc, group), 20)
                         for _ in range(2))
              for label, wc in (("bounded", cap_w), ("unbounded", None))}
        wcodec = WahCodec(cuda)

        def host_s(fn, reps=3):
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                best = min(best, time.perf_counter() - t0)
            return best

        api = {}
        for label, c, comp in (("WahCodec", wcodec, lambda: wcodec.compress(data)),
                               ("ShardedCodec", codec, lambda: codec.compress(data)),
                               ("ShardedCodec again", codec, lambda: codec.compress(data)),
                               ("WahCodec again", wcodec, lambda: wcodec.compress(data))):
            api[label] = (host_s(comp), host_s(lambda: c.decompress(g, out_ints=n)))
        print(f"[4g sharded] stitch_global at world size 1 on the protocol ({int(totals[0])} words "
              f"of {words_l.shape[0]}): bounded by stitch_word_cap ({cap_w} words) "
              f"{st['bounded']:.4f} ms, unbounded {st['unbounded']:.4f} ms (CUDA events) on {card}",
              flush=True)
        print(f"[4g sharded] 130 MB protocol through the API, host clock, best of 3, s "
              f"(compress, decompress): "
              f"{ {k: (round(a, 4), round(b, 4)) for k, (a, b) in api.items()} } on {card}", flush=True)
        del words_l
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # (c) two gloo ranks on one card, as subprocesses: the dry run and the protocol
    with tempfile.TemporaryDirectory() as tdir:
        case = Path(tdir) / "protocol.npz"
        np.savez(case, data=data, stream=g)
        (out,) = run_all([[sys.executable, "-m", "wah_tpu_torch.parallel", "2", "--device", "cuda",
                           "--check", str(case), "--timeout", "240"]], root, timeout=300)
    if "backend gloo (gathers staged through host memory)" not in out or "2 ranks: ok" not in out:
        raise AssertionError(f"two ranks on one card:\n{out}")
    for line in out.splitlines():
        print(f"[4g sharded] 2 ranks on cuda:0: {line.replace(str(case), 'protocol')}", flush=True)

    # (d) the bodies of SHARD_RANKS ranks, one after another, at block counts
    # a rank that are no multiple of K1's or K4's walk
    for nb_l in SHARD_BLOCKS:
        nb = SHARD_RANKS * nb_l
        x = sparse_bitmap(nb * 992, seed=SEED + nb_l, ands=1)
        x[np.random.default_rng(nb_l).random(x.shape[0]) < 0.5] = 0
        x[2 * 992 : 5 * 992] = 0  # fills inside rank 0
        x[-3 * 992 :] = 0xFFFFFFFF  # a one-fill tail on the last rank
        nv = golden.chunk_count(x.shape[0])
        ints = words_to_tensor(x, cuda)
        L = nb_l * 992
        parts = []
        for r in range(SHARD_RANKS):
            w, t = encode_local(ints[r * L : (r + 1) * L], nv, r)
            parts.append(tensor_to_words(w[: int(t)]))
        want = golden.encode(x)
        same_stream(f"{SHARD_RANKS} ranks of {nb_l} blocks", np.concatenate(parts), want)
        stream = words_to_tensor(np.concatenate([want, np.zeros(-want.shape[0] % 1024, np.uint32)]),
                                 cuda)
        spans = [decode_local(stream, want.shape[0], nb_l * 1024, r)[0] for r in range(SHARD_RANKS)]
        if not np.array_equal(tensor_to_words(torch.cat(spans)), x):
            raise AssertionError(f"{SHARD_RANKS} ranks of {nb_l} blocks: the spans differ from the input")
        # spans of a warp less than the blocks: cut out of the covering blocks' decode
        off = nb_l * 1024 - 32
        spans = [decode_local(stream, want.shape[0], off, r)[0] for r in range(-(-nv // off))]
        if not np.array_equal(tensor_to_words(torch.cat(spans))[: x.shape[0]], x):
            raise AssertionError(f"spans of {off} chunks differ from the input")
        print(f"[4g sharded] {SHARD_RANKS} rank bodies of {nb_l} blocks: per-rank totals "
              f"{[p.shape[0] for p in parts]}, concatenation == golden, spans == the input, "
              f"also in spans of {off} chunks off the blocks", flush=True)

    # (e) the gathered payload at D = 1 (word counts the format fixes) against
    # benchmarks/scaling_model.json, and a word_cap that bites
    want = json.loads((root / "benchmarks" / "scaling_model.json").read_text())[
        "tpu_v5e_1chip"]["stitch_payloads"]
    nb = PAYLOAD_BLOCKS
    for every_n in PAYLOAD_EVERY_N:
        d = generate_random_data(nb * 992, every_n)
        words_l, totals = encode_sharded(words_to_tensor(d, cuda), golden.chunk_count(d.shape[0]))
        got = {"compressed_bytes": int(totals.sum()) * 4, "capacity_bytes": words_l.shape[0] * 4,
               "allgather_bytes_per_chip_exact_cap": stitch_word_cap(totals) * 4,
               "allgather_bytes_per_chip_estimate_cap": estimate_word_cap(d, nb) * 4}
        key = f"2^-{every_n.bit_length() - 1}"
        ref = {k: want[key][k] for k in got}
        if got != ref:
            raise AssertionError(f"payload bytes at {key}: {got} != scaling_model.json {ref}")
        print(f"[4g sharded] payload at world size 1, {nb} blocks, P(bit) = {key}: {got} "
              f"== benchmarks/scaling_model.json", flush=True)
        if every_n == PAYLOAD_EVERY_N[-1]:
            total = int(totals.sum())
            bite = stitch_word_cap(totals) - 1024
            stream, tot, overflow = stitch_global(words_l, totals, bite)
            if not bool(overflow) or int(tot) != total or stream.shape[0] != bite:
                raise AssertionError(f"word_cap {bite}: overflow {bool(overflow)}, total {int(tot)}")
            stream, tot, overflow = stitch_global(words_l, totals)
            if bool(overflow) or int(tot) != total:
                raise AssertionError("the unbounded retry overflowed")
            same_stream(f"retry at {key}", tensor_to_words(stream[:total]), golden.encode(d))
            if stream[total:].any():
                raise AssertionError("the retry's stream is not zero past its total")
            print(f"[4g sharded] word_cap {bite} < {total} live words at {key}: overflow raised, "
                  f"total right; the unbounded retry == golden", flush=True)
        del words_l


def phase_kernel_times(cuda, card, proto, query, scans, profile: bool = False):
    """6. CUDA-event ms, kernel against plain and against the one PyTorch call
    for the same function."""
    import torch

    from wah_tpu_torch import golden
    from wah_tpu_torch.ops import logical
    from wah_tpu_torch.ops.cuda import decode_kernel as dk
    from wah_tpu_torch.ops.cuda import encode_kernel as ek
    from wah_tpu_torch.ops.cuda import scan_check, stitch2
    from wah_tpu_torch.ops.cuda import stream_check as sc

    p = proto
    n = PROTOCOL_BLOCKS * 992
    nv2 = p["nv"][:2].contiguous()
    sx, sk = scans["x"], scans["keys"]
    timed = {
        "encode_tiles": (lambda: ek.encode_tiles(p["ints2d"], p["nv"]),
                         lambda: ek.encode_tiles_plain(p["ints2d"], p["nv"])),
        "stitch_tiles_v2": (lambda: stitch2.stitch_tiles_v2(p["staging"], p["offsets_ext"]),
                            lambda: stitch2.stitch_tiles_plain(p["staging"], p["offsets_ext"])),
        "prescan_words": (lambda: dk.prescan_words(p["stream"], p["vc"], p["rows"]),
                          lambda: dk.prescan_words_plain(p["stream"], p["vc"], p["rows"])),
        "decode_blocks": (lambda: dk.decode_blocks(p["words_t"], p["g_base"], p["meta"], p["nbo"]),
                          lambda: dk.decode_blocks_plain(p["words_t"], p["g_base"], p["meta"], p["nbo"])),
        "stitch_tiles": (lambda: ek.stitch_tiles(p["staging"], p["offsets_ext"]),
                         lambda: stitch2.stitch_tiles_plain(p["staging"], p["offsets_ext"])),
        "encode_fused": (lambda: ek.encode_fused(p["ints2d"], nv2),
                         lambda: ek.encode_fused_plain(p["ints2d"], nv2)),
        "rows_scan": (lambda: scan_check.rows_scan(sx, sk),
                      lambda: scan_check.rows_scan_plain(sx, sk)),
        "check_stream": (lambda: sc.check_stream(p["stream"], p["m"]),
                         lambda: sc.check_stream_plain(p["stream"], p["m"])),
        "encode pipeline": (lambda: ek.encode_padded(p["ints"], golden.chunk_count(n), stitch="v3"),
                            lambda: ek.encode_padded_plain(p["ints"], golden.chunk_count(n), stitch="v3")),
        "decode pipeline": (lambda: dk.decode(p["stream"], p["m"], p["nbo"] * 1024),
                            lambda: dk.decode_plain(p["stream"], p["m"], p["nbo"] * 1024)),
    }
    ms = {}

    def measure(name, kernel_fn, plain_fn, gb, what):
        # plain, kernel, kernel, plain: compare only within this run
        p1 = cuda_ms(plain_fn, 3)
        k1 = cuda_ms(kernel_fn, 20)
        k2 = cuda_ms(kernel_fn, 20)
        p2 = cuda_ms(plain_fn, 3)
        ms[name] = (min(k1, k2), min(p1, p2))
        print(f"[6 times] {name}: kernel {ms[name][0]:.4f} ms, plain {ms[name][1]:.4f} ms "
              f"(kernel {gb / ms[name][0] * 1e3:.2f} GB/s of {what}) on {card}", flush=True)

    for name, (kernel_fn, plain_fn) in timed.items():
        gb, what = (sx.numel() * 4 / 1e9, "int32 rows") if name == "rows_scan" else (
            p["data"].nbytes / 1e9, "bitmap")
        measure(name, kernel_fn, plain_fn, gb, what)
    ek.check_fused_error()
    print(f"[6 times] K5 encode_fused {ms['encode_fused'][0]:.4f} ms beside the K1 + cumsum + K2 "
          f"pipeline {ms['encode pipeline'][0]:.4f} ms (K1 {ms['encode_tiles'][0]:.4f} + K2 "
          f"{ms['stitch_tiles_v2'][0]:.4f}) on {card}", flush=True)

    # the one PyTorch call that computes a kernel's function, timed beside it
    # and used nowhere in the port: for both stitches torch.masked_select of
    # the staging rows' prefixes (its mask made outside the timing); for T1
    # torch.cumsum and torch.cummax (searchsorted timed beside them)
    library_ms = {}
    counts = (p["offsets_ext"][1:] - p["offsets_ext"][:-1])[:, None]
    mask = torch.arange(1024, device=cuda)[None, :] < counts
    if not torch.equal(torch.masked_select(p["staging"], mask), p["stream"][: p["m"]]):
        raise AssertionError("masked_select does not compute the stitch")
    sel = min(cuda_ms(lambda: torch.masked_select(p["staging"], mask), 10) for _ in range(2))
    library_ms["stitch_tiles_v2"] = library_ms["stitch_tiles"] = sel
    csum = torch.cumsum(sx, 1, dtype=torch.int32)
    scan_ms = {
        "cumsum": min(cuda_ms(lambda: torch.cumsum(sx, 1, dtype=torch.int32), 10) for _ in range(2)),
        "cummax": min(cuda_ms(lambda: torch.cummax(sx, 1), 10) for _ in range(2)),
        "searchsorted": min(cuda_ms(lambda: torch.searchsorted(csum, sk, right=True), 10)
                            for _ in range(2)),
    }
    library_ms["rows_scan"] = scan_ms["cumsum"] + scan_ms["cummax"]
    print(f"[6 times] library calls: torch.masked_select for K2 / K6 {sel:.4f} ms (K2 "
          f"{ms['stitch_tiles_v2'][0]:.4f}, K6 {ms['stitch_tiles'][0]:.4f}); for T1 torch.cumsum "
          f"{scan_ms['cumsum']:.4f} + torch.cummax {scan_ms['cummax']:.4f} ms, searchsorted "
          f"{scan_ms['searchsorted']:.4f} ms (kernel, all three: {ms['rows_scan'][0]:.4f}) on {card}",
          flush=True)
    del mask, csum

    # V1 beside the torch calls that compute the same [first_bad, n_chunks]
    # (compares, an argmax, a sum), at the protocol and at the api cell's
    # stream: the 992 MB sweep bitmap at 2^-4 (AND of 4 uniform words),
    # drawn and encoded on the card
    library_ms["check_stream"] = min(
        cuda_ms(lambda: check_stream_library(p["stream"], p["m"]), 10) for _ in range(2))
    gen = torch.Generator(device=cuda).manual_seed(SEED)
    big = torch.randint(-2**31, 2**31, (SWEEP_MAX_BLOCKS * 992,), generator=gen, dtype=torch.int32,
                        device=cuda)
    for _ in range(3):
        big &= torch.randint(-2**31, 2**31, big.shape, generator=gen, dtype=torch.int32, device=cuda)
    words, total = ek.encode_padded(big, golden.chunk_count(big.numel()), stitch="v3")
    del big
    bm = int(total)
    big_stream = torch.zeros(-(-bm // 1024) * 1024, dtype=torch.int32, device=cuda)
    big_stream[:bm] = words[:bm]
    del words
    got = sc.check_stream(big_stream, bm)
    if got.tolist() != sc.check_stream_plain(big_stream, bm).tolist() or int(got[0]) != bm:
        raise AssertionError("V1 differs from its plain twin on the sweep stream")
    big_ms = {
        "kernel": min(cuda_ms(lambda: sc.check_stream(big_stream, bm), 20) for _ in range(2)),
        "plain": min(cuda_ms(lambda: sc.check_stream_plain(big_stream, bm), 3) for _ in range(2)),
        "library": min(cuda_ms(lambda: check_stream_library(big_stream, bm), 5) for _ in range(2)),
    }
    bound = (bm * 4 + 16) / PEAK_BYTES_PER_S * 1e3
    print(f"[6 times] check_stream on the sweep stream ({bm} words, {bm * 4 / 1e6:.1f} MB): "
          f"kernel {big_ms['kernel']:.4f} ms, bound {bound:.4f} ms ({bound / big_ms['kernel']:.0%}), "
          f"plain {big_ms['plain']:.4f} ms, library {big_ms['library']:.4f} ms on {card}", flush=True)
    del big_stream

    # K6 against K2 on the same staging: the protocol's (2^-4, dense), the
    # all-zero bitmap's, and 130 MB stagings at the densities between
    stagings = [("2^-4 (protocol)", p["staging"], p["offsets_ext"])]
    gen = torch.Generator(device=cuda).manual_seed(SEED)
    for ands in (8, 12, 16):
        x = torch.randint(-2**31, 2**31, p["ints2d"].shape, generator=gen, dtype=torch.int32,
                          device=cuda)
        for _ in range(ands - 1):
            x &= torch.randint(-2**31, 2**31, x.shape, generator=gen, dtype=torch.int32, device=cuda)
        st, c = ek.encode_tiles(x, p["nv"])
        off = torch.cat([c.new_zeros(1), torch.cumsum(c[:, 0], 0, dtype=torch.int32)])
        stagings.append((f"2^-{ands}", st, off))
    stagings.append(("all-zero", p["staging_z"], p["offsets_z"]))
    for label, st, off in stagings:
        k6 = cuda_ms(lambda: ek.stitch_tiles(st, off), 20)
        k2 = cuda_ms(lambda: stitch2.stitch_tiles_v2(st, off), 20)
        k6b = cuda_ms(lambda: ek.stitch_tiles(st, off), 20)
        k2b = cuda_ms(lambda: stitch2.stitch_tiles_v2(st, off), 20)
        pl = cuda_ms(lambda: stitch2.stitch_tiles_plain(st, off), 3)
        total = int(off[-1])
        print(f"[6 times] stitch of the {label} staging ({total} words, "
              f"{total / st.numel():.4f} of capacity): K6 {min(k6, k6b):.4f} ms, "
              f"K2 {min(k2, k2b):.4f} ms, plain {pl:.4f} ms on {card}", flush=True)

    # the query folds and the pairwise AND at the query shape
    q = query
    words, totals, cap, qn = q["words"], q["totals"], q["cap"], q["n"]
    col_bytes = qn * 4
    m_a, m_b = int(totals[0]), int(totals[1])
    for name, k, fn in (
        ("k16 OR fold", 16, lambda plain: logical.logical_reduce_flat(
            words, 16, totals, "or", qn, plain)),
        ("pairwise AND", 2, lambda plain: logical.logical_op(
            words[:cap], m_a, words[cap : 2 * cap], m_b, "and", qn, plain)),
    ):
        measure(name, lambda: fn(False), lambda: fn(True), k * col_bytes / 1e9, "logical bitmap")

    # K1 and K4 alone on the query shape's batched columns, where the folds
    # launch them; the bound from the words these columns hold
    C = QUERY_COLUMNS
    k1_args = (q["rows"], torch.tensor([golden.chunk_count(qn), 0, cap - 1], dtype=torch.int32,
                                       device=cuda))
    k4_args = []

    def keep_args(*args):  # stands in for K4 in the batched decode: K3 and the rebase run
        k4_args.extend(args)
        return torch.empty(0, dtype=torch.int32, device=cuda)

    dk._decode_rows_batch(words, C, totals, cap, dk.prescan_words, keep_args)
    q_blocks, q_words = C * QUERY_BLOCKS, int(totals.sum())
    for name, fn, plain_fn, args, nbytes in (
        ("K1 encode_tiles, batched", ek.encode_tiles, ek.encode_tiles_plain, k1_args,
         q_blocks * (992 + 1024 + 1) * 4 + 12),
        ("K4 decode_blocks, batched", dk.decode_blocks, dk.decode_blocks_plain, k4_args,
         q_words * 4 + k4_args[1].numel() * 4 + 16 + q_blocks * 992 * 4),
    ):
        measure(name, lambda: fn(*args), lambda: plain_fn(*args), C * col_bytes / 1e9, "bitmap")
        print(f"[6 times] {name} ({C} x {QUERY_BLOCKS} blocks, 2^-{QUERY_ANDS}): bound "
              f"{nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms ({nbytes / 1e6:.1f} MB), measured "
              f"{ms[name][0]:.4f} ms on {card}", flush=True)

    if profile:
        from wah_tpu_torch.utils import profiling

        with tempfile.TemporaryDirectory() as logdir:
            with profiling.trace(logdir) as t:
                for _ in range(5):
                    for name in ("encode_tiles", "decode_blocks", "encode_fused", "rows_scan",
                                 "encode pipeline", "decode pipeline"):
                        timed[name][0]()
        print(t.profiler.key_averages().table(sort_by="cuda_time_total", row_limit=12), flush=True)
    return ms, library_ms


def phase_profiling(cuda, card, proto, ms):
    """6b. wah_tpu_torch.utils.profiling on the protocol: graph-replayed
    times beside phase 6's eager ones, one traced API round trip, and the
    steps a capture must refuse."""
    import torch

    from wah_tpu_torch import WahCodec, golden
    from wah_tpu_torch.convert import tensor_to_words
    from wah_tpu_torch.ops.cuda import decode_kernel as dk
    from wah_tpu_torch.ops.cuda import encode_kernel as ek
    from wah_tpu_torch.ops.cuda import stitch2
    from wah_tpu_torch.utils import profiling

    p = proto
    nv_count = golden.chunk_count(PROTOCOL_BLOCKS * 992)
    cap = p["nbo"] * 1024
    total = p["m"]
    # name -> (step, args, the eager output's words to hold the replay to)
    steps = {
        "encode_tiles": (ek.encode_tiles, (p["ints2d"], p["nv"]), lambda o: torch.cat(
            [o[0].reshape(-1), o[1].reshape(-1)])),
        "stitch_tiles_v2": (stitch2.stitch_tiles_v2, (p["staging"], p["offsets_ext"]),
                            lambda o: o[:total]),
        "prescan_words": (dk.prescan_words, (p["stream"], p["vc"], p["rows"]),
                          lambda o: torch.cat([o[0].reshape(-1), o[1]])),
        "decode_blocks": (dk.decode_blocks, (p["words_t"], p["g_base"], p["meta"], p["nbo"]),
                          lambda o: o.reshape(-1)),
        "encode pipeline": (lambda ints: ek.encode_padded(ints, nv_count, stitch="v3"),
                            (p["ints"],), lambda o: torch.cat([o[0][: int(o[1])], o[1].view(1)])),
        "decode pipeline": (lambda words: dk.decode(words, total, cap), (p["stream"],),
                            lambda o: torch.cat([o[0], o[1].view(1)])),
    }
    graphs = {}
    for name, (step, args, words_of) in steps.items():
        s = profiling.amortized_seconds(step, *args, cache=graphs, cache_key=name)
        replayed = words_of(graphs[name].out)
        eager = words_of(step(*args))
        exact(f"6b {name}: replayed output against eager", replayed, eager)
        eager_ms, issue_ms = ms[name][0], host_issue_ms(lambda: step(*args), 20)
        print(f"[6b profiling] {name}: graph-replayed {s * 1e3:.4f} ms (amortized_seconds), eager "
              f"{eager_ms:.4f} ms (cuda_ms, phase 6), replayed / eager {s * 1e3 / eager_ms:.3f}; "
              f"the host issues one eager call in {issue_ms:.4f} ms; replay == eager "
              f"({replayed.numel()} words) on {card}", flush=True)
    del graphs

    # one API round trip on the default device, traced after an untraced one
    # (the first call builds the host codec and warms the allocator)
    codec = WahCodec()
    want = tensor_to_words(p["stream"][:total])
    for traced in (False, True):
        with tempfile.TemporaryDirectory() as logdir:
            with (profiling.trace(logdir) if traced else contextlib.nullcontext()) as t:
                t0 = time.perf_counter()
                stream, _ = codec.compress(p["data"])
                back, _ = codec.decompress(stream, out_ints=len(p["data"]))
                wall = time.perf_counter() - t0
            if traced:
                act = profiling.device_activity(t)
    same_stream("6b traced compress", stream, want)
    if not np.array_equal(back, p["data"]):
        raise AssertionError("6b traced decompress differs from the input")
    print(f"[6b profiling] traced WahCodec() compress + decompress of the protocol: window "
          f"{act['window_us'] / 1e3:.3f} ms (host clock {wall * 1e3:.3f} ms), device busy "
          f"{act['busy_us'] / 1e3:.3f} ms = {act['busy_share']:.2%} of the window on {card}",
          flush=True)
    if not act["ops"]:  # WahCodec() with no device must run on the card
        raise AssertionError("6b: the trace holds no device operation")
    for i, (name, us, n) in enumerate(act["ops"][:5], 1):
        print(f"[6b profiling]   top {i}: {us / 1e3:.4f} ms in {n} x {name[:90]} on {card}", flush=True)

    # steps a capture must refuse: a host read of a device value
    probes = {
        "int(ints[:1]), a host read": (lambda ints: int(ints[:1]), (p["ints"],), True),
        "torch.tensor([...], device=cuda), a copy from pageable memory": (
            lambda ints: torch.tensor([1, 2], dtype=torch.int32, device=ints.device), (p["ints"],),
            False),
    }
    for name, (step, args, must_refuse) in probes.items():
        try:
            profiling.capture(step, *args)
            verdict = "captured"
        except RuntimeError as e:
            verdict = f"refused: {str(e).splitlines()[0][:160]}"
        print(f"[6b profiling] capture of {name}: {verdict}", flush=True)
        if must_refuse and verdict == "captured":
            raise AssertionError(f"6b: a capture of {name} must raise")
    # the card still runs after the refused captures
    staging, counts = ek.encode_tiles(p["ints2d"], p["nv"])
    exact("6b K1 after the refused captures", staging, p["staging"])


def phase_host_times(cuda, card, index_times, segment_times):
    """6. Host-clock seconds of the segment paths and the index through the
    API, and Q6's device pipeline alone (CUDA events)."""
    import torch

    from wah_tpu_torch.convert import words_to_tensor
    from wah_tpu_torch.ops import logical

    st = segment_times
    print(f"[6 times] segments through the API (host clock): compress_segments "
          f"{st['compress_segments_s']:.3f} s ({st['segments_bytes'] / st['compress_segments_s'] / 1e9:.3f} "
          f"GB/s of bitmap), decompress_segments {st['decompress_segments_s']:.3f} s "
          f"({st['segments_bytes'] / st['decompress_segments_s'] / 1e9:.3f} GB/s); "
          f"compress_batch_segments {st['compress_batch_segments_s']:.3f} s "
          f"({st['batch_bytes'] / st['compress_batch_segments_s'] / 1e9:.3f} GB/s), "
          f"decompress_batch_segments {st['decompress_batch_segments_s']:.3f} s "
          f"({st['batch_bytes'] / st['decompress_batch_segments_s'] / 1e9:.3f} GB/s) on {card}", flush=True)
    # the index through the API, host clock (numpy in and out), and Q6's
    # device pipeline alone on device-resident columns (CUDA events)
    t = index_times["times"]
    idx, q6 = index_times["idx"], index_times["q6"]
    q6_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        q6(idx)
        q6_s.append(time.perf_counter() - t0)
    cols = [idx.column(v) for v in range(23)]
    M = -(-max(map(len, cols)) // 1024) * 1024
    flat = np.zeros((23, M), np.uint32)
    for i, c in enumerate(cols):
        flat[i, : len(c)] = c
    flat_dev = words_to_tensor(flat.reshape(-1), cuda)
    ms_dev = torch.tensor([len(c) for c in cols], dtype=torch.int32, device=cuda)
    q6_dev = cuda_ms(lambda: logical.logical_reduce_flat(flat_dev, 23, ms_dev, "or", idx.n_ints), 10)
    print(f"[6 times] index over {LINEITEM_ROWS} rows: build {t['build_s']:.3f} s; "
          f"Q6 (23-way OR) first {t['q6_quantity_lt_24']:.4f} s, then min {min(q6_s):.4f} s of 5 "
          f"({23 * idx.n_ints * 4 / min(q6_s) / 1e9:.2f} logical GB/s), of which the device "
          f"pipeline {q6_dev:.4f} ms; other queries "
          f"{ {k: round(v, 4) for k, v in t.items() if k not in ('build_s', 'q6_quantity_lt_24')} } s "
          f"on {card}", flush=True)


def phase_copies(cuda, card):
    """6c. The copy yardstick behind convert's staging ring, on the sweep
    bitmap (992 MiB): the copy engine's rate from pinned memory whole and by
    chunk size, today's pageable copies, the host's copies between pageable
    and pinned memory (warm pages, fresh pages) on torch's intra-op threads
    and on one thread, the staged copies at each ring shape, and the time of
    one small copy staged and direct."""
    import os

    import torch

    from wah_tpu_torch import convert

    n = SWEEP_MAX_BLOCKS * 992
    gb = n * 4 / 1e9
    x = np.random.default_rng(SEED).integers(0, 1 << 32, size=n, dtype=np.uint32)
    host = torch.from_numpy(x.view(np.int32))
    warm = torch.from_numpy(np.ones(n, np.int32))
    pinned = torch.empty(n, dtype=torch.int32, pin_memory=True)
    pinned.copy_(host)
    dev = torch.empty(n, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream(cuda)
    cores = len(os.sched_getaffinity(0))

    def fresh():
        return torch.from_numpy(np.empty(n, np.int32))

    def rate(fn, reps=3):
        """Median and each GB/s of `reps` runs of fn(), waited for."""
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(n * 4 / (time.perf_counter() - t0) / 1e9)
        return f"{sorted(out)[len(out) // 2]:.2f} ({', '.join(f'{r:.2f}' for r in out)})"

    def chunked(dst, src, chunk):
        for lo in range(0, n, chunk):
            dst[lo : lo + chunk].copy_(src[lo : lo + chunk], non_blocking=True)

    print(f"[6c copies] {gb:.4f} GB; host cores {cores}, torch intra-op threads "
          f"{torch.get_num_threads()}; GB/s median (runs) on {card}", flush=True)
    print(f"[6c copies] pinned DMA whole: H2D {rate(lambda: dev.copy_(pinned, non_blocking=True))}, "
          f"D2H {rate(lambda: pinned.copy_(dev, non_blocking=True))}", flush=True)
    for mib in (4, 8, 16, 32, 64):
        c = mib << 18
        print(f"[6c copies] pinned DMA in {mib} MiB chunks: H2D {rate(lambda: chunked(dev, pinned, c))}, "
              f"D2H {rate(lambda: chunked(pinned, dev, c))}", flush=True)
    print(f"[6c copies] pageable direct (before the ring): H2D {rate(lambda: dev.copy_(host))}, "
          f"D2H into a fresh array {rate(lambda: dev.cpu())}", flush=True)
    threads = torch.get_num_threads()
    for label, nt in (("torch copy_", threads), ("torch copy_ 1 thread", 1)):
        torch.set_num_threads(nt)
        print(f"[6c copies] host {label}: warm -> pinned {rate(lambda: pinned.copy_(host))}, "
              f"pinned -> warm {rate(lambda: warm.copy_(pinned))}, "
              f"pinned -> fresh {rate(lambda: fresh().copy_(pinned))}", flush=True)
    torch.set_num_threads(threads)
    del pinned

    def staged_out(ring):
        out = fresh()
        convert._stage_out(dev, out, ring, stream)
        return out

    for mib in (8, 16, 32, 64, 128):
        for depth in (2, 3):
            ring = convert._Ring([torch.empty(mib << 18, dtype=torch.int32, pin_memory=True)
                                  for _ in range(depth)], [torch.cuda.Event() for _ in range(depth)])
            h2d = rate(lambda: convert._stage_in(host, dev, ring, stream, mib << 18))
            d2h = rate(lambda: staged_out(ring))
            if not torch.equal(staged_out(ring), host):
                raise AssertionError(f"staged copies at {mib} MiB x {depth}: words differ")
            print(f"[6c copies] staged, {depth} x {mib} MiB: H2D {h2d}, D2H into a fresh array {d2h}",
                  flush=True)
            del ring
    ring = convert._ring(cuda)
    for words in (1 << 14, 1 << 16, 1 << 18, 1 << 19, 1 << 20, 1 << 21, 1 << 22, 1 << 23):
        src, dst = host[:words], dev[:words]
        us = {}
        for label, fn in (
            ("H2D direct", lambda: dst.copy_(src)),
            ("H2D staged", lambda: convert._stage_in(src, dst, ring, stream, convert.H2D_CHUNK_WORDS)),
            ("D2H direct", lambda: dst.cpu()),
            ("D2H staged", lambda: convert._stage_out(
                dst, torch.from_numpy(np.empty(words, np.int32)), ring, stream)),
        ):
            ts = []
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
            us[label] = sorted(ts)[5] * 1e6
        print(f"[6c copies] {words} words ({words * 4 / 2**20:g} MiB), us median of 10: "
              + ", ".join(f"{k} {v:.1f}" for k, v in us.items()), flush=True)


if __name__ == "__main__":
    main()
