"""On-hardware differential: every execution path of the port against the
golden model, on the GPU — the counterpart of tests/tpu_differential.py,
with the same case matrix (seeds and sizes unchanged).

The CPU tests run each kernel's plain version; this module runs the
compiled CUDA kernels over the full matrix.

Paths per case:
  api_enc / api_dec  WahCodec(device).compress / .decompress (K1-K4)
  fused              the single-kernel encode, K5 (encode_padded_fused)
  gather             the encode stitched by K6 (encode_padded, stitch="v1"),
                     the port of wah_tpu's stitch_tiles, which no entry
                     point takes
  native             the C++ host codec; the check fails if it cannot be built
Sections:
  batch_6cols        compress_batch / decompress_batch
  logical_ops        compressed-domain and/or/xor/andnot, k-way folds (3, 13, 16)
  batch_segments     compress_batch_segments / decompress_batch_segments
  sharded_1dev_mesh  parallel.ShardedCodec under a real process group of one
                     rank: NCCL on a card, gloo on the CPU (brought up and
                     torn down here unless a group is already up)

    python -m wah_tpu_torch.differential [--out GPU_DIFF.json] [--quick] [--device cuda]

Writes the report to --out and prints it once more as one JSON line, so a
committed GPU_DIFF.json is exactly what the card produced. Exits 1 on any
failed case. With --device cuda and no CUDA device it fails.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import golden, native
from .api import WahCodec
from .constants import BLOCK_CHUNKS, BLOCK_INTS
from .convert import tensor_to_words, words_to_tensor
from .ops.cuda import encode_kernel


def _bernoulli(n, density, seed):
    g = np.random.default_rng(seed)
    bits = g.random((n, 32)) < density
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32).reshape(-1)


def _clustered(n, seed, a):
    g = np.random.default_rng(seed)
    total = n * 32
    bits = np.zeros(total, np.uint8)
    pos, val = 0, 0
    while pos < total:
        ln = max(1, min(int(g.zipf(a)) * 31, total - pos))
        bits[pos : pos + ln] = val
        pos += ln
        val ^= 1
    return np.packbits(bits, bitorder="little").view(np.uint32)[:n]


def _alternating(n, period_chunks):
    """Alternating zero/one runs of `period_chunks` 31-bit chunks."""
    nchunks = (n * 32) // 31 + 1
    chunk_vals = (np.arange(nchunks) // period_chunks) % 2
    bits = np.repeat(chunk_vals, 31).astype(np.uint8)[: n * 32]
    return np.packbits(bits, bitorder="little").view(np.uint32)[:n]


def _wandering_literal(n_blocks):
    """One set bit sliding through each 31-int group (reference
    tests.cpp:33-39 pattern, extended across blocks)."""
    return np.uint32(1) << (np.arange(n_blocks * BLOCK_INTS, dtype=np.uint32) % np.uint32(31))


def build_cases(quick=False):
    NB = 40  # main size: 40 blocks (~5 MB)
    n = NB * BLOCK_INTS
    cases = [
        ("sparse_2^-16", _bernoulli(n, 2.0**-16, 1)),
        ("mid_2^-4", _bernoulli(n, 2.0**-4, 2)),
        ("dense_0.5", _bernoulli(n, 0.5, 3)),
        ("very_dense_0.999", _bernoulli(n, 0.999, 4)),
        ("sparse_2^-10", _bernoulli(n, 2.0**-10, 5)),
        ("clustered_zipf1.5", _clustered(n, 6, 1.5)),
        ("clustered_zipf1.1", _clustered(n, 7, 1.1)),
        ("all_zeros", np.zeros(n, np.uint32)),
        ("all_ones", np.full(n, 0xFFFFFFFF, np.uint32)),
        ("alt_64chunk", _alternating(n, 64)),
        ("alt_1chunk", _alternating(n, 1)),
        ("wandering_literal", _wandering_literal(NB)),
        ("ones_spikes_in_zeros",
         np.where(np.random.default_rng(8).random(n) < 0.01,
                  np.uint32(0xFFFFFFFF), np.uint32(0))),
        ("zero_spikes_in_ones",
         np.where(np.random.default_rng(9).random(n) < 0.01,
                  np.uint32(0), np.uint32(0xFFFFFFFF))),
        # non-block / non-warp multiples (defined-padding semantics)
        ("odd_nonblock", _bernoulli(17 * BLOCK_INTS + 345, 0.1, 10)),
        ("odd_nonwarp", _bernoulli(20 * BLOCK_INTS + 17, 0.03, 11)),
        ("single_trailing_bit",
         np.concatenate([np.zeros(n - 1, np.uint32), np.array([0x80000000], np.uint32)])),
        ("single_leading_bit",
         np.concatenate([np.array([1], np.uint32), np.zeros(n - 1, np.uint32)])),
        ("tiny_4ints", np.array([0x1, 0, 0, 0xFFFFFFFF], np.uint32)),
        ("tiny_31ints", _bernoulli(31, 0.2, 12)),
        ("block_seam_runs", _alternating(n, 1024)),  # max-length fills
        ("near_block_seam", _alternating(n, 1023)),
    ]
    return cases[:6] if quick else cases


def _card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def _native_encode_equals(data: np.ndarray, ref: np.ndarray) -> bool:
    try:
        return bool(np.array_equal(native.encode(data), ref))
    except RuntimeError as e:  # the library could not be built: a failed check
        print(f"native: {e}", flush=True)
        return False


def run(device="cuda", quick: bool = False) -> dict:
    """Run the matrix on `device`; return the report (report["summary"]
    ["failed"] counts the failed cases). Raises if `device` is a CUDA
    device and there is none."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("differential: no CUDA device (pass --device cpu for the plain versions)")
    codec = WahCodec(device)
    t0 = time.time()
    report = {
        "backend": "torch-cuda" if on_card else "torch-cpu (plain versions, no kernel ran)",
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "card": _card_line() if on_card else None,
        "torch": torch.__version__,
        "cases": [],
    }
    fails = 0

    def record(name, checks, extra=None):
        nonlocal fails
        ok = all(checks.values())
        fails += not ok
        report["cases"].append({"case": name, "ok": ok, **checks, **(extra or {})})
        print(f"{'ok ' if ok else 'FAIL'} {name:24s} "
              + " ".join(f"{k}={v}" for k, v in checks.items()), flush=True)

    # ---- single-stream matrix -------------------------------------------
    for name, data in build_cases(quick):
        n = len(data)
        ref = golden.encode(data)
        stream, _ = codec.compress(data)
        out, _ = codec.decompress(stream, out_ints=n)

        nv = golden.chunk_count(n)
        padded = words_to_tensor(data, device, size=-(-nv // BLOCK_CHUNKS) * BLOCK_INTS)
        w3, t3 = encode_kernel.encode_padded_fused(padded, nv)
        fused = tensor_to_words(w3[: int(t3)])
        encode_kernel.check_fused_error()
        w1, t1 = encode_kernel.encode_padded(padded, nv, stitch="v1")
        record(name, {
            "api_enc": bool(np.array_equal(stream, ref)),
            "api_dec": bool(np.array_equal(out, data)),
            "fused": bool(np.array_equal(fused, ref)),
            "gather": bool(np.array_equal(tensor_to_words(w1[: int(t1)]), ref)),
            "native": _native_encode_equals(data, ref),
        }, {"n_ints": n, "words": len(ref)})

    # ---- batched columns (bitmap-index workload) ------------------------
    cols = np.stack([
        _bernoulli(8 * BLOCK_INTS, d, 20 + i)
        for i, d in enumerate([2.0**-12, 2.0**-4, 0.5, 0.0, 1.0, 0.01])
    ]).astype(np.uint32)
    cols[3, :] = 0
    cols[4, :] = 0xFFFFFFFF
    words_b, totals_b = codec.compress_batch(cols)
    bok = all(
        np.array_equal(words_b[c, : totals_b[c]], golden.encode(cols[c]))
        for c in range(cols.shape[0])
    )
    outs_b = codec.decompress_batch(words_b, totals_b, out_ints=cols.shape[1])
    record("batch_6cols", {"batch_enc": bool(bok),
                           "batch_dec": bool(np.array_equal(outs_b, cols))})

    # ---- compressed-domain logical ops ----------------------------------
    a = _bernoulli(8 * BLOCK_INTS, 0.05, 30)
    b = _clustered(8 * BLOCK_INTS, 31, 1.4)
    sa, sb = golden.encode(a), golden.encode(b)
    lchecks = {}
    for op, npop in [
        ("and", np.bitwise_and),
        ("or", np.bitwise_or),
        ("xor", np.bitwise_xor),
        ("andnot", lambda x, y: x & ~y),
    ]:
        got = codec.logical(sa, sb, op, n_ints=len(a))
        lchecks[op] = bool(np.array_equal(got, golden.encode(npop(a, b).astype(np.uint32))))
    # k-way folds (one batched decode, a tree reduce, one encode)
    c = _bernoulli(8 * BLOCK_INTS, 0.3, 32)
    got3 = codec.logical_many([sa, sb, golden.encode(c)], "or", len(a))
    lchecks["many_or"] = bool(np.array_equal(got3, golden.encode((a | b | c).astype(np.uint32))))
    # k = 16 (a whole tree) and k = 13 (padded with identity streams)
    kcols = [
        _bernoulli(8 * BLOCK_INTS, d, 100 + i)
        for i, d in enumerate([2.0**-10, 0.4, 0.0, 2.0**-4, 1.0, 0.01] * 3)
    ]
    for kk in (16, 13):
        ks = [golden.encode(x) for x in kcols[:kk]]
        want = golden.encode(np.bitwise_or.reduce(kcols[:kk]))
        lchecks[f"many_or_k{kk}"] = bool(
            np.array_equal(codec.logical_many(ks, "or", 8 * BLOCK_INTS), want)
        )
    wanta = golden.encode(np.bitwise_and.reduce(kcols[:16]))
    lchecks["many_and_k16"] = bool(np.array_equal(
        codec.logical_many([golden.encode(x) for x in kcols[:16]], "and", 8 * BLOCK_INTS), wanta
    ))
    record("logical_ops", lchecks)

    # ---- column-segmented batched codec (BASELINE configs[3] machinery) --
    nseg = 3 * BLOCK_INTS + 77
    segcols = np.stack([
        _bernoulli(nseg, 2.0**-6, 50),
        _bernoulli(nseg, 0.5, 51),
        np.zeros(nseg, np.uint32),
        _clustered(nseg, 52, 1.3),
    ])
    seg_streams = codec.compress_batch_segments(segcols, segment_ints=BLOCK_INTS)
    seg_enc_ok = all(
        np.array_equal(seg_streams[c], golden.encode(segcols[c])) for c in range(4)
    )
    seg_out = codec.decompress_batch_segments(seg_streams, out_ints=nseg, segment_ints=BLOCK_INTS)
    record("batch_segments", {"seg_enc": bool(seg_enc_ok),
                              "seg_dec": bool(np.array_equal(seg_out, segcols))})

    # ---- sharded codec, one rank of a real process group ----------------
    record("sharded_1dev_mesh", _sharded_checks(device))

    n_cases = len(report["cases"])
    report["summary"] = {
        "total_cases": n_cases,
        "failed": fails,
        "elapsed_s": round(time.time() - t0, 1),
    }
    return report


def _sharded_checks(device: torch.device) -> dict:
    """tests/tpu_differential.py's sharded section: ShardedCodec on three
    16-block bitmaps, stream == golden and round trip. Runs under the
    group that is up, else under one of world size 1 that it brings up
    (NCCL on a CUDA device, gloo on the CPU) and tears down."""
    import torch.distributed as dist

    from .parallel import ShardedCodec, multihost

    tmp = None
    if not dist.is_initialized():
        tmp = tempfile.mkdtemp(prefix="wah_diff_")
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)  # NCCL runs on the current device
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0,
                                timeout=multihost.TIMEOUT)
    try:
        codec = ShardedCodec(device, multihost.global_group())
        checks = {}
        for sname, sdata in [
            ("sparse", _bernoulli(16 * BLOCK_INTS, 2.0**-8, 40)),
            ("dense", _bernoulli(16 * BLOCK_INTS, 0.5, 41)),
            ("clustered", _clustered(16 * BLOCK_INTS, 42, 1.3)),
        ]:
            stream = codec.compress(sdata)
            checks[f"enc_{sname}"] = bool(np.array_equal(stream, golden.encode(sdata)))
            checks[f"dec_{sname}"] = bool(np.array_equal(
                codec.decompress(stream, out_ints=len(sdata)), sdata))
    finally:
        if tmp is not None:
            dist.destroy_process_group()
            shutil.rmtree(tmp, ignore_errors=True)
    return checks


def summary_line(report: dict) -> str:
    s = report["summary"]
    return (f"{s['total_cases'] - s['failed']}/{s['total_cases']} differential cases bit-exact "
            f"({s['elapsed_s']} s) on {report['card'] or report['device']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m wah_tpu_torch.differential")
    ap.add_argument("--out", default="GPU_DIFF.json")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    report = run(args.device, args.quick)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
        f.write("\n")
    print(json.dumps(report), flush=True)
    print(f"{summary_line(report)} -> {args.out}", flush=True)
    if report["summary"]["failed"]:
        sys.exit(1)
    print("DIFFERENTIAL OK", flush=True)


if __name__ == "__main__":
    main()
