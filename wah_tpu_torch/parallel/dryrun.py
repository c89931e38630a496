"""The sharded codec's dry run: N ranks in N processes run the whole
pipeline once — the counterpart of __graft_entry__.dryrun_multichip.

    python -m wah_tpu_torch.parallel N [--device cuda|cpu] [--save DIR]
                                       [--cases MODULE] [--check FILE.npz]
                                       [--timeout S]

The ranks are spawned with torch.multiprocessing and meet at a file://
rendezvous in a fresh temporary directory. On --device cuda (the
default) rank r takes cuda:(r % device count) and the backend follows
multihost.choose_backend: NCCL when every rank has a card of its own,
gloo otherwise (its gathers stage through host memory). On --device cpu
the ranks run the kernels' plain versions under gloo.

Each rank takes the reference's dry-run bitmap (32 blocks a rank of
Zipf 1.3 runs, every other block dense at 0.3, seed 7), then: its rows
-> encode_sharded -> stitch_global bounded by estimate_word_cap (retried
unbounded on overflow) -> decode_sharded of the stitched stream ->
gather_bitmap, and holds the stream against golden.encode and the bitmap
against the input. --check FILE.npz runs ShardedCodec on the bitmap
`data` of that file too, stream against its `stream`, round trip against
`data`. --save DIR writes each rank's dry-run stream and bitmap as
DIR/dryrun.rank<r>.npz; with --cases MODULE (an importable module whose
CASES maps a name to case(codec, device, group) -> dict of arrays) each
rank also runs every case and writes DIR/<name>.rank<r>.npz, for a test
to hold against a reference.

Exits 1 on any mismatch, on a rank's failure and on the timeout; every
rank is stopped before it returns.
"""
from __future__ import annotations

import argparse
import importlib
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.multiprocessing.spawn import ProcessException

from .. import golden
from ..constants import BLOCK_CHUNKS, BLOCK_INTS
from ..convert import tensor_to_words
from . import multihost
from ._comm import rank_and_size
from .dist import (
    ShardedCodec,
    decode_sharded,
    encode_sharded,
    estimate_word_cap,
    gather_bitmap,
    stitch_global,
)

__all__ = ["dryrun_bitmap", "pipeline", "run", "main"]


def dryrun_bitmap(n_ranks: int) -> np.ndarray:
    """__graft_entry__.dryrun_multichip's bitmap: 32 blocks a rank of
    alternating Zipf(1.3) x 31-bit runs, every other block replaced by
    ints that are 1 with probability 0.3, seed 7."""
    nb = 32 * n_ranks
    rng = np.random.default_rng(7)
    total_bits = nb * BLOCK_INTS * 32
    bits = np.zeros(total_bits, np.uint8)
    pos, val = 0, 0
    while pos < total_bits:
        ln = max(min(int(rng.zipf(1.3)) * 31, total_bits - pos), 1)
        bits[pos : pos + ln] = val
        pos += ln
        val ^= 1
    data = np.packbits(bits, bitorder="little").view(np.uint32)
    dense = (rng.random(data.shape) < 0.3).astype(np.uint32)
    blk = (np.arange(data.shape[0]) // BLOCK_INTS) % 2 == 1
    return np.where(blk, dense, data)


def pipeline(data: np.ndarray, device, group=None) -> dict:
    """encode_sharded -> stitch_global (estimate_word_cap, unbounded on
    overflow) -> decode_sharded -> gather_bitmap of a block-aligned bitmap,
    on this rank; returns the host stream and bitmap."""
    D = rank_and_size(group)[1]
    nb = data.shape[0] // BLOCK_INTS
    nv = golden.chunk_count(data.shape[0])
    words_l, totals = encode_sharded(multihost.host_shard_bitmap(data, device, group), nv, group)
    cap_w = estimate_word_cap(data, nb // D)
    stream, total, overflow = stitch_global(words_l, totals, cap_w, group)
    retried = bool(overflow)  # the same on every rank: it comes from the totals
    if retried:
        stream, total, overflow = stitch_global(words_l, totals, None, group)
    ints_l, n_chunks = decode_sharded(stream, int(total), nb * BLOCK_CHUNKS, group)
    if int(n_chunks) != nv:
        raise AssertionError(f"decode_sharded: {int(n_chunks)} chunks, want {nv}")
    return {"stream": tensor_to_words(stream[: int(total)]),
            "bitmap": gather_bitmap(ints_l, data.shape[0], group),
            "word_cap": np.int64(cap_w), "retried": np.bool_(retried)}


def _same(name: str, got: np.ndarray, want: np.ndarray) -> None:
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"{name}: {got.shape[0]} words against {want.shape[0]}, not equal")


def _rank(rank: int, n: int, kind: str, init_file: str, save_dir: str | None,
          cases: str | None, check: str | None) -> None:
    """One rank: bring up the group, run the dry run (and the cases and the
    --check bitmap), tear the group down."""
    backend = multihost.choose_backend(n, kind)
    device = multihost.local_device(kind, rank)
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=n,
                            rank=rank, timeout=multihost.TIMEOUT)
    try:
        if rank == 0:
            staged = backend != "nccl" and kind == "cuda"
            print(f"[dryrun] {n} ranks, backend {backend}"
                  f"{' (gathers staged through host memory)' if staged else ''}, "
                  f"rank 0 on {device}", flush=True)
        group = multihost.global_group()
        codec = ShardedCodec(device, group)
        t0 = time.perf_counter()
        data = dryrun_bitmap(n)
        out = pipeline(data, device, group)
        _same(f"rank {rank} dry-run stream", out["stream"], golden.encode(data))
        _same(f"rank {rank} dry-run bitmap", out["bitmap"], data)
        print(f"[dryrun] rank {rank}: {data.shape[0]} ints -> {out['stream'].shape[0]} words, "
              f"word_cap {int(out['word_cap'])} (retried unbounded: {bool(out['retried'])}), "
              f"stream == golden, round trip ok, {time.perf_counter() - t0:.2f} s", flush=True)
        if check:
            with np.load(check) as f:
                bitmap, want = f["data"], f["stream"]
            t0 = time.perf_counter()
            stream = codec.compress(bitmap)
            t1 = time.perf_counter()
            back = codec.decompress(stream, out_ints=bitmap.shape[0])
            t2 = time.perf_counter()
            _same(f"rank {rank} {check} stream", stream, want)
            _same(f"rank {rank} {check} round trip", back, bitmap)
            print(f"[dryrun] rank {rank}: {check}: {bitmap.shape[0]} ints -> {stream.shape[0]} words "
                  f"== its stream, round trip ok; ShardedCodec compress {t1 - t0:.3f} s, "
                  f"decompress {t2 - t1:.3f} s (host clock)", flush=True)
        if save_dir:
            np.savez(Path(save_dir) / f"dryrun.rank{rank}.npz", data=data, **out)
        if save_dir and cases:
            for name, case in importlib.import_module(cases).CASES.items():
                np.savez(Path(save_dir) / f"{name}.rank{rank}.npz", **case(codec, device, group))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run(n: int, kind: str = "cuda", save_dir: str | None = None, cases: str | None = None,
        check: str | None = None, timeout: float = 600.0) -> int:
    """Spawn n ranks, wait for them at most `timeout` seconds; 0 if every
    rank passed, else 1 (every rank is stopped either way)."""
    if kind == "cuda":
        if not torch.cuda.is_available():
            print("[dryrun] --device cuda: no CUDA device", file=sys.stderr)
            return 1
        from ..ops.cuda import _build

        _build.load()  # once here, not once a rank
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="wah_dryrun_")
    ctx = torch.multiprocessing.start_processes(
        _rank, args=(n, kind, os.path.join(tmp, "rendezvous"), save_dir, cases, check), nprocs=n,
        join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                print(f"[dryrun] timeout after {timeout:.0f} s", file=sys.stderr)
                return 1
    except ProcessException as e:  # join has stopped the other ranks
        print(f"[dryrun] FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[dryrun] {n} ranks: ok", flush=True)
    return 0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m wah_tpu_torch.parallel",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, help="number of ranks")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--save", help="write each rank's outputs here")
    ap.add_argument("--cases", help="module whose CASES each rank also runs and saves (with --save)")
    ap.add_argument("--check", help=".npz with a bitmap `data` and its `stream`")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.cases and not args.save:
        ap.error("--cases needs --save")
    sys.exit(run(args.n, args.device, args.save, args.cases, args.check, args.timeout))
