"""Smoke test of the torch port (wah_tpu_torch) on one NVIDIA GPU.

Run from the repository root: `python3 chip_smoke.py`. It needs one CUDA
device, nvcc (PATH, CUDA_HOME or /usr/local/cuda) and no network, and
imports nothing of JAX or wah_tpu. Phases, one or more lines each:

  1. device   the card's name and power limit, as nvidia-smi reports them
  2. build    nvcc builds kernels K1-K4 from wah_tpu_torch/csrc/
  3. kernels  each kernel against its plain torch version on the card, at
              the main path's shapes (32,768 blocks, the 130 MB protocol):
              bit-exact, tolerance 0 (an integer codec)
  4. codec    WahCodec("cuda").compress / .decompress: the bench protocol
              (stream == golden, in full), clustered, all-zero, all-one,
              odd sizes, tiny, empty, and the 992 MB sweep size (stream ==
              the plain torch encode on the card); every case round-trips
  5. counts   every kernel launched during phase 4
  6. times    CUDA-event milliseconds of each kernel and each pipeline
              against the plain versions, at the 130 MB protocol

Any failure raises, so the exit code is not 0 and no result line is
printed. The second-to-last line is {"kernels": [...]}, the last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np

PROTOCOL_BLOCKS = 32768  # 130 MB bitmap: the bench protocol (bench.py)
SWEEP_MAX_BLOCKS = 262144  # 992 MB: the reference sweep's largest size (s = 256)
SEED = 1337

# (name, source, TPU kernel replaced)
KERNELS = [
    ("encode_tiles", "wah_tpu_torch/csrc/encode.cu", "wah_tpu/ops/pallas/encode_kernel.py:323"),
    ("stitch_tiles_v2", "wah_tpu_torch/csrc/stitch.cu", "wah_tpu/ops/pallas/stitch2.py:250"),
    ("prescan_words", "wah_tpu_torch/csrc/decode.cu", "wah_tpu/ops/pallas/decode_kernel.py:686"),
    ("decode_blocks", "wah_tpu_torch/csrc/decode.cu", "wah_tpu/ops/pallas/decode_kernel.py:470"),
]


def bench_bitmap(n_ints: int, seed: int = SEED) -> np.ndarray:
    """The bench protocol bitmap (bench.py:41-48): P(bit) = 2^-4."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 16, size=(n_ints, 32), dtype=np.uint8) == 0
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32).reshape(-1)


def sparse_bitmap(n_ints: int, seed: int = SEED) -> np.ndarray:
    """P(bit) = 2^-4 as the AND of four uniform words: the protocol's
    distribution without its 32x byte-per-bit intermediate."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 1 << 32, size=n_ints, dtype=np.uint32)
    for _ in range(3):
        out &= rng.integers(0, 1 << 32, size=n_ints, dtype=np.uint32)
    return out


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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the GPU")
    run(torch.device("cuda"))


def run(cuda) -> None:
    """All phases on the CUDA device `cuda`."""
    import torch

    from wah_tpu_torch import WahCodec, golden
    from wah_tpu_torch.convert import tensor_to_words, words_to_tensor
    from wah_tpu_torch.ops.cuda import _build
    from wah_tpu_torch.ops.cuda import decode_kernel as dk
    from wah_tpu_torch.ops.cuda import encode_kernel as ek
    from wah_tpu_torch.ops.cuda import stitch2

    wrappers = [ek.encode_tiles, stitch2.stitch_tiles_v2, dk.prescan_words, dk.decode_blocks]

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

    # 3. kernels against their plain versions at the protocol's shapes
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
    torch.cuda.synchronize()
    print(f"[3 kernels] {PROTOCOL_BLOCKS} blocks, stream {m} words: all bit-exact {errs}")

    # 4. the main path through the public API
    for w in wrappers:
        w.launches = 0
    codec = WahCodec(cuda)
    ratio = {}

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

    roundtrip("protocol_130MB_p2^-4_seed1337", data)
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
    del big, parts

    # 5. launch counts of the main path
    launches = {w.__name__: w.launches for w in wrappers}
    print(f"[5 counts] {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    # 6. times at the 130 MB protocol: kernel vs plain, each kernel and pipeline
    timed = {
        "encode_tiles": (lambda: ek.encode_tiles(ints2d, nv), lambda: ek.encode_tiles_plain(ints2d, nv)),
        "stitch_tiles_v2": (lambda: stitch2.stitch_tiles_v2(staging, offsets_ext),
                            lambda: stitch2.stitch_tiles_plain(staging, offsets_ext)),
        "prescan_words": (lambda: dk.prescan_words(stream, vc, rows),
                          lambda: dk.prescan_words_plain(stream, vc, rows)),
        "decode_blocks": (lambda: dk.decode_blocks(words_t, g_base, meta, nbo),
                          lambda: dk.decode_blocks_plain(words_t, g_base, meta, nbo)),
        "encode pipeline": (lambda: ek.encode_padded(ints, golden.chunk_count(n)),
                            lambda: ek.encode_padded_plain(ints, golden.chunk_count(n))),
        "decode pipeline": (lambda: dk.decode(stream, m, nbo * 1024),
                            lambda: dk.decode_plain(stream, m, nbo * 1024)),
    }
    ms = {}
    for name, (kernel_fn, plain_fn) in timed.items():
        # plain, kernel, kernel, plain: compare only within this run
        p1 = cuda_ms(plain_fn, 3)
        k1 = cuda_ms(kernel_fn, 20)
        k2 = cuda_ms(kernel_fn, 20)
        p2 = cuda_ms(plain_fn, 3)
        ms[name] = (min(k1, k2), min(p1, p2))
        gbs = data.nbytes / 1e6 / ms[name][0]
        print(f"[6 times] {name}: kernel {ms[name][0]:.4f} ms, plain {ms[name][1]:.4f} ms "
              f"(kernel {gbs:.2f} GB/s of bitmap) on {card}")
    print(f"[6 times] compression ratio (words / ints): {ratio}")

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": ms[name][0], "plain_ms": ms[name][1]}
        for name, src, rep in KERNELS
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
