"""Cases of the sharded codec that test_torch_dist.py and test_torch_cuda.py
share; this module holds no test of its own and imports neither jax nor
wah_tpu, so that the ranks and the card can load it.

CASES are the cases of tests/test_dist.py, on the same bitmaps: the ranks
of `python -m wah_tpu_torch.parallel N --save DIR --cases
test_torch_dist_cases` run each one, and write its arrays to
DIR/<case>.rank<r>.npz for test_torch_dist.py to hold against wah_tpu.
COMPACT_TOTALS and compact_case give stitch_global's compaction a payload
at edge totals and its numpy result. CONFIGS4_INTS sizes the configs4_trip
case, BASELINE configs[4]'s operation (gpubench's sharded-configs4 cell)
at a size whose block count does not split evenly over the ranks.
"""
import numpy as np

from wah_tpu_torch import golden
from wah_tpu_torch.constants import BLOCK_CHUNKS, BLOCK_INTS
from wah_tpu_torch.convert import tensor_to_words, words_to_tensor
from wah_tpu_torch.parallel import (
    decode_sharded,
    encode_sharded,
    estimate_word_cap,
    gather_stream,
    multihost,
    stitch_global,
    stitch_word_cap,
)
from wah_tpu_torch.parallel._comm import all_gather, rank_and_size


def random_bitmap(n_ints: int, density: float, seed: int = 1337) -> np.ndarray:
    """conftest.random_bitmap: P(bit set) = density."""
    g = np.random.default_rng(seed)
    bits = g.random((n_ints, 32)) < density
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32).reshape(-1)


def clustered_bitmap(n_ints: int, seed: int = 1337, a: float = 1.5) -> np.ndarray:
    """conftest.clustered_bitmap: alternating 0/1 runs of Zipf(a) x 31 bits."""
    g = np.random.default_rng(seed)
    total = n_ints * 32
    bits = np.zeros(total, np.uint8)
    pos, val = 0, 0
    while pos < total:
        ln = max(1, min(int(g.zipf(a)) * 31, total - pos))
        bits[pos : pos + ln] = val
        pos += ln
        val ^= 1
    return np.packbits(bits, bitorder="little").view(np.uint32)


def _encode(data, device, group):
    return encode_sharded(multihost.host_shard_bitmap(data, device, group),
                          golden.chunk_count(data.shape[0]), group)


def _roundtrip(make):
    def case(codec, device, group):
        data = make()
        stream = codec.compress(data)
        return {"data": data, "stream": stream,
                "bitmap": codec.decompress(stream, out_ints=data.shape[0])}
    return case


def _totals_sum(codec, device, group):
    data = random_bitmap(8 * BLOCK_INTS, 1 / 64)
    words_l, totals = _encode(data, device, group)
    return {"data": data, "totals": totals.cpu().numpy(),
            "stream": gather_stream(words_l, totals, group)}


def _span_partition(codec, device, group):
    data = clustered_bitmap(8 * BLOCK_INTS, seed=3)
    stream = golden.encode(data)
    padded = np.zeros(-(-stream.shape[0] // 1024) * 1024, np.uint32)
    padded[: stream.shape[0]] = stream
    ints_l, n_chunks = decode_sharded(words_to_tensor(padded, device), stream.shape[0],
                                      8 * 1024, group)
    return {"data": data, "ints_l": tensor_to_words(ints_l), "n_chunks": np.int64(n_chunks)}


def _corrupt_stream(codec, device, group):
    try:
        codec.decompress(np.array([0x80000000], dtype=np.uint32))
    except ValueError as e:
        return {"error": np.array(f"ValueError: {e}")}
    raise AssertionError("decompress of a corrupt stream did not raise")


def _bounded_payload(codec, device, group):
    data = random_bitmap(16 * BLOCK_INTS, 1 / 256, seed=23)
    words_l, totals = _encode(data, device, group)
    cap_w = stitch_word_cap(totals)
    stream, total, overflow = stitch_global(words_l, totals, cap_w, group)
    _, full_total, _ = stitch_global(words_l, totals, None, group)
    return {"data": data, "word_cap": np.int64(cap_w), "cap_l": np.int64(words_l.shape[0]),
            "stream": tensor_to_words(stream), "total": np.int64(total),
            "overflow": np.bool_(overflow), "full_total": np.int64(full_total)}


def _overflow_flag(codec, device, group):
    data = random_bitmap(8 * BLOCK_INTS, 0.5, seed=29)
    words_l, totals = _encode(data, device, group)
    stream_b, total, overflow = stitch_global(words_l, totals, 64, group)
    stream, total_retry, overflow_retry = stitch_global(words_l, totals, None, group)
    return {"data": data, "totals": totals.cpu().numpy(), "total": np.int64(total),
            "overflow": np.bool_(overflow), "bounded_len": np.int64(stream_b.shape[0]),
            "stream": tensor_to_words(stream), "total_retry": np.int64(total_retry),
            "overflow_retry": np.bool_(overflow_retry)}


ESTIMATE_DENSITIES = ((1 / 2, 1), (1 / 16, 2), (1 / 1024, 3))


def _estimate_word_cap(codec, device, group):
    out = {}
    D = rank_and_size(group)[1]
    for i, (dens, seed) in enumerate(ESTIMATE_DENSITIES):
        data = random_bitmap(16 * BLOCK_INTS, dens, seed=seed)
        _, totals = _encode(data, device, group)
        out[f"data{i}"] = data
        out[f"totals{i}"] = totals.cpu().numpy()
        out[f"cap{i}"] = np.int64(estimate_word_cap(data, 16 // D))
    return out


def _host_shard_bitmap(codec, device, group):
    rank, D = rank_and_size(group)
    data = random_bitmap(3 * D * BLOCK_INTS, 0.1, seed=9)
    return {"data": data, "rows": tensor_to_words(multihost.host_shard_bitmap(data, device, group)),
            "rank": np.int64(rank)}


# 4 blocks and 300 ints: 5 blocks of chunks, padded to a multiple of the
# ranks, so that the last rank holds padding at 2 and 4 ranks
CONFIGS4_INTS = 4 * BLOCK_INTS + 300


def _configs4_trip(codec, device, group):
    """One operation of the sharded-configs4 cell on this rank's shard of a
    P(bit) = 0.01 bitmap: encode_sharded, stitch_global bounded by
    stitch_word_cap, decode_sharded of the replicated stream, the all-gather
    of the ranks' spans cut to the bitmap."""
    rank, D = rank_and_size(group)
    data = random_bitmap(CONFIGS4_INTS, 0.01, seed=41)
    nv = golden.chunk_count(data.shape[0])
    nb = -(-(-(-nv // BLOCK_CHUNKS)) // D) * D
    n_l = nb // D * BLOCK_INTS
    padded = np.zeros(nb * BLOCK_INTS, np.uint32)
    padded[: data.shape[0]] = data
    shard = words_to_tensor(padded[rank * n_l : (rank + 1) * n_l], device)
    words_l, totals = encode_sharded(shard, nv, group)
    stream, total, overflow = stitch_global(words_l, totals, stitch_word_cap(totals), group)
    m = int(total)
    ints_l, n_chunks = decode_sharded(stream, m, nb * BLOCK_CHUNKS, group)
    bitmap = all_gather(ints_l, group).reshape(-1)[: data.shape[0]]
    return {"data": data, "blocks": np.int64(nb), "stream": tensor_to_words(stream[:m]),
            "past_total": tensor_to_words(stream[m:]), "overflow": np.bool_(overflow),
            "n_chunks": np.int64(n_chunks), "bitmap": tensor_to_words(bitmap)}


ROUNDTRIPS = {  # tests/test_dist.py:43-69, 125-130
    "random": lambda: random_bitmap(16 * BLOCK_INTS, 1 / 16),
    "clustered": lambda: clustered_bitmap(16 * BLOCK_INTS),
    "all_zero": lambda: np.zeros(8 * BLOCK_INTS, np.uint32),
    "all_one": lambda: np.full(8 * BLOCK_INTS, 0xFFFFFFFF, np.uint32),
    "non_block_multiple": lambda: random_bitmap(5 * BLOCK_INTS + 17, 0.3, seed=7),
    "dense": lambda: random_bitmap(8 * BLOCK_INTS, 0.5),
    "codec_roundtrip": lambda: clustered_bitmap(8 * BLOCK_INTS, seed=5),
}

# each case(codec, device, group) -> the dict of arrays that one rank saves
CASES = {
    **{name: _roundtrip(make) for name, make in ROUNDTRIPS.items()},
    "totals_sum": _totals_sum,
    "span_partition": _span_partition,
    "corrupt_stream": _corrupt_stream,
    "bounded_payload": _bounded_payload,
    "overflow_flag": _overflow_flag,
    "estimate_word_cap": _estimate_word_cap,
    "host_shard_bitmap": _host_shard_bitmap,
    "configs4_trip": _configs4_trip,
}


COMPACT_TOTALS = {  # (eff, per-rank totals) of a gathered payload
    "edges": (2048, [0, 1023, 1024, 2048]),
    "not_a_tile": (1500, [1500, 0, 1, 1499]),
    "one_rank_full": (1024, [1024]),
    "all_empty": (3072, [0, 0, 0]),
    "overflowing": (1000, [1200, 5, 1000, 3000]),
}


def compact_case(name: str, seed: int = 0):
    """A random (D, eff) payload of nonzero words and its totals, and the
    numpy stream of each rank's first min(total, eff) words, zero-padded."""
    eff, totals = COMPACT_TOTALS[name]
    rng = np.random.default_rng(seed)
    segs = rng.integers(1, 2**32, size=(len(totals), eff), dtype=np.uint64).astype(np.uint32)
    live = np.minimum(totals, eff)
    want = np.zeros(len(totals) * eff, np.uint32)
    flat = np.concatenate([segs[d, : live[d]] for d in range(len(totals))])
    want[: len(flat)] = flat
    return segs, np.array(totals, np.int32), want
