"""On-card tests of the CUDA kernels K1-K6, T1 and V1 (marker `cuda`).

Each kernel against its plain torch version on the same CUDA tensors, and
WahCodec("cuda") against the golden model, on small edge cases that
chip_smoke.py does not reach: partial and shard-offset validity, the
long-fill and granule-window-extreme streams, a decoded span; K1, K4 and
K5 at block counts that no grid divides, decoded spans past the stream's
end, K1's validity with the bound inside a block, a capacity-filling
column beside an all-zero one; K6's
offset ties, exact-tile, full and one-word totals; batched columns with a
capacity-filling column and garbage tails; the logical pipeline; K5
against its plain version, the K1 + K2 pipeline and golden, at block
counts around its tile and its persistent grid, with every block past the
bound, twice and ten times in a row on different inputs; T1's kernel with
ties, odd search spans, key rows in rounds and negative values; the
segment paths and the differential's quick matrix; the sharded codec's K2
compaction of a gathered payload at edge totals, the per-rank decode from
a chunk base, the bodies of eight ranks, and ShardedCodec("cuda") at a
world of one; V1 (the stream check) against its plain twin on the cases
of tests/test_torch_stream_check.py and on a 2^-4 protocol stream with
bad words past its last 16 B vector, WahCodec("cuda").decompress
checking on the card alone, and decompress_batch (a V1 launch a column)
and ShardedCodec.decompress raising the CPU codec's messages; every host
entry point with the host checks and padded host arrays refused;
convert's rows copied as they are and widened on the card; convert's
pinned staging ring: both directions
bit-exact at 0 and 1 words, around the staging threshold and a chunk of
each direction and past a ring's worth of chunks, with and without
`size=` (the tail zeroed),
results that keep their words and never alias the ring, the ring made
once, WahCodec's copies counted by route and in the spans' staged_chunks,
two threads round-tripping through one codec; utils.profiling: K1's graph-replayed time against its
CUDA-event time, captured encode and decode pipelines replayed against
eager calls, a capture with a host read refused (last in the file); the
entry points and ShardedCodec() in a one-rank group on the card by
default.
Tolerance is zero (an integer codec). They skip without a CUDA device.
The card's machine has no JAX, so run them there without the JAX
conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from wah_tpu_torch import BitmapIndex, WahCodec, convert, golden
from wah_tpu_torch.constants import BLOCK_CHUNKS, BLOCK_INTS
from wah_tpu_torch.convert import tensor_to_words, words_to_tensor
from wah_tpu_torch.ops.cuda import decode_kernel as dk
from wah_tpu_torch.ops.cuda import encode_kernel as ek
from wah_tpu_torch.ops import logical
from wah_tpu_torch.ops.cuda import scan_check, stitch2
from wah_tpu_torch.ops.cuda import stream_check as sc
from test_torch_dist_cases import COMPACT_TOTALS, compact_case
from test_torch_stream_check import CASES as CHECK_CASES
from test_torch_stream_check import (BATCH_FAULTS, HOST_PATHS, N_HOST, STREAM_FAULTS, _batch,
                                     _host_path, _message, _refuse_host_passes, _stream_with)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bitmap(n_ints: int, density: float, seed: int) -> np.ndarray:
    bits = np.random.default_rng(seed).random((n_ints, 32)) < density
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32).reshape(-1)


def _granule_extremes() -> np.ndarray:
    rng = np.random.default_rng(77)
    lits = rng.integers(1, golden.ONES31 - 1, size=1278, dtype=np.uint32)
    return np.concatenate(
        [lits[:127], np.array([golden.BIT31 | 770], dtype=np.uint32), lits[127:]]
    ).astype(np.uint32)


BITMAPS = {
    "sparse": lambda: _bitmap(9 * BLOCK_INTS, 1 / 64, 1),
    "dense": lambda: _bitmap(8 * BLOCK_INTS, 0.5, 2),
    "odd_size": lambda: _bitmap(3 * BLOCK_INTS + 345, 0.1, 3),
    "all_zeros": lambda: np.zeros(64 * BLOCK_INTS, np.uint32),
    "all_ones": lambda: np.full(8 * BLOCK_INTS, 0xFFFFFFFF, np.uint32),
    "tiny": lambda: np.array([0x1, 0, 0, 0xFFFFFFFF], dtype=np.uint32),
}


@pytest.mark.parametrize("base", [0, 2 * BLOCK_CHUNKS])
@pytest.mark.parametrize("name", BITMAPS)
def test_encode_kernels_match_plain(cuda, name, base):
    data = BITMAPS[name]()
    nv = golden.chunk_count(len(data))
    nb = -(-nv // BLOCK_CHUNKS) + 1  # one block of padding past the valid end
    padded = np.zeros(nb * BLOCK_INTS, np.uint32)
    padded[: len(data)] = data
    ints = words_to_tensor(padded, cuda)
    nv_t = torch.tensor([base + nv, base], dtype=torch.int32, device=cuda)
    staging, counts = ek.encode_tiles(ints.view(nb, -1), nv_t)
    staging_p, counts_p = ek.encode_tiles_plain(ints.view(nb, -1), nv_t)
    assert torch.equal(staging, staging_p) and torch.equal(counts, counts_p)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts[:, 0], 0, dtype=torch.int32)])
    total = int(offsets[-1])
    want = stitch2.stitch_tiles_plain(staging, offsets)[:total]
    assert torch.equal(stitch2.stitch_tiles_v2(staging, offsets)[:total], want)
    assert torch.equal(stitch2.stitch_tiles_v2(staging, offsets, counts[:, 0].contiguous())[:total], want)
    np.testing.assert_array_equal(tensor_to_words(want), golden.encode(data))


STREAMS = {name: (lambda f=f: golden.encode(f())) for name, f in BITMAPS.items()}
STREAMS["granule_extremes"] = _granule_extremes


@pytest.mark.parametrize("name", STREAMS)
def test_decode_kernels_match_plain(cuda, name):
    stream = STREAMS[name]()
    m = len(stream)
    M = -(-m // 1024) * 1024 + 1024
    words = torch.zeros(M, dtype=torch.int32, device=cuda)
    words[:m] = words_to_tensor(stream, cuda)
    rows = M // 128 + 3
    vc = (m - 128 * torch.arange(rows, device=cuda)).clamp(0, 128).to(torch.int32)
    words_t, g_sums = dk.prescan_words(words, vc, rows)
    words_t_p, g_sums_p = dk.prescan_words_plain(words, vc, rows)
    assert torch.equal(words_t, words_t_p) and torch.equal(g_sums, g_sums_p)
    n_chunks = int(g_sums.sum())
    cap = -(-n_chunks // BLOCK_CHUNKS) * BLOCK_CHUNKS
    for base in sorted({0, cap // 2 // BLOCK_CHUNKS * BLOCK_CHUNKS}):
        ints, n_ints = dk.decode(words, m, cap - base, chunk_base=base)
        ints_p, n_ints_p = dk.decode_plain(words, m, cap - base, chunk_base=base)
        assert int(n_ints) == int(n_ints_p) == n_chunks - n_chunks // 32
        assert torch.equal(ints, ints_p), base
    np.testing.assert_array_equal(
        tensor_to_words(dk.decode(words, m, cap)[0])[: n_chunks - n_chunks // 32],
        golden.decode(stream),
    )


@pytest.mark.parametrize("name", BITMAPS)
def test_codec_on_cuda_matches_golden(cuda, name):
    data = BITMAPS[name]()
    codec = WahCodec(cuda)
    stream, _ = codec.compress(data)
    np.testing.assert_array_equal(stream, golden.encode(data))
    out, _ = codec.decompress(stream, out_ints=len(data))
    np.testing.assert_array_equal(out, data)
    full, _ = codec.decompress(stream)
    np.testing.assert_array_equal(full, golden.decode(stream))


def test_launch_counts_only_on_cuda(cuda):
    before = [ek.encode_tiles.launches, dk.decode_blocks.launches]
    data = BITMAPS["sparse"]()
    WahCodec("cpu").decompress(WahCodec("cpu").compress(data)[0])
    assert [ek.encode_tiles.launches, dk.decode_blocks.launches] == before
    WahCodec(cuda).decompress(WahCodec(cuda).compress(data)[0])
    assert ek.encode_tiles.launches == before[0] + 1
    assert dk.decode_blocks.launches == before[1] + 1


# per-row word counts: offset ties in the middle and at the end, a total
# that is an exact multiple of 1024, every row full, a single word, and
# sparse rows (many rows to a tile)
STITCH_COUNTS = {
    "ties_middle_and_end": [0] * 5 + [3, 0, 0, 700] + [1024] * 3 + [0] * 20,
    "exact_tiles": [512, 512, 0, 1024, 0, 1000, 24],
    "all_rows_full": [1024] * 8,
    "one_word": [1] + [0] * 9,
    "one_word_per_row": [1] * 3000,
    "random": list(np.random.default_rng(5).integers(0, 1025, 200)),
    "empty": [0] * 7,
}


@pytest.mark.parametrize("name", STITCH_COUNTS)
def test_stitch_tiles_matches_plain(cuda, name):
    counts = np.asarray(STITCH_COUNTS[name], np.int64)
    nb = len(counts)
    rng = np.random.default_rng(nb)
    staging = rng.integers(1, 2**31 - 1, size=(nb, BLOCK_CHUNKS)).astype(np.int32)
    staging[np.arange(BLOCK_CHUNKS)[None, :] >= counts[:, None]] = 0
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    total = int(offsets[-1])
    end = -(-total // BLOCK_CHUNKS) * BLOCK_CHUNKS  # the last tile holding words
    st, off = torch.from_numpy(staging).to(cuda), torch.from_numpy(offsets).to(cuda)
    before = ek.stitch_tiles.launches
    got = ek.stitch_tiles(st, off)
    want = stitch2.stitch_tiles_plain(st, off)
    assert ek.stitch_tiles.launches == before + 1
    assert got.shape == (nb * BLOCK_CHUNKS,)
    assert torch.equal(got[:end], want[:end])  # the prefix, then zeros to the tile's end
    assert not want[total:end].any()


@pytest.mark.parametrize("stitch", ["v1", "v3"])
@pytest.mark.parametrize("name", ["sparse", "dense", "all_zeros", "odd_size"])
def test_encode_padded_stitches_match_golden(cuda, name, stitch):
    data = BITMAPS[name]()
    nv = golden.chunk_count(len(data))
    nb = -(-nv // BLOCK_CHUNKS)
    padded = np.zeros(nb * BLOCK_INTS, np.uint32)
    padded[: len(data)] = data
    words, total = ek.encode_padded(words_to_tensor(padded, cuda), nv, stitch=stitch)
    np.testing.assert_array_equal(tensor_to_words(words[: int(total)]), golden.encode(data))


def _batch_columns(n: int) -> np.ndarray:
    rng = np.random.default_rng(42)
    return np.stack([
        _bitmap(n, 1 / 64, 11),
        rng.integers(1, 2**32, size=n, dtype=np.uint64).astype(np.uint32),  # fills its capacity
        np.zeros(n, np.uint32),
        _bitmap(n, 0.5, 12),
        np.full(n, 0xFFFFFFFF, np.uint32),
    ])


@pytest.mark.parametrize("group_rows", [1 << 19, 16])
def test_batch_kernels_match_plain(cuda, group_rows):
    nb = 8
    cols = _batch_columns(nb * BLOCK_INTS)
    C, nv = cols.shape[0], golden.chunk_count(cols.shape[1])
    rows = words_to_tensor(cols.reshape(-1), cuda).view(C * nb, BLOCK_INTS)
    words, totals = ek.encode_rows_batch(rows, C, nv, group_rows=group_rows)
    words_p, totals_p = ek.encode_rows_batch_plain(rows, C, nv, group_rows=group_rows)
    assert torch.equal(totals, totals_p) and int(totals[1]) == nb * BLOCK_CHUNKS
    words, words_p = words.view(C, -1), words_p.view(C, -1)
    for c in range(C):
        t = int(totals[c])
        assert torch.equal(words[c, :t], words_p[c, :t]), c
        np.testing.assert_array_equal(tensor_to_words(words[c, :t]), golden.encode(cols[c]))

    # decode the same streams behind tails of random words, fill words among them
    Mcap = nb * BLOCK_CHUNKS + BLOCK_CHUNKS
    rng = np.random.default_rng(3)
    flat = torch.from_numpy(rng.integers(-2**31, 2**31, size=(C, Mcap)).astype(np.int32)).to(cuda)
    for c in range(C):
        flat[c, : int(totals[c])] = words[c, : int(totals[c])]
    ms = totals.to(torch.int32)
    cap = nb * BLOCK_CHUNKS
    ints = dk.decode_rows_batch(flat.view(-1), C, ms, cap)
    ints_p = dk.decode_rows_batch_plain(flat.view(-1), C, ms, cap)
    assert torch.equal(ints, ints_p)
    np.testing.assert_array_equal(tensor_to_words(ints).reshape(C, -1), cols)


def test_codec_batch_on_cuda_matches_golden(cuda):
    cols = _batch_columns(5 * BLOCK_INTS + 77)
    codec = WahCodec(cuda)
    words, totals = codec.compress_batch(cols)
    for c in range(cols.shape[0]):
        np.testing.assert_array_equal(words[c, : totals[c]], golden.encode(cols[c]))
    np.testing.assert_array_equal(codec.decompress_batch(words, totals, cols.shape[1]), cols)
    # columns of unequal length expand unequally: one single-stream decode each
    short = golden.encode(cols[0][: 2 * BLOCK_INTS])
    w2 = np.zeros((2, max(len(short), totals[3])), np.uint32)
    w2[0, : len(short)], w2[1, : totals[3]] = short, words[3, : totals[3]]
    before = dk.decode_blocks.launches
    out = codec.decompress_batch(w2, np.array([len(short), totals[3]]))
    assert dk.decode_blocks.launches == before + 2
    np.testing.assert_array_equal(out[0, : 2 * BLOCK_INTS], cols[0][: 2 * BLOCK_INTS])
    np.testing.assert_array_equal(out[1, : cols.shape[1]], cols[3])


@pytest.mark.parametrize("op", sorted(logical.OPS))
def test_logical_pipeline_matches_plain(cuda, op):
    n = 9 * BLOCK_INTS + 111
    a, b = _bitmap(n, 1 / 64, 21), _bitmap(n, 1 / 64, 22)
    sa, sb = golden.encode(a), golden.encode(b)
    M = -(-max(len(sa), len(sb)) // BLOCK_CHUNKS) * BLOCK_CHUNKS
    ta, tb = torch.zeros(M, dtype=torch.int32, device=cuda), torch.zeros(M, dtype=torch.int32, device=cuda)
    ta[: len(sa)], tb[: len(sb)] = words_to_tensor(sa, cuda), words_to_tensor(sb, cuda)
    k6, k2 = ek.stitch_tiles.launches, stitch2.stitch_tiles_v2.launches
    words, total = logical.logical_op(ta, len(sa), tb, len(sb), op, n)
    words_p, total_p = logical.logical_op(ta, len(sa), tb, len(sb), op, n, plain=True)
    assert int(total) == int(total_p)
    assert torch.equal(words[: int(total)], words_p[: int(total)])
    want = {"and": a & b, "or": a | b, "xor": a ^ b, "andnot": a & ~b}[op]
    np.testing.assert_array_equal(tensor_to_words(words[: int(total)]), golden.encode(want))
    # K2 stitches every result, the sparse AND (~2^-12) too; K6 never runs
    assert ek.stitch_tiles.launches == k6
    assert stitch2.stitch_tiles_v2.launches == k2 + 1


@pytest.mark.parametrize("op", ["or", "and", "xor"])
@pytest.mark.parametrize("k", [2, 3, 5, 16])
def test_logical_fold_matches_plain(cuda, op, k):
    n = 4 * BLOCK_INTS + 37
    cols = [_bitmap(n, d, 40 + i) for i, d in zip(range(k), [0.02, 0.6, 0.0, 1.0] * 4)]
    streams = [golden.encode(c) for c in cols]
    M = -(-max(map(len, streams)) // BLOCK_CHUNKS) * BLOCK_CHUNKS
    flat = np.zeros((k, M), np.uint32)
    for i, s in enumerate(streams):
        flat[i, : len(s)] = s
    ft = words_to_tensor(flat.reshape(-1), cuda)
    ms = torch.tensor([len(s) for s in streams], dtype=torch.int32, device=cuda)
    words, total = logical.logical_reduce_flat(ft, k, ms, op, n)
    words_p, total_p = logical.logical_reduce_flat(ft, k, ms, op, n, plain=True)
    assert int(total) == int(total_p)
    assert torch.equal(words[: int(total)], words_p[: int(total)])
    fold = {"or": np.bitwise_or, "and": np.bitwise_and, "xor": np.bitwise_xor}[op]
    np.testing.assert_array_equal(tensor_to_words(words[: int(total)]), golden.encode(fold.reduce(cols)))


def test_index_on_cuda_matches_numpy(cuda):
    rng = np.random.default_rng(7)
    values = rng.integers(0, 8, size=20_000 * 32 + 17)
    values[100_000:300_000] = 3
    idx = BitmapIndex.build(values, 8, codec=WahCodec(cuda))
    np.testing.assert_array_equal(idx.rows(idx.query_eq(3)), np.flatnonzero(values == 3))
    np.testing.assert_array_equal(idx.rows(idx.query_range(2, 5)),
                                  np.flatnonzero((values >= 2) & (values <= 5)))
    assert idx.count(idx.query_in([0, 7])) == int(np.isin(values, [0, 7]).sum())
    assert idx.count(idx.query_not(3)) == int((values != 3).sum())
    k6, k2 = ek.stitch_tiles.launches, stitch2.stitch_tiles_v2.launches
    empty = idx.codec.logical(idx.column(0), idx.column(1), "and", idx.n_ints)
    assert idx.count(empty) == 0
    assert ek.stitch_tiles.launches == k6 and stitch2.stitch_tiles_v2.launches == k2 + 1


def _padded(data: np.ndarray, extra_blocks: int = 0):
    nv = golden.chunk_count(len(data))
    nb = -(-nv // BLOCK_CHUNKS) + extra_blocks
    padded = np.zeros(nb * BLOCK_INTS, np.uint32)
    padded[: len(data)] = data
    return padded, nv


@pytest.mark.parametrize("name", BITMAPS)
def test_encode_fused_matches_plain_pipeline_and_golden(cuda, name):
    data = BITMAPS[name]()
    padded, nv = _padded(data)
    ints = words_to_tensor(padded, cuda)
    before = ek.encode_fused.launches
    words, total = ek.encode_padded_fused(ints, nv)
    assert ek.encode_fused.launches == before + 1 and total.device.type == "cuda"
    words_p, total_p = ek.encode_padded_fused_plain(ints, nv)
    words_2, total_2 = ek.encode_padded(ints, nv, stitch="v3")
    t = int(total)
    ek.check_fused_error()
    assert t == int(total_p) == int(total_2)
    assert torch.equal(words[:t], words_p[:t]) and torch.equal(words[:t], words_2[:t])
    np.testing.assert_array_equal(tensor_to_words(words[:t]), golden.encode(data))
    nv_t = torch.tensor([nv, 0], dtype=torch.int32, device=cuda)
    _, counts = ek.encode_fused(ints.view(-1, BLOCK_INTS), nv_t)
    assert torch.equal(counts, ek.encode_fused_plain(ints.view(-1, BLOCK_INTS), nv_t)[1])


def test_encode_fused_twice_in_a_row_on_different_inputs(cuda):
    """A launch must not pass on what an earlier one left in its workspace."""
    a, nva = _padded(_bitmap(3000 * BLOCK_INTS, 1 / 16, 31))
    b, nvb = _padded(_bitmap(3000 * BLOCK_INTS, 1 / 256, 32))
    ta, tb = words_to_tensor(a, cuda), words_to_tensor(b, cuda)
    wa, na = ek.encode_padded_fused(ta, nva)
    wb, nb_ = ek.encode_padded_fused(tb, nvb)  # enqueued before anything is read
    ek.check_fused_error()
    for (w, n), (x, nv) in (((wa, na), (ta, nva)), ((wb, nb_), (tb, nvb))):
        w_p, n_p = ek.encode_padded_fused_plain(x, nv)
        assert int(n) == int(n_p) and torch.equal(w[: int(n)], w_p[: int(n)])
    assert int(na) != int(nb_)


def test_encode_fused_shard_padding_emits_no_spurious_words(cuda):
    """A non-final shard's padding rows lie below the global bound: the clamp
    to the call's own blocks keeps them from emitting BIT31|1024 words."""
    nb = 4
    data = words_to_tensor(np.zeros(nb * BLOCK_INTS, np.uint32), cuda)
    for base in (0, nb * BLOCK_CHUNKS):
        words, total = ek.encode_padded_fused(data, 8 * nb * BLOCK_CHUNKS, base)
        assert int(total) == nb
        np.testing.assert_array_equal(
            tensor_to_words(words[:nb]), np.full(nb, 0x80000000 | 1024, np.uint32))
    # a bound inside the call: the blocks past it emit nothing
    words, total = ek.encode_padded_fused(data, 2 * BLOCK_CHUNKS + 5, 0)
    assert int(total) == 3 and tensor_to_words(words[:3]).tolist() == [
        0x80000000 | 1024, 0x80000000 | 1024, 0x80000000 | 5]
    ek.check_fused_error()


# K5 looks back over tiles of FUSED_TILE_BLOCKS blocks from a persistent grid
# of c CTAs on each SM (c depends on the build: every c a 128-thread CTA
# allows is tried). (c, d): d tiles more than c CTAs an SM hold; (0, n): n blocks
TILE = ek.FUSED_TILE_BLOCKS
FUSED_BLOCKS = [(0, n) for n in (TILE - 1, TILE, TILE + 1, 2 * TILE + 1, 7 * TILE + 2)] + [
    (c, d) for c in (1, 2, 3, 4, 5, 6, 7, 8, 12, 16) for d in (-1, 1)]


def _ands(n_ints: int, ands: int, seed: int) -> np.ndarray:
    """P(bit) = 2^-ands as the AND of uniform words (no byte-per-bit intermediate)."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 1 << 32, size=n_ints, dtype=np.uint32)
    for _ in range(ands - 1):
        out &= rng.integers(0, 1 << 32, size=n_ints, dtype=np.uint32)
    return out


@pytest.mark.parametrize("c,d", FUSED_BLOCKS)
def test_encode_fused_around_its_tile_and_grid(cuda, c, d):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n_blocks = (sms * c + d) * TILE if c else d
    data = _ands(n_blocks * BLOCK_INTS - 300, 4, n_blocks)  # ends inside the last block
    padded, nv = _padded(data)
    assert len(padded) == n_blocks * BLOCK_INTS
    ints = words_to_tensor(padded, cuda)
    words, total = ek.encode_padded_fused(ints, nv)
    ek.check_fused_error()
    words_2, total_2 = ek.encode_padded(ints, nv, stitch="v3")
    t = int(total)
    assert t == int(total_2) and torch.equal(words[:t], words_2[:t])
    np.testing.assert_array_equal(tensor_to_words(words[:t]), golden.encode(data))
    nv_t = torch.tensor([nv, 0], dtype=torch.int32, device=cuda)
    _, counts = ek.encode_fused(ints.view(-1, BLOCK_INTS), nv_t)
    assert torch.equal(counts, ek.encode_fused_plain(ints.view(-1, BLOCK_INTS), nv_t)[1])


def test_encode_fused_blocks_past_the_bound_and_a_bound_inside_a_tile(cuda):
    nb = 2 * TILE + 1
    ints = words_to_tensor(_bitmap(nb * BLOCK_INTS, 1 / 16, 41), cuda)
    # every block past the bound: no word, every count 0
    base = 4 * TILE * BLOCK_CHUNKS
    words, total = ek.encode_padded_fused(ints, 5 * BLOCK_CHUNKS, base)
    nv_t = torch.tensor([5 * BLOCK_CHUNKS, base], dtype=torch.int32, device=cuda)
    _, counts = ek.encode_fused(ints.view(nb, BLOCK_INTS), nv_t)
    ek.check_fused_error()
    assert int(total) == 0 and not counts.any()
    # a chunk base, the bound inside the second tile and inside the last block
    base = 2 * BLOCK_CHUNKS
    for bound in (base + (TILE + 1) * BLOCK_CHUNKS + 100, base + 2 * TILE * BLOCK_CHUNKS + 5):
        words, total = ek.encode_padded_fused(ints, bound, base)
        ek.check_fused_error()
        words_p, total_p = ek.encode_padded_fused_plain(ints, bound, base)
        t = int(total)
        assert t == int(total_p) and torch.equal(words[:t], words_p[:t])


def test_encode_fused_ten_launches_in_a_row(cuda):
    """Ten launches on one stream, each with a fresh workspace, nothing read
    before the last."""
    sizes = (1, TILE + 1, 4097, 515, 3000, 2 * TILE + 1, 33, 1500, TILE, 1000)
    runs = []
    for i, n in enumerate(sizes):
        padded, nv = _padded(_ands(n * BLOCK_INTS - 37 * i, 2 + 3 * (i % 5), 50 + i))
        x = words_to_tensor(padded, cuda)
        runs.append((x, nv, ek.encode_padded_fused(x, nv)))
    ek.check_fused_error()
    for x, nv, (w, n) in runs:
        w_p, n_p = ek.encode_padded_fused_plain(x, nv)
        assert int(n) == int(n_p) and torch.equal(w[: int(n)], w_p[: int(n)])


# K1 and K4 walk several blocks a CTA (K4 a contiguous range, K1 a stride of
# its grid): block counts that no grid divides, the bitmap ending inside the
# last block
BLOCK_COUNTS = [1, 2, 263, 265]


def _ending_inside(n_blocks: int) -> np.ndarray:
    return _bitmap(n_blocks * BLOCK_INTS - 300, 1 / 16, n_blocks)


@pytest.mark.parametrize("n_blocks", BLOCK_COUNTS)
def test_kernels_at_block_counts_match_plain_and_golden(cuda, n_blocks):
    data = _ending_inside(n_blocks)
    padded, nv = _padded(data)
    assert len(padded) == n_blocks * BLOCK_INTS and nv % BLOCK_CHUNKS
    ints = words_to_tensor(padded, cuda)
    nv_t = torch.tensor([nv, 0], dtype=torch.int32, device=cuda)
    staging, counts = ek.encode_tiles(ints.view(n_blocks, -1), nv_t)
    staging_p, counts_p = ek.encode_tiles_plain(ints.view(n_blocks, -1), nv_t)
    assert torch.equal(staging, staging_p) and torch.equal(counts, counts_p)
    words, total = ek.encode_padded(ints, nv, stitch="v3")
    t = int(total)
    stream = golden.encode(data)
    np.testing.assert_array_equal(tensor_to_words(words[:t]), stream)
    # K5 on the same blocks: still the K1 + K2 pipeline's stream
    words_f, total_f = ek.encode_padded_fused(ints, nv)
    ek.check_fused_error()
    assert int(total_f) == t and torch.equal(words_f[:t], words[:t])
    M = -(-t // BLOCK_CHUNKS) * BLOCK_CHUNKS
    padded_words = torch.zeros(M, dtype=torch.int32, device=cuda)
    padded_words[:t] = words[:t]
    back, n_ints = dk.decode(padded_words, t, n_blocks * BLOCK_CHUNKS)
    back_p, n_ints_p = dk.decode_plain(padded_words, t, n_blocks * BLOCK_CHUNKS)
    assert int(n_ints) == int(n_ints_p) and torch.equal(back, back_p)
    np.testing.assert_array_equal(tensor_to_words(back)[: len(data)], data)


# (capacity in blocks, chunk base in blocks) over a 9-block stream: capacity
# past the stream's end, spans from a chunk base, a span wholly past the end
SPANS = {"past_the_end": (40, 0), "base_2": (7, 2), "base_2_past_the_end": (300, 2),
         "base_7_one_block": (1, 7), "wholly_past_the_end": (5, 12)}


@pytest.mark.parametrize("name", SPANS)
def test_decode_spans_match_plain_and_golden(cuda, name):
    cap_blocks, base_blocks = SPANS[name]
    data = _ending_inside(9)
    stream = golden.encode(data)
    m = len(stream)
    words = torch.zeros(-(-m // 1024) * 1024, dtype=torch.int32, device=cuda)
    words[:m] = words_to_tensor(stream, cuda)
    cap, base = cap_blocks * BLOCK_CHUNKS, base_blocks * BLOCK_CHUNKS
    before = dk.decode_blocks.launches
    ints, n_ints = dk.decode(words, m, cap, chunk_base=base)
    assert dk.decode_blocks.launches == before + 1
    ints_p, n_ints_p = dk.decode_plain(words, m, cap, chunk_base=base)
    assert int(n_ints) == int(n_ints_p) and torch.equal(ints, ints_p)
    want = np.zeros(cap_blocks * BLOCK_INTS, np.uint32)
    rest = golden.decode(stream)[base_blocks * BLOCK_INTS :][: len(want)]
    want[: len(rest)] = rest
    np.testing.assert_array_equal(tensor_to_words(ints), want)


@pytest.mark.parametrize("name", ["mask_bound_inside_a_block", "base_bound_inside_a_block",
                                  "mask_and_base"])
def test_encode_tiles_validity_matches_plain(cuda, name):
    """K1's validity ((chunk_base + position) & pos_mask) < bound with the
    bound inside a block: per-column wrap, a shard's base, and both."""
    nb = 96
    ints = words_to_tensor(_bitmap(nb * BLOCK_INTS, 1 / 16, 71), cuda).view(nb, -1)
    col = 32 * BLOCK_CHUNKS
    nv = {"mask_bound_inside_a_block": [col - 77, 0, col - 1],
          "base_bound_inside_a_block": [2 * BLOCK_CHUNKS + 90 * BLOCK_CHUNKS + 5, 2 * BLOCK_CHUNKS,
                                        0x7FFFFFFF],
          "mask_and_base": [col - 1500, col, col - 1]}[name]
    nv_t = torch.tensor(nv, dtype=torch.int32, device=cuda)
    staging, counts = ek.encode_tiles(ints, nv_t)
    staging_p, counts_p = ek.encode_tiles_plain(ints, nv_t)
    assert torch.equal(staging, staging_p) and torch.equal(counts, counts_p)
    assert int(counts.sum()) > 0 and int(counts[-1]) < BLOCK_CHUNKS


@pytest.mark.parametrize("order", ["as_built", "reversed"])
@pytest.mark.parametrize("nb", [8, 64])
def test_batch_capacity_column_beside_all_zero_one(cuda, nb, order):
    """A column that fills its capacity exactly (the tie of K4's granule
    probe and search) beside an all-zero one, in both orders, block-aligned."""
    cols = _batch_columns(nb * BLOCK_INTS)
    if order == "reversed":
        cols = cols[::-1].copy()
    C, cap = cols.shape[0], nb * BLOCK_CHUNKS
    rows = words_to_tensor(cols.reshape(-1), cuda).view(C * nb, BLOCK_INTS)
    words, totals = ek.encode_rows_batch(rows, C, golden.chunk_count(cols.shape[1]))
    words_p, totals_p = ek.encode_rows_batch_plain(rows, C, golden.chunk_count(cols.shape[1]))
    assert torch.equal(totals, totals_p)
    assert cap in totals.tolist() and nb in totals.tolist()
    for c in range(C):
        t = int(totals[c])
        assert torch.equal(words[c * cap : c * cap + t], words_p[c * cap : c * cap + t]), c
        np.testing.assert_array_equal(tensor_to_words(words[c * cap : c * cap + t]),
                                      golden.encode(cols[c]))
    ints = dk.decode_rows_batch(words, C, totals, cap)
    assert torch.equal(ints, dk.decode_rows_batch_plain(words, C, totals, cap))
    np.testing.assert_array_equal(tensor_to_words(ints).reshape(C, -1), cols)


def test_kernels_refuse_unaligned_tensors(cuda):
    """K1, K5 and K4 copy 16 B vectors: a view that starts off a 16 B
    boundary raises instead of launching."""
    flat = torch.zeros(4 * BLOCK_INTS + 1, dtype=torch.int32, device=cuda)
    nv = torch.tensor([4 * BLOCK_CHUNKS, 0], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16 B"):
        ek.encode_tiles(flat[1:].view(4, BLOCK_INTS), nv)
    with pytest.raises(ValueError, match="16 B"):
        ek.encode_fused(flat[1:].view(4, BLOCK_INTS), nv)
    words = torch.zeros(8 * 128 + 1, dtype=torch.int32, device=cuda)
    meta = torch.tensor([0, 0, 0, 0x7FFFFFFF], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16 B"):
        dk.decode_blocks(words[1:].view(8, 128), torch.zeros(8, dtype=torch.int32, device=cuda),
                         meta, 1)


SCANS = {
    # name: (rows, low, high, keys per row, search span)
    "t1_shape_seed17": (4, 0, 100, 64, (0, 2048)),
    "ties": (8, 0, 2, 100, (0, 2048)),  # half the steps add 0: long ties in the cumsum
    "all_zero": (2, 0, 1, 40, (0, 2048)),  # every key ties with every entry
    "odd_span": (8, 0, 100, 70, (5, 1902)),  # hi - lo = 1897, not a multiple of 32
    "span_of_one": (2, 0, 100, 33, (77, 78)),
    "negative_maxima": (4, -50, -10, 0, (0, 2048)),  # cummax below zero; no search
    "many_rows": (3000, 0, 100, 5, (0, 2048)),
    "one_row_one_key": (1, 0, 100, 1, (0, 2048)),
    "three_rows_no_key": (3, 0, 100, 0, (0, 2048)),
    "keys_in_rounds": (3, 0, 100, 300, (5, 1902)),  # more than the 256 keys a CTA holds at once
    "one_row_past_a_wave": (1057, 0, 100, 64, (100, 2000)),
}


@pytest.mark.parametrize("name", SCANS)
def test_rows_scan_matches_plain(cuda, name):
    rows, low, high, q, (lo, hi) = SCANS[name]
    rng = np.random.default_rng(17)
    x = rng.integers(low, high, size=(rows, 2048), dtype=np.int32)
    csum = np.cumsum(x, axis=1)
    # keys from a[lo] (the contract's floor) to past the row's last sum, and
    # the sums themselves, which tie exactly
    keys = rng.integers(csum[:, lo : lo + 1], csum[:, hi - 1 : hi] + 50, size=(rows, q))
    keys[:, ::3] = np.take_along_axis(csum[:, lo:hi], rng.integers(0, hi - lo, (rows, q)), 1)[:, ::3]
    xt = torch.from_numpy(x).to(cuda)
    kt = torch.from_numpy(keys.astype(np.int32)).to(cuda)
    before = scan_check.rows_scan.launches
    got = scan_check.rows_scan(xt, kt, lo, hi)
    assert scan_check.rows_scan.launches == before + 1
    want = scan_check.rows_scan_plain(xt, kt, lo, hi)
    for g, w, what in zip(got, want, ("cumsum", "cummax", "search")):
        assert torch.equal(g, w), what
    np.testing.assert_array_equal(got[0].cpu().numpy(), csum)
    np.testing.assert_array_equal(got[1].cpu().numpy(), np.maximum.accumulate(x, axis=1))


@pytest.mark.parametrize("name", ["mixed_sign_outside_the_span", "int_min_rows",
                                  "rows_that_start_at_int_min"])
def test_rows_scan_signs_match_plain(cuda, name):
    """Negative values: the sum wraps in int32 as the flat scan does, the
    running maximum starts from the row's first element, the search sees only
    its span."""
    rng = np.random.default_rng(29)
    lo, hi, q = 0, 2048, 0
    if name == "mixed_sign_outside_the_span":
        x = rng.integers(-1000, 1000, size=(37, 2048), dtype=np.int32)
        lo, hi, q = 700, 1500, 64
        x[:, lo:hi] = np.abs(x[:, lo:hi])
    else:
        x = np.full((5, 2048), np.iinfo(np.int32).min, np.int32)
        if name == "rows_that_start_at_int_min":
            x[:, 1:] = rng.integers(-5, 5, size=(5, 2047))
    csum = np.cumsum(x, axis=1, dtype=np.int32)
    keys = np.zeros((x.shape[0], 0), np.int32)
    if q:
        keys = rng.integers(csum[:, lo : lo + 1], csum[:, hi - 1 : hi].astype(np.int64) + 50,
                            size=(x.shape[0], q)).astype(np.int32)
    xt, kt = torch.from_numpy(x).to(cuda), torch.from_numpy(keys).to(cuda)
    got = scan_check.rows_scan(xt, kt, lo, hi)
    for g, w, what in zip(got, scan_check.rows_scan_plain(xt, kt, lo, hi),
                          ("cumsum", "cummax", "search")):
        assert torch.equal(g, w), what
    np.testing.assert_array_equal(got[0].cpu().numpy(), csum)
    np.testing.assert_array_equal(got[1].cpu().numpy(), np.maximum.accumulate(x, axis=1))


def test_segments_on_cuda_match_golden(cuda):
    codec = WahCodec(cuda)
    data = _bitmap(7 * BLOCK_INTS + 123, 1 / 64, 61)
    stream = codec.compress_segments(data, segment_ints=2 * BLOCK_INTS)
    np.testing.assert_array_equal(stream, golden.encode(data))
    np.testing.assert_array_equal(
        codec.decompress_segments(stream, len(data), segment_ints=2 * BLOCK_INTS), data)
    cols = _batch_columns(5 * BLOCK_INTS + 77)
    streams = codec.compress_batch_segments(cols, segment_ints=2 * BLOCK_INTS)
    for c, s in enumerate(streams):
        np.testing.assert_array_equal(s, golden.encode(cols[c]))
    np.testing.assert_array_equal(
        codec.decompress_batch_segments(streams, cols.shape[1], segment_ints=2 * BLOCK_INTS), cols)


def test_differential_quick_on_cuda(cuda):
    from wah_tpu_torch import differential

    before = ek.encode_fused.launches
    report = differential.run(cuda, quick=True)
    assert report["summary"]["failed"] == 0 and report["card"]
    assert ek.encode_fused.launches == before + 6


# -- the sharded codec (wah_tpu_torch.parallel) ------------------------------

@pytest.mark.parametrize("name", COMPACT_TOTALS)
def test_compact_payload_matches_plain(cuda, name):
    """stitch_global's compaction (K2 over the (D, eff) payload) == the same
    function on CPU tensors (the plain K2) == numpy, at totals 0, 1,023,
    1,024, eff and past it."""
    from wah_tpu_torch.parallel import compact_payload

    segs, totals, want = compact_case(name)
    flat = words_to_tensor(segs.reshape(-1), "cpu").view(segs.shape)
    before = stitch2.stitch_tiles_v2.launches
    got = compact_payload(flat.to(cuda), torch.from_numpy(totals).to(cuda))
    assert stitch2.stitch_tiles_v2.launches == before + 1
    plain = compact_payload(flat, torch.from_numpy(totals))
    assert torch.equal(got.cpu(), plain)
    np.testing.assert_array_equal(tensor_to_words(got), want)


@pytest.mark.parametrize("chunks_l,rank", [(3 * BLOCK_CHUNKS, 0), (3 * BLOCK_CHUNKS, 2),
                                           (2 * BLOCK_CHUNKS, 4), (992, 3)])
def test_decode_local_from_a_chunk_base_matches_plain(cuda, chunks_l, rank):
    """decode_local on the card runs K3 + K4 over the blocks that cover the
    span, whether or not the span is block-aligned (992 chunks from chunk
    2976 is not), and == the same call on CPU tensors (the plain K3 + K4)
    == numpy."""
    from wah_tpu_torch.parallel import decode_local

    data = _bitmap(9 * BLOCK_INTS + 77, 1 / 64, 81)
    ref = golden.encode(data)
    stream = np.concatenate([ref, np.zeros(-len(ref) % BLOCK_CHUNKS, np.uint32)])
    before = (dk.prescan_words.launches, dk.decode_blocks.launches)
    got, n = decode_local(words_to_tensor(stream, cuda), len(ref), chunks_l, rank)
    assert (dk.prescan_words.launches, dk.decode_blocks.launches) == (before[0] + 1, before[1] + 1)
    want, n_p = decode_local(words_to_tensor(stream, "cpu"), len(ref), chunks_l, rank)
    assert int(n) == int(n_p) == golden.chunk_count(len(data))
    assert torch.equal(got.cpu(), want)
    lo = rank * chunks_l // 32 * 31
    full = np.concatenate([data, np.zeros(chunks_l * 8, np.uint32)])
    np.testing.assert_array_equal(tensor_to_words(got), full[lo : lo + chunks_l // 32 * 31])


@pytest.mark.parametrize("nb_l", [1, 12, 33])
def test_eight_rank_bodies_on_cuda_match_golden(cuda, nb_l):
    from wah_tpu_torch.parallel import decode_local, encode_local

    D = 8
    data = _bitmap(D * nb_l * BLOCK_INTS, 0.02, 82)
    data[2 * BLOCK_INTS : 3 * BLOCK_INTS] = 0
    data[-BLOCK_INTS:] = 0xFFFFFFFF
    nv = golden.chunk_count(len(data))
    ints = words_to_tensor(data, cuda)
    L = nb_l * BLOCK_INTS
    parts = []
    for r in range(D):
        w, t = encode_local(ints[r * L : (r + 1) * L], nv, r)
        parts.append(tensor_to_words(w[: int(t)]))
    ref = golden.encode(data)
    np.testing.assert_array_equal(np.concatenate(parts), ref)
    stream = words_to_tensor(np.concatenate([ref, np.zeros(-len(ref) % BLOCK_CHUNKS, np.uint32)]), cuda)
    spans = [decode_local(stream, len(ref), nb_l * BLOCK_CHUNKS, r)[0] for r in range(D)]
    np.testing.assert_array_equal(tensor_to_words(torch.cat(spans)), data)


@pytest.mark.parametrize("name", BITMAPS)
def test_sharded_codec_world_of_one_on_cuda(cuda, name):
    from wah_tpu_torch.parallel import ShardedCodec

    data = BITMAPS[name]()
    codec = ShardedCodec(cuda)
    before = dk.decode_blocks.launches
    stream = codec.compress(data)
    np.testing.assert_array_equal(stream, golden.encode(data))
    np.testing.assert_array_equal(codec.decompress(stream, out_ints=len(data)), data)
    assert dk.decode_blocks.launches == before + 1


# -- V1: the stream checked and counted on the card -------------------------

@pytest.mark.parametrize("name", CHECK_CASES)
def test_check_stream_matches_plain(cuda, name):
    """V1 against its plain twin on a buffer of whole blocks, as decompress
    sends it, with zero (bad) words past m."""
    words = CHECK_CASES[name][0]()
    m = len(words)
    buf = words_to_tensor(words, cuda, size=-(-(m + 1) // BLOCK_CHUNKS) * BLOCK_CHUNKS)
    before = sc.check_stream.launches
    got = sc.check_stream(buf, m)
    assert sc.check_stream.launches == before + 1 and got.device == buf.device
    assert got.tolist() == sc.check_stream_plain(buf.cpu(), m).tolist()


def test_check_stream_on_a_protocol_stream_with_bad_words_in_its_tail(cuda):
    """V1 on a 2^-4 protocol stream of 8,192 blocks (~8.4 M words: the
    persistent grid's unrolled walk and the walk after it both run),
    lengthened by literals to m % 4 == 3 so that three words lie past the
    last 16 B vector; bad words there, in the body before them, and both."""
    nb = 8192
    gen = torch.Generator(device=cuda).manual_seed(2024)
    x = torch.randint(-2**31, 2**31, (nb * BLOCK_INTS,), generator=gen, dtype=torch.int32,
                      device=cuda)
    for _ in range(3):
        x &= torch.randint(-2**31, 2**31, x.shape, generator=gen, dtype=torch.int32, device=cuda)
    words, total = ek.encode_padded(x, nb * BLOCK_CHUNKS, stitch="v3")
    head = tensor_to_words(words[: int(total)])
    stream = np.concatenate([head, np.full((3 - len(head)) % 4, 0x5, np.uint32)])
    m = len(stream)
    assert m % 4 == 3 and m > 8_000_000
    cases = {
        "valid": {},
        "last": {m - 1: 0},
        "tail_first_and_last": {m - 3: golden.BIT31, m - 1: golden.ONES31},
        "body_then_tail": {m - 7: golden.BIT31 | 1025, m - 2: 0},
        "first_vector_and_tail": {1: golden.ONES31, m - 1: 0},
        "far_apart": {m // 3: 0, 2 * m // 3: golden.BIT31},
    }
    for label, at in cases.items():
        s = stream.copy()
        for i, w in at.items():
            s[i] = w
        buf = words_to_tensor(s, cuda, size=-(-m // BLOCK_CHUNKS) * BLOCK_CHUNKS)
        got = sc.check_stream(buf, m).tolist()
        assert got == sc.check_stream_plain(buf.cpu(), m).tolist(), label
        assert got[0] == min(at, default=m), label
    with pytest.raises(ValueError, match="16 B"):
        sc.check_stream(buf[1:], m - 1)


@pytest.mark.parametrize("name", CHECK_CASES)
def test_codec_on_cuda_checks_the_stream_on_the_card(cuda, name, monkeypatch):
    """WahCodec("cuda").decompress launches V1 once a call and reads the
    stream on the host only to copy it: with the host codec's check and
    count refusing to run, it raises checked_stream's message for a
    malformed stream and decodes a valid one as the CPU codec does."""
    from wah_tpu_torch import api, native

    gen, first_bad = CHECK_CASES[name]
    words = gen()
    if first_bad is None:
        want = WahCodec("cpu").decompress(words)[0]
    else:
        with pytest.raises(ValueError) as err:
            api.checked_stream(words)
        want = str(err.value)
        assert not native.available() or want == api._violation(int(words[first_bad]))

    def reached(*_):
        raise AssertionError("a host pass over the stream")

    for mod, fn in ((native, "validate"), (native, "decoded_chunks"), (api, "checked_stream"),
                    (api, "stream_chunks"), (api, "validate_stream")):
        monkeypatch.setattr(mod, fn, reached)
    codec = WahCodec(cuda)
    before = sc.check_stream.launches, dk.decode_blocks.launches
    if first_bad is None:
        np.testing.assert_array_equal(codec.decompress(words)[0], want)
        assert (sc.check_stream.launches, dk.decode_blocks.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    else:
        with pytest.raises(ValueError) as err:
            codec.decompress(words)
        assert str(err.value) == want
        # raised before any decode was launched
        assert (sc.check_stream.launches, dk.decode_blocks.launches) == (before[0] + 1, before[1])


# -- utils.profiling on the card, and the entry points' default device -----

def _event_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(iters):
        fn()
    ev1.record()
    ev1.synchronize()
    return ev0.elapsed_time(ev1) / iters


# -- convert's pinned staging ring -----------------------------------------

_C, _H = convert.CHUNK_WORDS, convert.H2D_CHUNK_WORDS
_T, _D = convert.STAGE_MIN_WORDS, convert.RING_BUFFERS
# empty, one word, the threshold and a chunk of each direction either side,
# past a ring's worth of chunks from the device
STAGE_LENGTHS = [0, 1, _T - 1, _T, _T + 1, _H - 1, _H, _H + 1, _C - 1, _C, _C + 1,
                 (_D + 1) * _C + 12345]


def _random_words(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 1 << 32, size=n, dtype=np.uint32)


@pytest.mark.parametrize("sized", [False, True])
@pytest.mark.parametrize("n", STAGE_LENGTHS)
def test_staged_copies_are_bit_exact_at_the_edges(cuda, n, sized):
    words = _random_words(n, seed=n)
    size = n + 2 * BLOCK_CHUNKS + 5 if sized else None
    if sized:  # hand the copy a block that held other words
        junk = torch.full((size,), -1, dtype=torch.int32, device=cuda)
        del junk
    before = dict(convert.copies)
    t = words_to_tensor(words, cuda, size=size)
    assert t.device.type == "cuda" and t.shape == ((n if size is None else size),)
    if sized:
        assert not bool(t[n:].any())
    back = tensor_to_words(t[:n])
    np.testing.assert_array_equal(back, words)
    route = "staged" if n >= _T else "direct"
    assert convert.copies[route] - before[route] == 2
    assert convert.copies["chunks"] - before["chunks"] == (
        convert.staged_chunks(n, cuda, to_device=True) + convert.staged_chunks(n, cuda, to_device=False))


def test_staged_results_keep_their_words_and_never_alias_the_ring(cuda):
    a, b = _random_words(_C + 7, seed=1), _random_words(_C + 7, seed=2)
    got_a = tensor_to_words(words_to_tensor(a, cuda))
    got_b = tensor_to_words(words_to_tensor(b, cuda))
    rows = words_to_tensor(a[: 3 * _T], cuda).view(3, _T)
    got_rows = tensor_to_words(rows[:, 1:])  # a non-contiguous view
    np.testing.assert_array_equal(got_a, a)
    np.testing.assert_array_equal(got_b, b)
    np.testing.assert_array_equal(got_rows, a[: 3 * _T].reshape(3, _T)[:, 1:])
    for buf in convert._ring(cuda).bufs:
        for got in (got_a, got_b, got_rows):
            assert not np.shares_memory(got, buf.numpy())


def test_the_ring_is_made_once(cuda):
    words = _random_words(_C + 1, seed=3)
    words_to_tensor(words, cuda)
    ring, rings = convert._ring(cuda), len(convert._rings)
    ptrs = [buf.data_ptr() for buf in ring.bufs]
    np.testing.assert_array_equal(tensor_to_words(words_to_tensor(words[::-1].copy(), cuda)),
                                  words[::-1])
    assert convert._ring(cuda) is ring and len(convert._rings) == rings
    assert [buf.data_ptr() for buf in ring.bufs] == ptrs
    assert len(ring.bufs) == _D and all(buf.is_pinned() and buf.numel() == _C for buf in ring.bufs)


def _quarter_density(n: int, seed: int) -> np.ndarray:
    """P(bit) = 2^-4, the api cell's density: the AND of four random words."""
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(4, n), dtype=np.uint32)
    return w[0] & w[1] & w[2] & w[3]


@pytest.mark.parametrize("blocks,route", [(3, "direct"), (_C // BLOCK_INTS + 5, "staged")])
def test_the_codec_copies_by_route(cuda, blocks, route):
    from wah_tpu_torch.utils import profiling

    data = _quarter_density(blocks * BLOCK_INTS - 17, seed=blocks)
    codec = WahCodec(cuda)
    before = dict(convert.copies)
    profiling.clear()
    with profiling.trace():
        stream, _ = codec.compress(data)
        out, _ = codec.decompress(stream, out_ints=len(data))
    np.testing.assert_array_equal(stream, golden.encode(data))
    np.testing.assert_array_equal(out, data)
    assert convert.copies[route] - before[route] == 4
    got = {r.name: r.counts["staged_chunks"] for r in profiling.spans() if "staged_chunks" in r.counts}
    want = {"wah.compress.to_device": len(data), "wah.compress.from_device": len(stream),
            "wah.decompress.to_device": len(stream),
            "wah.decompress.from_device": -(-len(data) // 31) * 31}  # whole groups of 31
    assert got == {k: convert.staged_chunks(v, cuda, to_device=k.endswith("to_device"))
                   for k, v in want.items()}
    assert (sum(got.values()) > 0) == (route == "staged")
    assert convert.copies["chunks"] - before["chunks"] == sum(got.values())


@pytest.mark.parametrize("n,wider", [(3, True), (_T // 5 + 1, False), (_T // 5 + 1, True)])
def test_rows_cross_as_they_are_and_widen_on_the_card(cuda, n, wider):
    """(5, n) -> (5, W): the 5n words in one copy, directly or through the
    ring, each row exact and zero past n; rows of whole blocks start 16 B
    aligned, as V1 and K3 load them."""
    rows = _random_words(5 * n, seed=n).reshape(5, n)
    W = (n // BLOCK_CHUNKS + 1) * BLOCK_CHUNKS if wider else n
    before = dict(convert.copies)
    t = words_to_tensor(rows, cuda, size=W if wider else None)
    route = "staged" if 5 * n >= _T else "direct"
    assert convert.copies[route] - before[route] == 1
    assert t.device.type == "cuda" and t.shape == (5, W)
    got = tensor_to_words(t)
    np.testing.assert_array_equal(got[:, :n], rows)
    assert not got[:, n:].any()
    if wider:
        assert all(t[c].data_ptr() % 16 == 0 for c in range(5))


@pytest.mark.parametrize("name", HOST_PATHS)
def test_host_entry_points_on_cuda_make_no_host_pass(cuda, name, monkeypatch):
    """The entry points on the card with every host check, count and
    padded host array refused: the same results as on the CPU."""
    from wah_tpu_torch.parallel import dist

    call, want = _host_path(name, cuda)
    _refuse_host_passes(monkeypatch, (np, "zeros"), (np, "full"), (dist, "checked_stream"))
    got = call()
    monkeypatch.undo()
    for g, w in zip(got, want) if isinstance(want, list) else [(got, want)]:
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fault", BATCH_FAULTS)
def test_decompress_batch_on_cuda_checks_each_column_on_the_card(cuda, fault):
    """One V1 launch a column, no decode before a bad column raises, and the
    CPU codec's message (wah_tpu's, tests/test_torch_stream_check.py)."""
    words, totals = _batch(fault)
    codec = WahCodec(cuda)
    before = sc.check_stream.launches, dk.decode_blocks.launches
    if fault == "past_a_total_only":
        np.testing.assert_array_equal(codec.decompress_batch(words, totals, N_HOST),
                                      WahCodec("cpu").decompress_batch(words, totals, N_HOST))
        assert sc.check_stream.launches == before[0] + len(totals)
        return
    want = _message(WahCodec("cpu").decompress_batch, words, totals)
    assert _message(codec.decompress_batch, words, totals) == want
    assert (sc.check_stream.launches, dk.decode_blocks.launches) == (before[0] + len(totals),
                                                                     before[1])


@pytest.mark.parametrize("fault", STREAM_FAULTS)
def test_sharded_decompress_on_cuda_checks_on_the_card(cuda, fault):
    from wah_tpu_torch.parallel import ShardedCodec

    words = _stream_with(fault)
    before = sc.check_stream.launches, dk.decode_blocks.launches
    assert _message(ShardedCodec(cuda).decompress, words) == \
        _message(ShardedCodec("cpu").decompress, words)
    assert (sc.check_stream.launches, dk.decode_blocks.launches) == (before[0] + 1, before[1])


def test_two_threads_round_trip_through_one_codec(cuda):
    import sys
    import threading

    codec = WahCodec(cuda)
    bitmaps = [_quarter_density(_C + 999, seed=s) for s in (5, 6)]
    want = [codec.compress(b)[0] for b in bitmaps]
    got, errors = [[], []], []

    def trips(k: int) -> None:
        try:
            for _ in range(3):
                stream, _ = codec.compress(bitmaps[k])
                out, _ = codec.decompress(stream, out_ints=len(bitmaps[k]))
                got[k].append((stream, out))
        except Exception as e:  # read below, in the test's thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=trips, args=(k,)) for k in (0, 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors
    for k in (0, 1):
        assert len(got[k]) == 3
        for stream, out in got[k]:
            np.testing.assert_array_equal(stream, want[k])
            np.testing.assert_array_equal(out, bitmaps[k])


def test_amortized_seconds_of_k1_is_its_event_time(cuda):
    """K1 at the 130 MB protocol's shape (32,768 blocks, P(bit) = 2^-4 made
    on the card) is one device-bound launch: the graph-replayed marginal
    time and the CUDA-event time of back-to-back launches agree within 10%."""
    from wah_tpu_torch.utils import profiling

    nb = 32768
    gen = torch.Generator(device=cuda).manual_seed(1337)
    x = torch.randint(-2**31, 2**31, (nb, BLOCK_INTS), generator=gen, dtype=torch.int32, device=cuda)
    for _ in range(3):
        x &= torch.randint(-2**31, 2**31, x.shape, generator=gen, dtype=torch.int32, device=cuda)
    nv = torch.tensor([nb * BLOCK_CHUNKS, 0, 0x7FFFFFFF], dtype=torch.int32, device=cuda)
    eager = min(_event_ms(lambda: ek.encode_tiles(x, nv)) for _ in range(2))
    cache = {}
    replayed = profiling.amortized_seconds(ek.encode_tiles, x, nv, cache=cache, cache_key="k1") * 1e3
    assert replayed == pytest.approx(eager, rel=0.10)
    staging, counts = ek.encode_tiles(x, nv)
    assert torch.equal(cache["k1"].out[0], staging) and torch.equal(cache["k1"].out[1], counts)


@pytest.mark.parametrize("blocks", [1, 263, 4096])
def test_captured_pipelines_replay_to_the_eager_output(cuda, blocks):
    """The encode pipeline (K1, cumsum, K2) and the decode pipeline (K3,
    cumsum, K4) captured in CUDA graphs: each replay equals the eager call,
    also after the captured input is overwritten with another bitmap."""
    from wah_tpu_torch.utils import profiling

    n = blocks * BLOCK_INTS - 5
    a, b = _bitmap(n, 1 / 16, blocks), _bitmap(n, 1 / 64, blocks + 1)
    nv = golden.chunk_count(n)
    cap = -(-nv // BLOCK_CHUNKS) * BLOCK_CHUNKS
    ints = torch.zeros(blocks * BLOCK_INTS, dtype=torch.int32, device=cuda)
    enc = profiling.capture(lambda t: ek.encode_padded(t, nv, stitch="v3"), ints)
    for data in (a, b):
        ints[:n] = words_to_tensor(data, cuda)
        enc.graph.replay()
        words, total = ek.encode_padded(ints, nv, stitch="v3")
        m = int(total)
        assert int(enc.out[1]) == m
        assert torch.equal(enc.out[0][:m], words[:m])
        ref = golden.encode(data)
        np.testing.assert_array_equal(tensor_to_words(words[:m]), ref)

        stream = torch.zeros(-(-m // BLOCK_CHUNKS) * BLOCK_CHUNKS, dtype=torch.int32, device=cuda)
        stream[:m] = words[:m]
        dec = profiling.capture(lambda w: dk.decode(w, m, cap), stream)
        stream.zero_()
        stream[:m] = words[:m]  # the same words, written again after the capture
        dec.graph.replay()
        out, n_ints = dk.decode(stream, m, cap)
        assert torch.equal(dec.out[0], out) and int(dec.out[1]) == int(n_ints)
        np.testing.assert_array_equal(tensor_to_words(out[:n]), data)


def test_entry_points_default_to_the_card(cuda):
    import wah_tpu_torch

    codec = WahCodec()
    assert codec.device == torch.device("cuda")
    data = BITMAPS["sparse"]()
    before = ek.encode_tiles.launches, dk.decode_blocks.launches
    stream, _ = wah_tpu_torch.compress(data)
    np.testing.assert_array_equal(stream, golden.encode(data))
    out, _ = wah_tpu_torch.decompress(stream)  # no out_ints: the whole expansion
    np.testing.assert_array_equal(out, golden.decode(stream))
    assert (ek.encode_tiles.launches, dk.decode_blocks.launches) == (before[0] + 1, before[1] + 1)
    values = np.random.default_rng(3).integers(0, 8, 5000)
    idx = BitmapIndex.build(values)
    assert idx.codec.device.type == "cuda"
    np.testing.assert_array_equal(idx.rows(idx.query_eq(3)), np.flatnonzero(values == 3))


def test_sharded_codec_takes_the_ranks_card_in_a_one_rank_group(cuda, tmp_path):
    import torch.distributed as tdist

    from wah_tpu_torch.parallel import ShardedCodec, multihost

    tdist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                             rank=0, timeout=multihost.TIMEOUT)
    try:
        codec = ShardedCodec(group=tdist.group.WORLD)
        assert codec.device == torch.device("cuda", 0) == multihost.local_device("cuda")
        data = BITMAPS["odd_size"]()
        stream = codec.compress(data)
        np.testing.assert_array_equal(stream, golden.encode(data))
        np.testing.assert_array_equal(codec.decompress(stream, out_ints=len(data)), data)
    finally:
        tdist.destroy_process_group()


def test_a_step_with_a_host_read_cannot_be_captured(cuda):
    """Last in this file: a capture that fails ends on the card."""
    from wah_tpu_torch.utils import profiling

    x = torch.ones(4096, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        profiling.amortized_seconds(lambda t: int(t.sum()), x)
    assert int(x.sum()) == 4096  # the card still runs, on the caller's stream
