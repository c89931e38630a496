"""Plain versions of the port's kernels K1-K4 and K6 against the Pallas kernels.

The same numpy inputs (the case matrix of test_pallas.py, the long-fill
and granule-window-extreme streams) go through wah_tpu's Pallas kernels,
run as test_pallas.py runs them (jit, interpret mode on the CPU), and
through wah_tpu_torch.ops.cuda's plain versions and CPU wrappers:

  K1 encode_kernel.encode_tiles  <-> encode_tiles_plain   staging, counts in full
  K2 stitch2.stitch_tiles_v2     <-> stitch_tiles_plain   prefix up to the total
  K3 decode_kernel.prescan_words <-> prescan_words_plain  both outputs in full
  K4 decode_kernel.decode        <-> decode_plain         ints[:n_ints], n_ints
  K6 encode_kernel.stitch_tiles  <-> stitch_tiles_plain   prefix, and the zeroed last tile

Tolerance is zero: an integer codec must agree bit for bit. Every case is
padded to one shape per kernel so that each Pallas kernel compiles once.
"""
import jax
import numpy as np
import pytest
import torch

from test_pallas import CASES
from wah_tpu import golden
from wah_tpu.constants import BLOCK_CHUNKS, BLOCK_INTS
from wah_tpu.ops.pallas import decode_kernel as jdk
from wah_tpu.ops.pallas import encode_kernel as jek
from wah_tpu.ops.pallas import stitch2 as jst
from wah_tpu_torch.convert import tensor_to_words, words_to_tensor
from wah_tpu_torch.ops.cuda import decode_kernel as dk
from wah_tpu_torch.ops.cuda import encode_kernel as ek
from wah_tpu_torch.ops.cuda import stitch2

IDS = [c[0] for c in CASES]
NB = 16  # blocks of every encode case (a multiple of the CPU TILE_BLOCKS, 8)
M = NB * BLOCK_CHUNKS  # stream words of every decode case
PRESCAN_ROWS = M // 128 + 8  # rows past the input come out zero


def _t(x) -> torch.Tensor:
    return words_to_tensor(np.asarray(x, dtype=np.uint32), "cpu")


def _n(t: torch.Tensor) -> np.ndarray:
    return tensor_to_words(t)


def _blocks(data: np.ndarray):
    """data zero-padded to NB blocks, and its valid chunk count."""
    padded = np.zeros(NB * BLOCK_INTS, dtype=np.uint32)
    padded[: len(data)] = data
    return padded.reshape(NB, BLOCK_INTS), golden.chunk_count(len(data))


def _stream(words: np.ndarray) -> np.ndarray:
    padded = np.zeros(max(M, -(-len(words) // 1024) * 1024), dtype=np.uint32)
    padded[: len(words)] = words
    return padded


@pytest.mark.parametrize("mask", [False, True], ids=["nv2", "nv3"])
@pytest.mark.parametrize("name,gen", CASES, ids=IDS)
def test_encode_tiles_plain_matches_pallas(name, gen, mask):
    ints2d, nv = _blocks(gen())
    nv_arr = np.array([nv, 0, 0x7FFFFFFF] if mask else [nv, 0], np.int32)
    jstaging, jcounts = jax.jit(jek.encode_tiles)(ints2d, nv_arr)
    staging, counts = ek.encode_tiles_plain(_t(ints2d.reshape(-1)).view(NB, -1), torch.from_numpy(nv_arr))
    np.testing.assert_array_equal(_n(staging), np.asarray(jstaging))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    # the wrapper takes the plain version for a CPU tensor, and launches nothing
    before = ek.encode_tiles.launches
    w_staging, w_counts = ek.encode_tiles(_t(ints2d.reshape(-1)).view(NB, -1), torch.from_numpy(nv_arr))
    assert torch.equal(w_staging, staging) and torch.equal(w_counts, counts)
    assert ek.encode_tiles.launches == before


@pytest.mark.parametrize("explicit_counts", [False, True], ids=["offsets", "counts"])
@pytest.mark.parametrize("name,gen", CASES, ids=IDS)
def test_stitch_plain_matches_pallas(name, gen, explicit_counts):
    ints2d, nv = _blocks(gen())
    jstaging, jcounts = jax.jit(jek.encode_tiles)(ints2d, np.array([nv, 0], np.int32))
    counts = np.asarray(jcounts)[:, 0]
    offsets_ext = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    total = int(offsets_ext[-1])
    jc = counts if explicit_counts else None
    jwords = np.asarray(jax.jit(jst.stitch_tiles_v2)(jstaging, offsets_ext, counts=jc))
    tc = torch.from_numpy(counts.copy()) if explicit_counts else None
    staging = _t(np.asarray(jstaging).reshape(-1)).view(NB, -1)
    for fn in (stitch2.stitch_tiles_plain, stitch2.stitch_tiles_v2):
        words = fn(staging, torch.from_numpy(offsets_ext), tc)
        assert words.shape == (NB * BLOCK_CHUNKS,)
        np.testing.assert_array_equal(_n(words)[:total], jwords[:total])
    np.testing.assert_array_equal(jwords[:total], golden.encode(gen()))


@pytest.mark.parametrize("name,gen", CASES, ids=IDS)
def test_stitch_tiles_plain_matches_pallas(name, gen):
    """K6's contract: the stream up to the total, zeros from there to the
    end of the last tile that holds words."""
    ints2d, nv = _blocks(gen())
    jstaging, jcounts = jax.jit(jek.encode_tiles)(ints2d, np.array([nv, 0], np.int32))
    counts = np.asarray(jcounts)[:, 0]
    offsets_ext = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    total = int(offsets_ext[-1])
    end = -(-total // BLOCK_CHUNKS) * BLOCK_CHUNKS
    jwords = np.asarray(jax.jit(jek.stitch_tiles)(jstaging, offsets_ext))
    assert not jwords[total:end].any()
    staging = _t(np.asarray(jstaging).reshape(-1)).view(NB, -1)
    before = ek.stitch_tiles.launches
    for fn in (stitch2.stitch_tiles_plain, ek.stitch_tiles):
        words = fn(staging, torch.from_numpy(offsets_ext))
        assert words.shape == (NB * BLOCK_CHUNKS,)
        np.testing.assert_array_equal(_n(words)[:end], jwords[:end])
    assert ek.stitch_tiles.launches == before  # the CPU takes the plain version
    np.testing.assert_array_equal(jwords[:total], golden.encode(gen()))


@pytest.mark.parametrize("name", ["random_sparse", "random_dense", "all_zeros"])
def test_encode_padded_auto_stitch_matches_pallas(name):
    """encode_padded with either stitch, K2 ("v3", the default) and K6
    ("v1"), against wah_tpu's default "auto" stitch, which chooses between
    them on the total (lax.cond). The port has no such choice: "auto" is
    refused like any other unknown stitch."""
    ints2d, nv = _blocks(dict(CASES)[name]())
    jwords, jtotal = jax.jit(jek.encode_padded)(ints2d.reshape(-1), np.int32(nv))
    total = int(jtotal)
    for stitch in ("v1", "v3"):
        words, t = ek.encode_padded(_t(ints2d.reshape(-1)), nv, stitch=stitch)
        assert int(t) == total
        np.testing.assert_array_equal(_n(words)[:total], np.asarray(jwords)[:total])
    for stitch in ("v2", "auto"):
        with pytest.raises(ValueError, match="stitch"):
            ek.encode_padded(_t(ints2d.reshape(-1)), nv, stitch=stitch)


def _prescan_inputs(data):
    stream = golden.encode(data)
    m = len(stream)
    vc = np.clip(m - 128 * np.arange(PRESCAN_ROWS), 0, 128).astype(np.int32)
    return _stream(stream), m, vc


@pytest.mark.parametrize("name,gen", CASES, ids=IDS)
def test_prescan_plain_matches_pallas(name, gen):
    words, m, vc = _prescan_inputs(gen())
    jwords_t, jg_sums = jax.jit(jdk.prescan_words, static_argnums=(2,))(words, vc, PRESCAN_ROWS)
    jwords_t, jg_sums = np.asarray(jwords_t), np.asarray(jg_sums)
    for fn in (dk.prescan_words_plain, dk.prescan_words):
        words_t, g_sums = fn(_t(words), torch.from_numpy(vc), PRESCAN_ROWS)
        assert words_t.shape == (PRESCAN_ROWS, 128) and g_sums.shape == (PRESCAN_ROWS,)
        np.testing.assert_array_equal(_n(words_t), jwords_t[:PRESCAN_ROWS])
        np.testing.assert_array_equal(g_sums.numpy(), jg_sums[:PRESCAN_ROWS])
    # the Pallas kernel rounds its rows up to its tile; the extra rows are zero
    assert not jwords_t[PRESCAN_ROWS:].any() and not jg_sums[PRESCAN_ROWS:].any()


def _long_fill():
    data = np.zeros(64 * BLOCK_INTS, dtype=np.uint32)
    return golden.encode(data), 64 * BLOCK_CHUNKS


def _granule_extremes():
    """test_pallas.test_pallas_decode_granule_window_extremes' stream: block
    1's covering word sits at phase 127 of its granule and the block
    consumes 1024 distinct words."""
    rng = np.random.default_rng(77)
    lits = rng.integers(1, golden.ONES31 - 1, size=1278, dtype=np.uint32)
    stream = np.concatenate(
        [lits[:127], np.array([golden.BIT31 | 770], dtype=np.uint32), lits[127:]]
    ).astype(np.uint32)
    return stream, 2 * BLOCK_CHUNKS


def _protocol_like(n_ints: int, seed: int) -> np.ndarray:
    """P(bit) = 2^-4, as the bench protocol: mostly literals, short fills."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 1 << 32, size=n_ints, dtype=np.uint32)
    for _ in range(3):
        out &= rng.integers(0, 1 << 32, size=n_ints, dtype=np.uint32)
    return out


# block counts that divide into no grid of CTAs walking several blocks each,
# the bitmap ending inside the last block: what the CUDA kernels are held to
# on the card (tests/test_torch_cuda.py), held here to the Pallas kernels
BLOCK_COUNTS = [1, 2, 263, 265]


def _ending_inside(n_blocks: int) -> np.ndarray:
    return _protocol_like(n_blocks * BLOCK_INTS - 300, seed=n_blocks)


STREAMS = [(name, (lambda g=gen: (golden.encode(g()), NB * BLOCK_CHUNKS))) for name, gen in CASES]
STREAMS += [("long_fills", _long_fill), ("granule_extremes", _granule_extremes)]
STREAMS += [(f"blocks_{n}", (lambda n=n: (golden.encode(_ending_inside(n)), n * BLOCK_CHUNKS)))
            for n in BLOCK_COUNTS]
# capacity past the stream's end: the blocks past it decode to zeros
STREAMS += [("capacity_past_the_stream",
             lambda: (golden.encode(_ending_inside(5)), (5 + 11) * BLOCK_CHUNKS))]


@pytest.mark.parametrize("name,make", STREAMS, ids=[s[0] for s in STREAMS])
def test_decode_plain_matches_pallas(name, make):
    stream, cap = make()
    words = _stream(stream)
    m = len(stream)
    jints, jn_ints = jax.jit(jdk.decode, static_argnums=(2,))(words, np.int32(m), cap)
    jn = int(jn_ints)
    for fn in (dk.decode_plain, dk.decode):
        ints, n_ints = fn(_t(words), m, cap)
        assert int(n_ints) == jn
        assert ints.shape == (cap // BLOCK_CHUNKS * BLOCK_INTS,)
        np.testing.assert_array_equal(_n(ints)[:jn], np.asarray(jints)[:jn])
    np.testing.assert_array_equal(_n(ints)[:jn], golden.decode(stream))
    assert not _n(ints)[jn:].any()  # chunks past the stream decode to zero


@pytest.mark.parametrize("mask", [False, True], ids=["nv2", "nv3"])
@pytest.mark.parametrize("n_blocks", BLOCK_COUNTS)
def test_encode_tiles_plain_block_counts_match_pallas(n_blocks, mask):
    """K1's plain version at BLOCK_COUNTS, the bound ending inside the last
    block; with `mask` the blocks are columns of 2^k blocks and validity
    wraps per column (the batch's use of K1), the bound inside a column."""
    data = _ending_inside(n_blocks)
    nb8 = -(-n_blocks // 8) * 8  # the Pallas kernel takes whole tiles of 8 blocks
    ints2d = np.zeros((nb8, BLOCK_INTS), np.uint32)
    ints2d.reshape(-1)[: len(data)] = data
    bound = golden.chunk_count(len(data))
    if mask:
        col_blocks = 1 << max(n_blocks.bit_length() - 2, 0)
        col = col_blocks * BLOCK_CHUNKS
        nv_arr = np.array([col - 300, 0, col - 1], np.int32)
    else:
        nv_arr = np.array([bound, 0], np.int32)
    jstaging, jcounts = jax.jit(jek.encode_tiles)(ints2d, nv_arr)
    jstaging, jcounts = np.asarray(jstaging)[:n_blocks], np.asarray(jcounts)[:n_blocks]
    tints = _t(ints2d.reshape(-1)).view(nb8, -1)[:n_blocks]
    for fn in (ek.encode_tiles_plain, ek.encode_tiles):
        staging, counts = fn(tints, torch.from_numpy(nv_arr))
        np.testing.assert_array_equal(_n(staging), jstaging)
        np.testing.assert_array_equal(counts.numpy(), jcounts)
    if not mask:
        stream = np.concatenate([jstaging[b, : jcounts[b, 0]] for b in range(n_blocks)])
        np.testing.assert_array_equal(stream, golden.encode(data))


@pytest.mark.parametrize("base_blocks", [2, 7])
def test_decode_span_block_counts_match_pallas(base_blocks):
    """A decoded span from chunk_base = base_blocks * 1024 that runs past the
    stream's end: decode_plain against the Pallas kernel and golden."""
    data = _ending_inside(9)
    stream = golden.encode(data)
    words, m = _stream(stream), len(stream)
    cap, base = 11 * BLOCK_CHUNKS, base_blocks * BLOCK_CHUNKS
    jints, jn = jax.jit(
        lambda w, mm, b: jdk.decode(w, mm, cap, chunk_base=b)
    )(words, np.int32(m), np.int32(base))
    want = np.zeros(cap // BLOCK_CHUNKS * BLOCK_INTS, np.uint32)
    rest = golden.decode(stream)[base_blocks * BLOCK_INTS :]
    want[: len(rest)] = rest
    for fn in (dk.decode_plain, dk.decode):
        ints, n_ints = fn(_t(words), m, cap, chunk_base=base)
        assert int(n_ints) == int(jn)
        np.testing.assert_array_equal(_n(ints), np.asarray(jints))
        np.testing.assert_array_equal(_n(ints), want)


def test_decode_span_chunk_base_matches_pallas():
    """chunk_base decodes a block-aligned span of the stream (the unit one
    shard owns); n_ints stays the whole stream's."""
    from conftest import clustered_bitmap

    stream = golden.encode(clustered_bitmap(12 * BLOCK_INTS, seed=31))
    words, m, cap, base = _stream(stream), len(stream), 4 * BLOCK_CHUNKS, 5 * BLOCK_CHUNKS
    jints, jn = jax.jit(
        lambda w, mm, b: jdk.decode(w, mm, cap, chunk_base=b)
    )(words, np.int32(m), np.int32(base))
    ints, n_ints = dk.decode_plain(_t(words), m, cap, chunk_base=base)
    assert int(n_ints) == int(jn)
    np.testing.assert_array_equal(_n(ints), np.asarray(jints))


@pytest.mark.parametrize("base", [0, 4 * BLOCK_CHUNKS])
def test_encode_padded_shard_padding_matches_pallas(base):
    """A non-final shard (chunk_base below the global valid count) emits
    exactly one full zero fill per block and no word for padding."""
    nb = 4
    data = np.zeros(nb * BLOCK_INTS, dtype=np.uint32)
    nv_global = 8 * nb * BLOCK_CHUNKS
    jwords, jtotal = jax.jit(jek.encode_padded)(data, np.int32(nv_global), np.int32(base))
    for fn in (ek.encode_padded_plain, ek.encode_padded):
        words, total = fn(_t(data), nv_global, base)
        assert int(total) == int(jtotal) == nb
        np.testing.assert_array_equal(_n(words)[:nb], np.asarray(jwords)[:nb])


def test_wrappers_refuse_devices_without_a_kernel():
    """Only the CPU takes the plain version; a tensor on any other device
    that is not CUDA raises instead of silently falling back."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel"):
        ek.encode_tiles(torch.empty((8, BLOCK_INTS), dtype=torch.int32, device=meta),
                        torch.zeros(2, dtype=torch.int32, device=meta))
    with pytest.raises(ValueError, match="no kernel"):
        dk.prescan_words(torch.empty(1024, dtype=torch.int32, device=meta),
                         torch.empty(8, dtype=torch.int32, device=meta), 8)
    with pytest.raises(TypeError):
        ek.encode_tiles(torch.zeros((8, BLOCK_INTS), dtype=torch.int64),
                        torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        stitch2.stitch_tiles_v2(torch.zeros((2, 512), dtype=torch.int32),
                                torch.zeros(3, dtype=torch.int32))
