"""On-card tests of the CUDA kernels K1-K4 (marker `cuda`).

Each kernel against its plain torch version on the same CUDA tensors, and
WahCodec("cuda") against the golden model, on small edge cases that
chip_smoke.py does not reach: partial and shard-offset validity, the
long-fill and granule-window-extreme streams, a decoded span. Tolerance
is zero (an integer codec). They skip without a CUDA device. The card's
machine has no JAX, so run them there without the JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from wah_tpu_torch import WahCodec, golden
from wah_tpu_torch.constants import BLOCK_CHUNKS, BLOCK_INTS
from wah_tpu_torch.convert import tensor_to_words, words_to_tensor
from wah_tpu_torch.ops.cuda import decode_kernel as dk
from wah_tpu_torch.ops.cuda import encode_kernel as ek
from wah_tpu_torch.ops.cuda import stitch2

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
