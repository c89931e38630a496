"""K5's port on the CPU (its plain version) against the Pallas fused kernel.

The same numpy inputs (the case matrix of test_pallas.py) go through
wah_tpu.ops.pallas.encode_kernel.encode_padded_fused, run as test_pallas.py
runs it (jit, interpret mode on the CPU), and through
wah_tpu_torch.ops.cuda.encode_kernel.encode_padded_fused on CPU tensors:
words up to the total, the total, and the per-block counts. Tolerance is
zero: an integer codec must agree bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from test_pallas import CASES
from wah_tpu import golden
from wah_tpu.constants import BLOCK_CHUNKS, BLOCK_INTS
from wah_tpu.ops.pallas import encode_kernel as jek
from wah_tpu_torch.convert import tensor_to_words, words_to_tensor
from wah_tpu_torch.ops.cuda import encode_kernel as ek

IDS = [c[0] for c in CASES]
NB = 16  # blocks of every case (a multiple of the CPU TILE_BLOCKS, 8): one compile


def _padded(data: np.ndarray):
    padded = np.zeros(NB * BLOCK_INTS, dtype=np.uint32)
    padded[: len(data)] = data
    return padded, golden.chunk_count(len(data))


@pytest.mark.parametrize("name,gen", CASES, ids=IDS)
def test_fused_matches_pallas_and_golden(name, gen):
    data = gen()
    padded, nv = _padded(data)
    jwords, jtotal = jax.jit(jek.encode_padded_fused)(padded, np.int32(nv))
    before = ek.encode_fused.launches
    words, total = ek.encode_padded_fused(words_to_tensor(padded, "cpu"), nv)
    assert ek.encode_fused.launches == before  # a CPU tensor launches nothing
    assert total.dtype == torch.int32 and total.dim() == 0
    assert int(total) == int(jtotal)
    got = tensor_to_words(words[: int(total)])
    np.testing.assert_array_equal(got, np.asarray(jwords)[: int(jtotal)])
    np.testing.assert_array_equal(got, golden.encode(data))


@pytest.mark.parametrize("name,gen", CASES, ids=IDS)
def test_fused_counts_match_pallas(name, gen):
    padded, nv = _padded(gen())
    nv_arr = np.array([nv, 0], np.int32)
    _, jcounts = jax.jit(jek.encode_fused)(padded.reshape(NB, BLOCK_INTS), nv_arr)
    ints2d = words_to_tensor(padded, "cpu").view(NB, BLOCK_INTS)
    words, counts = ek.encode_fused(ints2d, torch.from_numpy(nv_arr))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert words.shape == (NB * BLOCK_CHUNKS,) and counts.shape == (NB, 1)
    # the fused path equals the two-kernel pipeline's plain twin
    w2, t2 = ek.encode_padded_plain(ints2d.view(-1), nv, stitch="v3")
    assert int(t2) == int(counts.sum())
    assert torch.equal(words[: int(t2)], w2[: int(t2)])


def test_fused_shard_padding_emits_no_spurious_words():
    """Twin of test_pallas.py's regression for the fused path: on a non-final
    shard the padding rows lie below the GLOBAL bound; the clamp to the
    call's own blocks keeps them from emitting BIT31|1024 words."""
    nb = 4
    data = np.zeros(nb * BLOCK_INTS, dtype=np.uint32)
    nv_global = 8 * nb * BLOCK_CHUNKS  # simulates 8 shards
    for base in (0, nb * BLOCK_CHUNKS):
        jwords, jtotal = jax.jit(jek.encode_padded_fused)(data, np.int32(nv_global), np.int32(base))
        words, total = ek.encode_padded_fused(words_to_tensor(data, "cpu"), nv_global, base)
        assert int(total) == int(jtotal) == nb, base
        want = np.full(nb, 0x80000000 | 1024, np.uint32)
        np.testing.assert_array_equal(tensor_to_words(words[:nb]), want)
        np.testing.assert_array_equal(np.asarray(jwords)[:nb], want)


@pytest.mark.parametrize("base_blocks", [0, 3])
def test_fused_chunk_base_with_a_bound_inside_the_call(base_blocks):
    """A non-zero chunk_base and a bound that ends inside the call's blocks."""
    rng = np.random.default_rng(23)
    data = rng.integers(0, 2**32, size=8 * BLOCK_INTS, dtype=np.uint64).astype(np.uint32)
    base = base_blocks * BLOCK_CHUNKS
    bound = base + 5 * BLOCK_CHUNKS + 100
    jwords, jtotal = jax.jit(jek.encode_padded_fused)(data, np.int32(bound), np.int32(base))
    words, total = ek.encode_padded_fused(words_to_tensor(data, "cpu"), bound, base)
    assert int(total) == int(jtotal)
    np.testing.assert_array_equal(tensor_to_words(words[: int(total)]), np.asarray(jwords)[: int(jtotal)])


def test_fused_rejects_bad_arguments():
    ints = torch.zeros(BLOCK_INTS + 1, dtype=torch.int32)
    with pytest.raises(ValueError):
        ek.encode_padded_fused(ints, 10)
    with pytest.raises(ValueError):  # K5 takes no position mask
        ek.encode_fused(torch.zeros((1, BLOCK_INTS), dtype=torch.int32), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        ek.encode_fused(torch.zeros((1, BLOCK_INTS), dtype=torch.int64), torch.zeros(2, dtype=torch.int32))
    ek.check_fused_error()  # no launch yet, or a clean one: does not raise
