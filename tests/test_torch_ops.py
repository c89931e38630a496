"""The torch port's plain ops and oracle against the JAX package.

The same numpy inputs (the case matrix of test_pallas.py) go through
wah_tpu.golden / wah_tpu.ops (the XLA path) and their counterparts in
wah_tpu_torch: golden, ops.bits, ops.encode, ops.decode. Tolerance is
zero: an integer codec must agree bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from test_pallas import CASES
from wah_tpu import golden as jgolden
from wah_tpu.constants import BLOCK_CHUNKS, BLOCK_INTS
from wah_tpu.ops import bits as jbits
from wah_tpu.ops import decode as jdecode
from wah_tpu.ops import encode as jencode
from wah_tpu_torch import golden as tgolden
from wah_tpu_torch.convert import tensor_to_words, to_i32, words_to_tensor
from wah_tpu_torch.ops import bits as tbits
from wah_tpu_torch.ops import decode as tdecode
from wah_tpu_torch.ops import encode as tencode
from wah_tpu_torch.utils.timing import PhaseTimer

IDS = [c[0] for c in CASES]


def _t(x: np.ndarray) -> torch.Tensor:
    return words_to_tensor(np.asarray(x, dtype=np.uint32), "cpu")


def _n(t: torch.Tensor) -> np.ndarray:
    return tensor_to_words(t)


NB = 16  # every case is padded to NB blocks, so each JAX function compiles once


def _padded(data: np.ndarray):
    """data zero-padded to NB blocks, its valid chunk count and NB."""
    padded = np.zeros(NB * BLOCK_INTS, dtype=np.uint32)
    padded[: len(data)] = data
    return padded, jgolden.chunk_count(len(data)), NB


@pytest.mark.parametrize("name,gen", CASES, ids=IDS)
def test_golden_copy_matches_jax_golden(name, gen):
    data = gen()
    stream = jgolden.encode(data)
    np.testing.assert_array_equal(tgolden.encode(data), stream)
    np.testing.assert_array_equal(tgolden.decode(stream), jgolden.decode(stream))
    np.testing.assert_array_equal(
        tgolden.decode(stream, out_ints=len(data)), data
    )
    assert tgolden.chunk_count(len(data)) == jgolden.chunk_count(len(data))


def test_golden_copy_empty_and_constants():
    from wah_tpu import constants as jc
    from wah_tpu_torch import constants as tc

    empty = np.zeros(0, np.uint32)
    assert tgolden.encode(empty).size == jgolden.encode(empty).size == 0
    names = [k for k in vars(jc) if k.isupper()]
    assert names and all(getattr(tc, k) == getattr(jc, k) for k in names)


@pytest.mark.parametrize("name,gen", CASES, ids=IDS)
def test_bits_match_jax(name, gen):
    padded, _, nb = _padded(gen())
    want = np.asarray(jax.jit(jbits.repartition_chunks)(padded))
    chunks = tbits.repartition_chunks(_t(padded))
    np.testing.assert_array_equal(_n(chunks), want)
    np.testing.assert_array_equal(
        _n(tbits.merge_chunks(chunks)), np.asarray(jax.jit(jbits.merge_chunks)(want))
    )
    # a carry chunk after the array feeds the last int of the last group
    carry = np.uint32(0x5A5A5A5A & 0x7FFFFFFF)
    np.testing.assert_array_equal(
        _n(tbits.merge_chunks(chunks.view(nb, -1), carry=int(carry))),
        np.asarray(jbits.merge_chunks(want.reshape(nb, -1), carry=carry)),
    )


@pytest.mark.parametrize("name,gen", CASES, ids=IDS)
def test_encode_ops_match_jax(name, gen):
    data = gen()
    padded, nv, nb = _padded(data)
    jchunks = np.asarray(jbits.repartition_chunks(padded)).reshape(nb, BLOCK_CHUNKS)
    chunks = _t(jchunks.reshape(-1)).view(nb, BLOCK_CHUNKS)

    np.testing.assert_array_equal(
        tencode.classify(chunks).numpy(), np.asarray(jencode.classify(jchunks))
    )
    staging, counts = tencode.encode_blocks(chunks, nv)
    jstaging, jcounts = jax.jit(jencode.encode_blocks)(jchunks, np.int32(nv))
    np.testing.assert_array_equal(_n(staging), np.asarray(jstaging))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))

    words, total = tencode.stitch(staging, counts)
    jwords, jtotal = jax.jit(jencode.stitch)(jstaging, jcounts)
    assert int(total) == int(jtotal)
    np.testing.assert_array_equal(_n(words), np.asarray(jwords))  # both zero the tail

    words, total = tencode.encode_padded(_t(padded), nv)
    np.testing.assert_array_equal(_n(words[: int(total)]), jgolden.encode(data))


@pytest.mark.parametrize("base", [0, 3 * BLOCK_CHUNKS])
def test_encode_blocks_chunk_base_matches_jax(base):
    """Validity is judged at the global position chunk_base + local: a
    shard whose range crosses the valid end emits words only below it."""
    from conftest import random_bitmap

    data = random_bitmap(NB * BLOCK_INTS, 1 / 8, seed=21)
    jchunks = np.asarray(jbits.repartition_chunks(data)).reshape(NB, BLOCK_CHUNKS)
    nv = 9 * BLOCK_CHUNKS + 77
    staging, counts = tencode.encode_blocks(_t(jchunks.reshape(-1)).view(NB, -1), nv, base)
    jstaging, jcounts = jax.jit(jencode.encode_blocks)(jchunks, np.int32(nv), np.int32(base))
    np.testing.assert_array_equal(_n(staging), np.asarray(jstaging))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


@pytest.mark.parametrize("name,gen", CASES, ids=IDS)
def test_decode_ops_match_jax(name, gen):
    data = gen()
    stream = jgolden.encode(data)
    m = len(stream)
    cap = NB * BLOCK_CHUNKS
    padded = np.zeros(cap, dtype=np.uint32)  # a stream never outgrows its chunks
    padded[:m] = stream
    words = _t(padded)

    np.testing.assert_array_equal(
        tdecode.word_counts(words, m).numpy(),
        np.asarray(jdecode.word_counts(padded, np.int32(m))),
    )
    span = jax.jit(jdecode.decode_span, static_argnums=(3,))
    n_chunks_all = int(tdecode.word_counts(words, m).sum())
    for base in (0, n_chunks_all // 2 // 32 * 32, max(n_chunks_all - BLOCK_CHUNKS // 2, 0)):
        chunks, n_chunks = tdecode.decode_span(words, m, base, BLOCK_CHUNKS)
        jchunks, jn = span(padded, np.int32(m), np.int32(base), BLOCK_CHUNKS)
        np.testing.assert_array_equal(_n(chunks), np.asarray(jchunks), err_msg=str(base))
        assert int(n_chunks) == int(jn)
    ints, n_ints = tdecode.decode(words, m, cap)
    jints, jn_ints = jax.jit(jdecode.decode, static_argnums=(2,))(padded, np.int32(m), cap)
    assert int(n_ints) == int(jn_ints)
    np.testing.assert_array_equal(_n(ints), np.asarray(jints))
    np.testing.assert_array_equal(_n(ints)[: len(data)], data)


def test_convert_round_trip_and_wrap():
    w = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xC0000400, 0xFFFFFFFF], np.uint32)
    t = words_to_tensor(w, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(tensor_to_words(t), w)
    wide = torch.tensor([0xFFFFFFFF, 0x80000000, 1 << 32 | 5, -1], dtype=torch.int64)
    np.testing.assert_array_equal(
        tensor_to_words(to_i32(wide)),
        np.array([0xFFFFFFFF, 0x80000000, 5, 0xFFFFFFFF], np.uint32),
    )
    with pytest.raises(TypeError):
        tensor_to_words(wide)


def test_phase_timer_wall_clock_on_cpu():
    t = PhaseTimer(torch.device("cpu"))
    t.start()
    ms = t.stop("kernel")
    assert ms >= 0 and t.timings.kernel_ms == ms
    assert t.timings.as_tuple() == (0.0, ms, 0.0)
