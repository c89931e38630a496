"""Compressed-domain logical ops: the port against wah_tpu and the numpy
oracle (mirrors tests/test_logical.py).

The same numpy bitmaps and streams go through wah_tpu.WahCodec(kernel=
"xla") and wah_tpu_torch.WahCodec("cpu"), and through both packages'
complement_stream and identity streams. Tolerance is zero: the result
streams agree word for word with each other and with golden.encode of
the numpy result.
"""
import numpy as np
import pytest
import torch

import wah_tpu
import wah_tpu_torch
from conftest import clustered_bitmap, random_bitmap
from wah_tpu import golden
from wah_tpu.constants import BLOCK_INTS
from wah_tpu.ops import logical as jlops
from wah_tpu_torch.convert import tensor_to_words, words_to_tensor
from wah_tpu_torch.ops import logical as tlops

NP_OPS = {
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b,
    "andnot": lambda a, b: a & ~b,
}
FOLDS = {"or": np.bitwise_or, "and": np.bitwise_and, "xor": np.bitwise_xor}


@pytest.fixture(scope="module")
def codecs():
    return wah_tpu.WahCodec(kernel="xla"), wah_tpu_torch.WahCodec("cpu")


def test_ops_match_jax():
    assert sorted(tlops.OPS) == sorted(jlops.OPS)


@pytest.mark.parametrize("op", sorted(NP_OPS))
def test_logical_matches_jax_and_oracle(codecs, op):
    jcodec, tcodec = codecs
    n = 3 * BLOCK_INTS + 111
    a = random_bitmap(n, 0.05, seed=1)
    b = clustered_bitmap(n, seed=2)
    sa, sb = golden.encode(a), golden.encode(b)
    got = tcodec.logical(sa, sb, op, n)
    np.testing.assert_array_equal(got, jcodec.logical(sa, sb, op, n))
    np.testing.assert_array_equal(got, golden.encode(NP_OPS[op](a, b)))


def test_logical_extreme_operands(codecs):
    _, tcodec = codecs
    n = 2 * BLOCK_INTS
    sz = golden.encode(np.zeros(n, np.uint32))
    so = golden.encode(np.full(n, 0xFFFFFFFF, np.uint32))
    np.testing.assert_array_equal(tcodec.logical(sz, so, "and", n), sz)
    np.testing.assert_array_equal(tcodec.logical(sz, so, "or", n), so)
    np.testing.assert_array_equal(tcodec.logical(so, so, "xor", n), sz)
    np.testing.assert_array_equal(tcodec.logical(so, sz, "andnot", n), so)


def test_logical_sparse_result_takes_the_gather_stitch(codecs):
    """AND of two 2^-8 columns is ~2^-16, a result that wah_tpu's "auto"
    stitch sends to its gather stitch; the port stitches every result with
    K2 (on the CPU its plain version), and the stream still equals
    wah_tpu's."""
    jcodec, tcodec = codecs
    n = 8 * BLOCK_INTS
    rng = np.random.default_rng(1337)
    a, b = (np.bitwise_and.reduce(rng.integers(0, 2**32, size=(8, n), dtype=np.uint64)
                                  .astype(np.uint32)) for _ in range(2))
    sa, sb = golden.encode(a), golden.encode(b)
    got = tcodec.logical(sa, sb, "and", n)
    assert len(got) * 8 <= 8 * 1024 * 3  # a result wah_tpu's gather stitch takes
    np.testing.assert_array_equal(got, jcodec.logical(sa, sb, "and", n))
    np.testing.assert_array_equal(got, golden.encode(a & b))


def test_logical_composition(codecs):
    """(A and B) or (A xor B) == A or B, computed fully compressed."""
    _, tcodec = codecs
    n = BLOCK_INTS + 77
    a = random_bitmap(n, 0.3, seed=4)
    b = random_bitmap(n, 0.3, seed=5)
    sa, sb = golden.encode(a), golden.encode(b)
    t1 = tcodec.logical(sa, sb, "and", n)
    t2 = tcodec.logical(sa, sb, "xor", n)
    np.testing.assert_array_equal(tcodec.logical(t1, t2, "or", n), golden.encode(a | b))


@pytest.mark.parametrize("m_short", [0, 5])
def test_complement_stream_matches_jax(m_short):
    """Every word kind flips as in wah_tpu; words past m stay as they are."""
    s = golden.encode(clustered_bitmap(4 * BLOCK_INTS, seed=7))
    m = len(s) - m_short
    want = np.asarray(jlops.complement_stream(s, m))
    got = tensor_to_words(tlops.complement_stream(words_to_tensor(s, "cpu"), m))
    np.testing.assert_array_equal(got, want)


def test_complement_stream_roundtrip():
    n = 2 * BLOCK_INTS  # whole blocks: no padding bits to mask
    a = random_bitmap(n, 0.2, seed=3)
    s = golden.encode(a)
    sc = tensor_to_words(tlops.complement_stream(words_to_tensor(s, "cpu"), len(s)))
    np.testing.assert_array_equal(golden.decode(sc, out_ints=n), ~a)


@pytest.mark.parametrize("op", ["and", "or", "xor"])
def test_identity_words_match_jax(op):
    nv, M = golden.chunk_count(3 * BLOCK_INTS + 40), 4096
    jw, jm = jlops._identity_words(op, nv, M)
    tw, tm = tlops._identity_words(op, nv, M, "cpu")
    assert tm == jm
    np.testing.assert_array_equal(tensor_to_words(tw), np.asarray(jw))


def _fold_inputs(k: int):
    n = 2 * BLOCK_INTS + 100
    cols = [random_bitmap(n, d, seed=80 + i)
            for i, d in zip(range(k), [0.02, 0.6, 0.0, 1.0, 1 / 32] * 4)]
    return n, cols, [golden.encode(c) for c in cols]


@pytest.mark.parametrize("op", sorted(FOLDS))
@pytest.mark.parametrize("k", [2, 3, 5, 16])
def test_logical_many_matches_pairwise(codecs, k, op):
    """One batched decode + tree fold + one encode equals the pairwise fold
    and the numpy fold; k = 3, 5 pad with identity streams."""
    _, tcodec = codecs
    n, cols, streams = _fold_inputs(k)
    got = tcodec.logical_many(streams, op, n)
    np.testing.assert_array_equal(got, golden.encode(FOLDS[op].reduce(cols)))
    pairwise = streams[0]
    for s in streams[1:]:
        pairwise = tcodec.logical(pairwise, s, op, n)
    np.testing.assert_array_equal(got, pairwise)


@pytest.mark.parametrize("op", sorted(FOLDS))
def test_logical_many_matches_jax(codecs, op):
    """k = 5: the identity-stream padding to a fan-in of 8, as in wah_tpu."""
    jcodec, tcodec = codecs
    n, _, streams = _fold_inputs(5)
    np.testing.assert_array_equal(tcodec.logical_many(streams, op, n),
                                  jcodec.logical_many(streams, op, n))


def test_logical_many_edge_cases(codecs):
    _, tcodec = codecs
    s = golden.encode(random_bitmap(BLOCK_INTS, 0.1, seed=9))
    one = tcodec.logical_many([s], "or", BLOCK_INTS)
    np.testing.assert_array_equal(one, s)
    assert one is not s
    with pytest.raises(ValueError, match="fold op"):
        tcodec.logical_many([s, s], "andnot", BLOCK_INTS)
    with pytest.raises(ValueError, match="empty"):
        tcodec.logical_many([], "or", BLOCK_INTS)


def test_logical_reduce_2d_matches_flat():
    n = BLOCK_INTS + 3
    streams = [golden.encode(random_bitmap(n, 0.1, seed=90 + i)) for i in range(3)]
    w2 = np.zeros((3, 2048), np.uint32)
    for i, s in enumerate(streams):
        w2[i, : len(s)] = s
    ms = torch.tensor([len(s) for s in streams], dtype=torch.int32)
    words, total = tlops.logical_reduce(words_to_tensor(w2.reshape(-1), "cpu").view(3, -1), ms,
                                        "xor", n)
    want = golden.encode(np.bitwise_xor.reduce([golden.decode(s, n) for s in streams]))
    np.testing.assert_array_equal(tensor_to_words(words[: int(total)]), want)
