"""The port's rechunk_stream against wah_tpu.interop's, on the cases of
tests/test_interop.py: the same foreign streams go through both; the
results are equal, equal to the golden encode, and the port's decompress
accepts them. Tolerance zero."""
import numpy as np
import pytest

from test_interop import _bernoulli, foreign_encode
from wah_tpu import golden
from wah_tpu.constants import BIT30, BIT31, BIT3130, ONES31
from wah_tpu.interop import rechunk_stream as jax_rechunk
from wah_tpu_torch import decompress, rechunk_stream, validate_stream
from wah_tpu_torch.interop import rechunk_stream as port_rechunk

U = np.uint32


@pytest.mark.parametrize("p", [0.0, 1e-4, 0.01, 0.5, 1.0])
@pytest.mark.parametrize("fragment", [False, True])
def test_rechunk_matches_jax_and_canonical(p, fragment):
    n = 5 * 992 + 317  # crosses block seams, non-block-multiple tail
    bitmap = _bernoulli(n, p, seed=7)
    rng = np.random.default_rng(11) if fragment else None
    foreign = foreign_encode(bitmap, rng)
    got = port_rechunk(foreign)
    np.testing.assert_array_equal(got, jax_rechunk(foreign))
    np.testing.assert_array_equal(got, golden.encode(bitmap))
    validate_stream(got)


HAND = {
    "long_fill_at_zero": [BIT31 | 5000, 0x1234],
    "unaligned_long_fill": [0x5555, BIT3130 | 3600],
    "degenerate_literals_merge": [BIT31 | 3, 0, BIT31 | 2, ONES31, ONES31],
    "max_length_fill": [BIT31 | BIT30 | 0x3FFFFFFF >> 8],
    "empty": [],
}


@pytest.mark.parametrize("name", HAND)
def test_rechunk_hand_streams_match_jax(name):
    foreign = np.array(HAND[name], dtype=U)
    got = port_rechunk(foreign)
    want = jax_rechunk(foreign)
    assert got.dtype == U
    np.testing.assert_array_equal(got, want)


def test_zero_length_fill_rejected():
    with pytest.raises(ValueError, match="zero-length fill"):
        port_rechunk(np.array([0x42, BIT31], dtype=U))


def test_exported_and_decompress_accepts_rechunked_foreign():
    assert rechunk_stream is port_rechunk
    n = 3 * 992
    bitmap = _bernoulli(n, 0.003, seed=3)
    foreign = foreign_encode(bitmap, np.random.default_rng(5))
    with pytest.raises(ValueError):
        decompress(foreign, n, "cpu")  # the foreign stream is rejected as it is
    out, _ = decompress(rechunk_stream(foreign), n, "cpu")
    np.testing.assert_array_equal(out, bitmap)
