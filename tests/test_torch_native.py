"""The port's native host codec (wah_tpu_torch/csrc_host/wah_core.cpp via
wah_tpu_torch.native) against wah_tpu.native and the golden model, on the
cases of tests/test_native.py. Tolerance zero."""
import numpy as np
import pytest

from test_native import CASES
from wah_tpu import golden
from wah_tpu import native as jnative
from wah_tpu_torch import native
from wah_tpu_torch.constants import BLOCK_INTS

IDS = [c[0] for c in CASES]


@pytest.fixture(autouse=True)
def _toolchain():
    if not (native.available() and jnative.available()):
        pytest.skip("native toolchain unavailable")


@pytest.mark.parametrize("name,gen", CASES, ids=IDS)
def test_native_encode_matches_jax_native_and_golden(name, gen):
    data = gen()
    got = native.encode(data)
    np.testing.assert_array_equal(got, jnative.encode(data))
    np.testing.assert_array_equal(got, golden.encode(data))


@pytest.mark.parametrize("name,gen", CASES, ids=IDS)
def test_native_decode_matches_jax_native(name, gen):
    data = gen()
    stream = golden.encode(data)
    out = native.decode(stream, out_ints=len(data))
    np.testing.assert_array_equal(out, jnative.decode(stream, out_ints=len(data)))
    np.testing.assert_array_equal(out, data)
    np.testing.assert_array_equal(native.decode(stream), golden.decode(stream))
    assert native.decoded_chunks(stream) == jnative.decoded_chunks(stream)


def test_native_chunk_count():
    for n in (0, 1, 30, 31, 32, 992, 993, 12345):
        assert native.chunk_count(n) == jnative.chunk_count(n) == golden.chunk_count(n)


@pytest.mark.parametrize("word", [0x0, 0x7FFFFFFF, 0x80000000, 0x80000800])
def test_native_validate_rejects(word):
    bad = np.array([word], dtype=np.uint32)
    for mod in (native, jnative):
        with pytest.raises(ValueError):
            mod.validate(bad)


def test_native_validate_accepts_and_rejects_zero_fill_decode():
    g = np.random.default_rng(2)
    bits = g.random((BLOCK_INTS, 32)) < 0.1
    data = np.packbits(bits, axis=1, bitorder="little").view(np.uint32).reshape(-1)
    native.validate(golden.encode(data))
    with pytest.raises(ValueError):
        native.decode(np.array([0x80000000], dtype=np.uint32))


def test_native_library_is_built_inside_the_package_build_dir():
    native.encode(np.zeros(4, np.uint32))
    libs = list(native._BUILD_DIR.glob("libwah_core-*.so"))
    assert libs and native._BUILD_DIR.name == "_build"
