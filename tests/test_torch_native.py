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


# -- api.checked_stream / stream_chunks take the native path when the
# host codec is built (as wah_tpu.api.checked_stream does), numpy otherwise;
# both give the same answers and the same messages

def _numpy_only(monkeypatch):
    """native.available() False, and the native calls fail if reached."""
    def reached(*_):
        raise AssertionError("the native path was taken")

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "validate", reached)
    monkeypatch.setattr(native, "decoded_chunks", reached)


CORRUPT = {
    "zero_word": [0x80000001, 0x5, 0x0, 0x7],
    "ones_literal": [0x5, 0x7FFFFFFF],
    "zero_length_fill": [0x5, 0x80000000, 0x80000001],
    "fill_length_1025": [0xC0000000 | 1025, 0x5],
}


@pytest.mark.parametrize("words", CORRUPT.values(), ids=CORRUPT.keys())
def test_checked_stream_messages_equal_on_both_paths(monkeypatch, words):
    from wah_tpu import api as japi
    from wah_tpu_torch import api

    words = np.array(words, dtype=np.uint32)
    msgs = []
    for check in (native.validate, api.validate_stream, api.checked_stream, japi.checked_stream):
        with pytest.raises(ValueError) as err:
            check(words)
        msgs.append(str(err.value))
    _numpy_only(monkeypatch)
    with pytest.raises(ValueError) as err:
        api.checked_stream(words)
    msgs.append(str(err.value))
    assert len(set(msgs)) == 1, msgs


@pytest.mark.parametrize("name,gen", CASES, ids=IDS)
def test_stream_chunks_equal_on_both_paths(monkeypatch, name, gen):
    from wah_tpu_torch import api

    data = gen()
    stream = golden.encode(data)
    want = golden.chunk_count(len(data)) if len(data) else 0
    got = api.stream_chunks(stream)
    _numpy_only(monkeypatch)
    assert got == api.stream_chunks(stream) == want


def test_the_native_path_is_taken_when_built(monkeypatch, tmp_path, capsys):
    from wah_tpu_torch import WahCodec, api
    from wah_tpu_torch import __main__ as cli

    def reached(*_):
        raise AssertionError("the numpy check was taken")

    monkeypatch.setattr(api, "validate_stream", reached)
    data = (np.arange(3 * BLOCK_INTS) % 7 == 0).astype(np.uint32)
    stream, _ = WahCodec("cpu").compress(data)
    back, _ = WahCodec("cpu").decompress(stream, out_ints=len(data))
    np.testing.assert_array_equal(back, data)
    src = tmp_path / "d.bin"
    src.write_bytes(data.astype("<u4").tobytes())
    cli.main(["compress", str(src), "--device", "cpu"])
    capsys.readouterr()
    cli.main(["info", str(src) + ".wah"])
    assert f"{len(stream)} words, {native.decoded_chunks(stream)} chunks" in capsys.readouterr().out


def test_the_numpy_path_without_the_host_codec(monkeypatch, tmp_path, capsys):
    from wah_tpu import __main__ as jcli
    from wah_tpu_torch import WahCodec
    from wah_tpu_torch import __main__ as cli
    from wah_tpu_torch.parallel import ShardedCodec

    data = (np.random.default_rng(4).random(5 * BLOCK_INTS + 11) < 0.2).astype(np.uint32)
    stream = golden.encode(data)
    src = tmp_path / "d.bin"
    src.write_bytes(data.astype("<u4").tobytes())
    cli.main(["compress", str(src), "--device", "cpu"])
    jcli.main(["info", str(src) + ".wah"])
    want_info = capsys.readouterr().out.splitlines()[-1]
    _numpy_only(monkeypatch)
    for codec in (WahCodec("cpu"), ShardedCodec("cpu")):
        back = codec.decompress(stream, out_ints=len(data))
        np.testing.assert_array_equal(back[0] if isinstance(back, tuple) else back, data)
        with pytest.raises(ValueError, match="literal-fill"):
            codec.decompress(np.array([0x5, 0x0], dtype=np.uint32))
    cli.main(["info", str(src) + ".wah"])
    assert capsys.readouterr().out.splitlines()[-1] == want_info
