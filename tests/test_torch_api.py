"""The whole slice: wah_tpu_torch.WahCodec(device="cpu") against
wah_tpu.WahCodec(kernel="pallas") and wah_tpu.golden, plus the port's
import guards (no JAX, no wah_tpu, no nvcc or GPU needed to import).

The same numpy inputs (the case matrix of test_pallas.py) go through
both codecs. Tolerance is zero: streams, their lengths and the decoded
bitmaps must agree bit for bit.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import wah_tpu
import wah_tpu_torch
from test_pallas import CASES
from wah_tpu import golden

ROOT = Path(__file__).resolve().parents[1]
IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def codecs():
    return wah_tpu.WahCodec(kernel="pallas"), wah_tpu_torch.WahCodec(device="cpu")


@pytest.mark.parametrize("name,gen", CASES, ids=IDS)
def test_codec_matches_jax_codec_and_golden(codecs, name, gen):
    jcodec, tcodec = codecs
    data = gen()
    want = golden.encode(data)
    jstream, _ = jcodec.compress(data)
    stream, timings = tcodec.compress(data)
    assert stream.dtype == np.uint32 and len(timings.as_tuple()) == 3
    np.testing.assert_array_equal(jstream, want)
    np.testing.assert_array_equal(stream, want)

    jout, _ = jcodec.decompress(want, out_ints=len(data))
    out, _ = tcodec.decompress(want, out_ints=len(data))
    np.testing.assert_array_equal(jout, data)
    np.testing.assert_array_equal(out, data)
    # untrimmed: ceil(31 * n_chunks / 32) ints, as the reference decoder
    jfull, _ = jcodec.decompress(want)
    full, _ = tcodec.decompress(want)
    np.testing.assert_array_equal(full, jfull)
    np.testing.assert_array_equal(full, golden.decode(want))


def test_module_level_functions_and_empty_input():
    data = np.array([0x1, 0, 0, 0xFFFFFFFF], dtype=np.uint32)
    stream, _ = wah_tpu_torch.compress(data, "cpu")
    np.testing.assert_array_equal(stream, golden.encode(data))
    out, _ = wah_tpu_torch.decompress(stream, len(data), "cpu")
    np.testing.assert_array_equal(out, data)
    empty = np.zeros(0, np.uint32)
    s, t = wah_tpu_torch.compress(empty, "cpu")
    o, _ = wah_tpu_torch.decompress(empty, None, "cpu")
    assert s.size == 0 and o.size == 0 and t.as_tuple() == (0.0, 0.0, 0.0)


BAD_STREAMS = {
    "zero_word": [0x80000001, 0x0],
    "ones_literal": [0x7FFFFFFF],
    "zero_length_fill": [0x80000000],
    "fill_too_long": [0xC0000000 | 1025],
}


@pytest.mark.parametrize("words", BAD_STREAMS.values(), ids=BAD_STREAMS.keys())
def test_invalid_streams_rejected_like_jax(words):
    words = np.array(words, dtype=np.uint32)
    with pytest.raises(ValueError) as jerr:
        wah_tpu.validate_stream(words)
    with pytest.raises(ValueError) as terr:
        wah_tpu_torch.WahCodec("cpu").decompress(words)
    assert str(terr.value) == str(jerr.value)


def test_size_cap_matches_jax():
    from wah_tpu import api as japi
    from wah_tpu_torch import api as tapi

    assert tapi.MAX_INTS_PER_BITMAP == japi.MAX_INTS_PER_BITMAP
    tapi._check_size(tapi.MAX_INTS_PER_BITMAP)
    with pytest.raises(ValueError, match="int32 position limit"):
        tapi._check_size(tapi.MAX_INTS_PER_BITMAP + 1)


def _run(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, **env}, timeout=120,
    )


def test_import_leaves_jax_out():
    res = _run("import sys, wah_tpu_torch; assert 'jax' not in sys.modules")
    assert res.returncode == 0, res.stderr


def test_kernel_wrappers_import_without_nvcc_or_gpu(tmp_path):
    """Importing every kernel wrapper builds and loads nothing: no nvcc on
    PATH, no CUDA_HOME, no visible GPU."""
    code = (
        "import sys\n"
        "from wah_tpu_torch.ops.cuda import _build, decode_kernel, encode_kernel, stitch2\n"
        "assert _build.load.cache_info().currsize == 0\n"
        "assert 'jax' not in sys.modules and 'wah_tpu.api' not in sys.modules\n"
    )
    res = _run(code, PATH=str(tmp_path), CUDA_HOME=str(tmp_path), CUDA_VISIBLE_DEVICES="")
    assert res.returncode == 0, res.stderr


def test_port_never_imports_jax_or_wah_tpu():
    """No module of the port, nor chip_smoke.py, imports jax or wah_tpu."""
    files = sorted((ROOT / "wah_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "wah_tpu"), f"{path}: imports {name}"


def _c_entries():
    """C entry -> its parameters' types, as declared in wah_tpu_torch/csrc/*.cu."""
    import re

    entries = {}
    for src in sorted((ROOT / "wah_tpu_torch" / "csrc").glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (wah_\w+)\(([^)]*)\)', src.read_text()):
            entries[name] = [" ".join(p.split()[:-1]) for p in params.split(",")]
    return entries


@pytest.mark.parametrize("entry", sorted(_c_entries()))
def test_ctypes_signature_matches_the_c_entry(entry):
    """The kernels cannot be built here, so the argument lists that ctypes is
    given are held against the sources: pointers as void*, sizes as int (a
    stream's length as long long), the stream last."""
    import ctypes

    from wah_tpu_torch.ops.cuda import _build

    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
             "long long": ctypes.c_longlong}
    declared = _c_entries()
    assert sorted(declared) == sorted(_build._SIGNATURES)
    assert [kinds[p] for p in declared[entry]] == _build._SIGNATURES[entry]
    assert declared[entry][-1] == "void*"


# -- entry points: wah_tpu's signatures, on the card by default ------------

def _params(fn):
    import inspect

    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()
            if p.name not in ("self", "cls")]


_NO_DEVICE = object()


def _signature_pairs():
    import wah_tpu.index
    import wah_tpu.parallel
    import wah_tpu_torch.parallel

    J, T = wah_tpu, wah_tpu_torch
    jbi, tbi = wah_tpu.index.BitmapIndex, wah_tpu_torch.BitmapIndex
    # name: (wah_tpu's, the port's, the port's name for a wah_tpu
    # parameter, wah_tpu parameters not ported, the port's device default,
    # or _NO_DEVICE where it has no device parameter)
    return {
        "compress": (J.compress, T.compress, {}, (), "cuda"),
        "decompress": (J.decompress, T.decompress, {}, (), "cuda"),
        # kernel= picks XLA or Pallas on a TPU; the port has one kernel set
        "WahCodec": (J.WahCodec.__init__, T.WahCodec.__init__, {}, ("kernel",), "cuda"),
        "BitmapIndex": (jbi.__init__, tbi.__init__, {}, (), _NO_DEVICE),
        "BitmapIndex.build": (jbi.build, tbi.build, {}, (), _NO_DEVICE),
        # a process group takes the place of the device mesh
        "ShardedCodec": (wah_tpu.parallel.ShardedCodec.__init__,
                         wah_tpu_torch.parallel.ShardedCodec.__init__, {"mesh": "group"}, (),
                         None),
    }


@pytest.mark.parametrize("name", list(_signature_pairs()))
def test_entry_point_signatures_match_jax(name):
    jfn, tfn, renamed, dropped, device_default = _signature_pairs()[name]
    want = [(renamed.get(n, n), d) for n, d in _params(jfn) if n not in dropped]
    got = _params(tfn)
    if device_default is not _NO_DEVICE:  # the port's extra parameter
        assert ("device", device_default) in got
    assert [p for p in got if p[0] != "device"] == want


NO_CARD = 'pass device="cpu"'


def _no_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_wah_codec_defaults_to_the_card_and_never_falls_back(monkeypatch):
    from wah_tpu_torch.index import BitmapIndex

    _no_card(monkeypatch)
    x = np.arange(50, dtype=np.uint32)
    stream = golden.encode(x)
    calls = {
        "WahCodec()": lambda: wah_tpu_torch.WahCodec(),
        "compress(x)": lambda: wah_tpu_torch.compress(x),
        "decompress(w)": lambda: wah_tpu_torch.decompress(stream),
        "BitmapIndex.build(v)": lambda: BitmapIndex.build(np.arange(40) % 3),
        "BitmapIndex(streams, n)": lambda: BitmapIndex([stream], 40),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=NO_CARD):
            call()


def test_sharded_codec_defaults_to_the_ranks_card(monkeypatch):
    import wah_tpu_torch.parallel as tpar

    _no_card(monkeypatch)
    for call in (lambda: tpar.ShardedCodec(), lambda: tpar.ShardedCodec(group=None),
                 lambda: tpar.ShardedCodec("cuda:0")):
        with pytest.raises(RuntimeError, match=NO_CARD):
            call()
    assert str(tpar.ShardedCodec("cpu").device) == "cpu"


@pytest.mark.parametrize("name,gen", CASES, ids=IDS)
def test_module_level_codec_on_the_cpu_matches_jax(name, gen):
    data = gen()
    jstream, _ = wah_tpu.compress(data)
    stream, _ = wah_tpu_torch.compress(data, device="cpu")
    np.testing.assert_array_equal(stream, jstream)
    jout, _ = wah_tpu.decompress(jstream)  # no out_ints: the whole expansion
    out, _ = wah_tpu_torch.decompress(stream, device="cpu")
    np.testing.assert_array_equal(out, jout)
    trimmed, _ = wah_tpu_torch.decompress(stream, len(data), "cpu")
    np.testing.assert_array_equal(trimmed, data)


@pytest.mark.parametrize("name,gen", CASES, ids=IDS)
def test_plain_encode_and_decode_chunks_match_jax(name, gen):
    import jax
    import torch

    from wah_tpu.ops import decode as jdecode
    from wah_tpu.ops import encode as jencode
    from wah_tpu_torch.convert import tensor_to_words, words_to_tensor
    from wah_tpu_torch.ops import decode as tdecode
    from wah_tpu_torch.ops import encode as tencode

    data = gen()
    jwords, jtotal = jax.jit(jencode.encode)(data)
    words, total = tencode.encode(words_to_tensor(data, "cpu"))
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(tensor_to_words(words), np.asarray(jwords))
    assert int(total) == int(jtotal)

    m = int(total)
    cap = words.shape[0]
    jchunks, jn = jax.jit(jdecode.decode_chunks, static_argnums=2)(jwords, m, cap)
    chunks, n = tdecode.decode_chunks(words, m, cap)
    np.testing.assert_array_equal(tensor_to_words(chunks), np.asarray(jchunks))
    assert int(n) == int(jn) == golden.chunk_count(len(data))
